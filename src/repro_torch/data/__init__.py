from repro_torch.data.synthetic import make_batch_fn, synthetic_batch

__all__ = ["make_batch_fn", "synthetic_batch"]
