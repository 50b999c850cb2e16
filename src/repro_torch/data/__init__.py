from repro_torch.data.loader import ShardedLoader
from repro_torch.data.packing import pack_sequences
from repro_torch.data.synthetic import audio_labels, make_batch_fn, synthetic_batch

__all__ = ["audio_labels", "make_batch_fn", "synthetic_batch", "ShardedLoader", "pack_sequences"]
