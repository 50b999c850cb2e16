from repro_torch.train.step import TrainState, cross_entropy, init_train_state, loss_fn, make_train_step

__all__ = ["TrainState", "cross_entropy", "init_train_state", "loss_fn", "make_train_step"]
