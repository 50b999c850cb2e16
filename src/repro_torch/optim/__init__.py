from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import make_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm", "make_schedule"]
