from repro_torch.optim.optimizers import (OptState, adamw, clip_by_global_norm,
                                          momentum_sgd, sgd)
from repro_torch.optim.schedules import constant, cosine, wsd_schedule

__all__ = ["OptState", "adamw", "clip_by_global_norm", "constant", "cosine",
           "momentum_sgd", "sgd", "wsd_schedule"]
