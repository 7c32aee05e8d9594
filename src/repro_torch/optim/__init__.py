"""Optimizers over flat param dicts (the paper's outer loop uses Adam and
SGD)."""
from repro_torch.optim.optimizers import (AdamState, FusedSpec,
                                          MomentumState, Optimizer, adam,
                                          adamw, clip_by_global_norm,
                                          get_optimizer, global_norm_scale,
                                          momentum, sgd)

__all__ = ["AdamState", "FusedSpec", "MomentumState", "Optimizer", "adam",
           "adamw", "clip_by_global_norm", "get_optimizer",
           "global_norm_scale", "momentum", "sgd"]
