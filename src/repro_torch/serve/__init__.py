"""Serving tier: batched inner-loop adaptation, an adapted-state cache with
low-rank deltas, and decode.  See ``launch/serve.py`` for the CLI."""
from repro_torch.serve.cache import (AdaptedStateCache, TaskKey,
                                     source_fingerprint, task_key)
from repro_torch.serve.engine import AdaptRequest, ServeEngine
from repro_torch.serve.lowrank import (CompressedDelta, DenseLeaf,
                                       LowRankLeaf, apply_delta,
                                       compress_delta)

__all__ = [
    "AdaptRequest", "AdaptedStateCache", "CompressedDelta", "DenseLeaf",
    "LowRankLeaf", "ServeEngine", "TaskKey", "apply_delta",
    "compress_delta", "source_fingerprint", "task_key",
]
