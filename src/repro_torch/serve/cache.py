"""Adapted-state cache: the recurring-user fast path (port of
``repro/serve/cache.py``).

Recurring tasks re-adapt the launch model to the *same* solution, so
adaptation is memoizable: key on the task signature — source fingerprint ×
domain × adapt hyperparameters — and a repeat request becomes a delta
reconstruction (:func:`~repro_torch.serve.lowrank.apply_delta`) instead of
an inner-loop re-adaptation.  The cache is LRU over host-resident
:class:`~repro_torch.serve.lowrank.CompressedDelta` entries, with
hit/miss/eviction counters that the serving tier puts in its run log.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from repro_torch.serve.lowrank import (CompressedDelta, apply_delta,
                                       compress_delta)

__all__ = ["AdaptedStateCache", "TaskKey", "source_fingerprint", "task_key"]


def source_fingerprint(source: Any) -> str:
    """Deterministic identity of a task source's *distribution*: dataclass
    sources fingerprint as their primitive field values; anything else as
    class name + sorted primitive attributes (the reference's spelling, so
    the same source has the same fingerprint in both packages)."""
    cls = type(source).__name__
    if dataclasses.is_dataclass(source):
        items = [(f.name, getattr(source, f.name))
                 for f in dataclasses.fields(source)]
    else:
        items = sorted(vars(source).items()) if hasattr(source, "__dict__") \
            else []
    prims = [(k, v) for k, v in items
             if isinstance(v, (bool, int, float, str))]
    return cls + "(" + ",".join(f"{k}={v!r}" for k, v in prims) + ")"


@dataclasses.dataclass(frozen=True)
class TaskKey:
    """Cache key: ``source`` pins the task distribution, ``domain`` the
    task within it, and ``adapt`` the inner-loop hyperparameters
    ``(steps, lr)``."""
    source: str
    domain: int
    adapt: tuple[int, float]


def task_key(source: Any, domain: int, inner_steps: int,
             inner_lr: float) -> TaskKey:
    return TaskKey(source_fingerprint(source), int(domain),
                   (int(inner_steps), float(inner_lr)))


class AdaptedStateCache:
    """LRU cache of compressed adaptation deltas.

    ``lookup(key, base)`` returns the reconstructed adapted params (and
    counts a hit) or ``None`` (a miss); ``insert(key, base, adapted)``
    compresses and stores the delta, evicting least-recently-used entries
    beyond ``capacity``.
    """

    def __init__(self, capacity: int = 64, rank: int = 8,
                 tol: float = 0.3):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.rank = rank
        self.tol = tol
        self._store: collections.OrderedDict[TaskKey, CompressedDelta] = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: TaskKey) -> bool:
        return key in self._store

    def lookup(self, key: TaskKey, base: dict[str, torch.Tensor]
               ) -> dict[str, torch.Tensor] | None:
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._store.move_to_end(key)
        return apply_delta(base, entry)

    def insert(self, key: TaskKey, base: dict[str, torch.Tensor],
               adapted: dict[str, torch.Tensor]) -> CompressedDelta:
        entry = compress_delta(base, adapted, rank=self.rank, tol=self.tol)
        self._store[key] = entry
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1
        return entry

    def stats(self) -> dict:
        """Run-log-ready counters + residency accounting."""
        stored = sum(e.nbytes for e in self._store.values())
        dense = sum(e.dense_nbytes for e in self._store.values())
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "residents": len(self._store),
            "capacity": self.capacity,
            "rank": self.rank,
            "stored_bytes": int(stored),
            "dense_bytes": int(dense),
            "compression": float(dense / max(stored, 1)),
        }
