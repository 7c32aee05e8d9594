"""Episode/task-stream substrate (port of ``repro/data/episodes.py``).

An :class:`Episode` is one meta-iteration's data with canonical
``(K, T, tb, ...)`` leading axes, a :class:`TaskSource` is anything that can
produce them, and :func:`partition_domains` assigns each agent a
pairwise-disjoint shard of the domain universe (the paper's heterogeneous
π_k).  Sampling is numpy, with the reference's rng derivation, so the port's
episodes are bit-identical to the reference's for the same
``(seed, step)``; torch enters only in :meth:`Episode.to_device`.

Determinism contract: ``sample(step)`` is a pure function of
``(source config, seed, step)`` — the prefetch pipeline relies on it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

PyTree = Any

__all__ = ["Episode", "TaskSource", "AgentStream", "DomainShardedSource",
           "partition_domains", "episode_rng", "tree_map", "EVAL_SPLITS"]

# The recurring-vs-unseen eval contract (Fallah et al. 2021).
EVAL_SPLITS = ("recurring", "unseen")

# Distinct salts keep the train / eval rng streams of one seed disjoint.
_TRAIN_SALT = 0x5EED_0001
_EVAL_SALT = 0x5EED_0002


def tree_map(fn, *trees):
    """``fn`` over the leaves of matching nested dicts/tuples/lists."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def episode_rng(salt: int, seed: int, step: int, agent: int = 0
                ) -> np.random.Generator:
    """Deterministic per-(seed, step, agent) generator (cross-host stable)."""
    return np.random.default_rng([salt, seed, step, agent])


def partition_domains(n_domains: int, K: int) -> list[np.ndarray]:
    """Split ``range(n_domains)`` into K contiguous pairwise-disjoint shards
    covering every domain (sizes differ by at most one)."""
    if K < 1:
        raise ValueError(f"need at least one agent, got K={K}")
    if n_domains < K:
        raise ValueError(
            f"cannot shard {n_domains} domains across K={K} agents: every "
            f"agent needs a non-empty disjoint shard (need n_domains >= K)")
    return list(np.array_split(np.arange(n_domains), K))


def host_tensors(tree: PyTree, pin: bool = False) -> PyTree:
    """numpy leaves -> CPU tensors (page-locked when ``pin``, so a later
    ``.to(cuda, non_blocking=True)`` is a true asynchronous copy)."""
    def leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if pin else t
    return tree_map(leaf, tree)


def to_device(tree: PyTree, device: torch.device) -> PyTree:
    """Move tensor leaves to ``device`` on the caller's current stream."""
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


@dataclasses.dataclass
class Episode:
    """One meta-iteration's data.

    ``support``/``query`` are pytrees of numpy arrays whose leaves share the
    leading axes ``(K, tasks_per_agent, task_batch, ...)`` — or, for eval
    episodes, ``(n_tasks, ...)`` with no agent axis.  ``domains`` records
    which domain each task was drawn from, shape ``(K, T)``.
    """
    support: PyTree
    query: PyTree
    domains: np.ndarray | None = None
    step: int | None = None

    def as_flat_batch(self) -> PyTree:
        """Inverse of ``launch.steps.split_meta_batch``: support and query
        concatenated along the task-batch axis and ``(K, T, 2·tb)``
        flattened to the global batch axis ``B = K·T·2·tb``."""
        def leaf(s, q):
            both = np.concatenate([np.asarray(s), np.asarray(q)], axis=2)
            return both.reshape((-1,) + both.shape[3:])
        return tree_map(leaf, self.support, self.query)

    def to_device(self, device: str | torch.device
                  ) -> tuple[PyTree, PyTree]:
        """``(support, query)`` as torch tensors on ``device``."""
        device = torch.device(device)
        pair = host_tensors((self.support, self.query),
                            pin=device.type == "cuda")
        return to_device(pair, device)


@runtime_checkable
class TaskSource(Protocol):
    """The contract every workload implements exactly once: ``K``,
    ``tasks_per_agent``, ``heterogeneity``, ``n_domains``,
    ``sources(K)``, ``sample(step)`` and ``eval_sample(n, seed, split)``
    (see the reference's ``data/episodes.py`` for the full contract)."""
    K: int
    tasks_per_agent: int
    heterogeneity: str

    @property
    def n_domains(self) -> int: ...

    def sources(self, K: int | None = None) -> list["AgentStream"]: ...

    def sample(self, step: int) -> Episode: ...

    def eval_sample(self, n_tasks: int, seed: int | None = None,
                    split: str | None = None) -> Episode: ...


@dataclasses.dataclass
class AgentStream:
    """Agent k's view of a :class:`TaskSource`: its disjoint domain shard
    plus exactly the agent-k slice of the source's stacked episode."""
    source: "DomainShardedSource"
    agent: int
    domains: np.ndarray

    def sample(self, step: int) -> Episode:
        ep = self.source.sample(step)
        k = self.agent
        take = lambda x: x[k]
        return Episode(tree_map(take, ep.support), tree_map(take, ep.query),
                       domains=None if ep.domains is None else ep.domains[k],
                       step=step)


class DomainShardedSource:
    """Shared mechanics for domain-sharded task sources.

    Subclasses provide ``K``, ``tasks_per_agent``, ``seed``, ``n_domains``
    (optionally ``n_train_domains`` when some domains are held out for
    eval) and implement ``_agent_episode`` — one agent's
    ``(support, query, domains)`` for one step.
    """

    # --- sharding ----------------------------------------------------------

    @property
    def n_train_domains(self) -> int:
        return self.n_domains

    def shards(self) -> list[np.ndarray]:
        return partition_domains(self.n_train_domains, self.K)

    def eval_domain_pool(self, split: str | None) -> np.ndarray:
        """Domain ids an eval episode of ``split`` may draw from:
        'recurring' = the trained shards' union, 'unseen' = the held-out
        tail, None/'full' = the whole universe."""
        if split in (None, "full"):
            return np.arange(self.n_domains)
        if split == "recurring":
            return np.arange(self.n_train_domains)
        if split == "unseen":
            if self.n_train_domains >= self.n_domains:
                raise ValueError(
                    f"{type(self).__name__} has no held-out domains for "
                    f"split='unseen' (n_domains={self.n_domains}, all "
                    f"trained); configure holdout_domains > 0")
            return np.arange(self.n_train_domains, self.n_domains)
        raise ValueError(
            f"unknown eval split {split!r}: expected one of "
            f"{EVAL_SPLITS + ('full', None)}")

    def sources(self, K: int | None = None) -> list[AgentStream]:
        if K is not None and K != self.K:
            raise ValueError(
                f"source is bound to K={self.K} agents; rebuild it to "
                f"stream for K={K}")
        return [AgentStream(self, k, shard)
                for k, shard in enumerate(self.shards())]

    # --- rng ---------------------------------------------------------------

    def _rng(self, step: int, agent: int = 0) -> np.random.Generator:
        return episode_rng(_TRAIN_SALT, self.seed, step, agent)

    def _eval_rng(self, seed: int | None) -> np.random.Generator:
        return episode_rng(_EVAL_SALT, self.seed if seed is None else seed, 0)

    # --- episode assembly --------------------------------------------------

    def _agent_episode(self, k: int, domains: np.ndarray,
                       rng: np.random.Generator
                       ) -> tuple[PyTree, PyTree, np.ndarray]:
        raise NotImplementedError

    def sample(self, step: int) -> Episode:
        parts = [self._agent_episode(k, shard, self._rng(step, k))
                 for k, shard in enumerate(self.shards())]
        sups, qrys, doms = zip(*parts)
        stack = lambda *xs: np.stack(xs, axis=0)
        return Episode(tree_map(stack, *sups), tree_map(stack, *qrys),
                       domains=np.stack(doms, axis=0), step=step)
