"""Synthetic N-way K-shot episodic sampler (Omniglot-like; paper §4.2; port
of ``repro/data/fewshot.py``).

The real Omniglot/MiniImagenet archives are not available offline, so the
workload is a *structured* synthetic surrogate with the same episodic
statistics: a universe of ``n_classes`` class prototypes in pixel space;
samples = prototype + per-sample noise.  Classes are meta-split into
train/test so meta-generalization is measurable, and the paper's comparison
(centralized vs Dif vs non-coop) is reproduced on identical semantics.
Sampling is the reference's numpy code — the same generator calls in the
same order — so episodes are equal arrays to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.episodes import DomainShardedSource, Episode, tree_map

__all__ = ["FewShotSampler", "FewShotTaskSource"]


def _stack(*xs):
    return np.stack(xs, axis=0)


@dataclasses.dataclass
class FewShotSampler:
    n_classes: int = 200
    image_hw: int = 14
    n_way: int = 5
    k_shot: int = 1
    n_query: int = 5
    noise: float = 0.15
    seed: int = 0
    train_fraction: float = 0.8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        d = self.image_hw * self.image_hw
        # class prototypes: smooth random images (low-frequency mixtures)
        freqs = rng.normal(size=(self.n_classes, 8, d)).astype(np.float32)
        coefs = rng.normal(size=(self.n_classes, 8, 1)).astype(np.float32)
        self._protos = np.tanh((freqs * coefs).sum(axis=1))  # (C, d)
        n_train = int(self.n_classes * self.train_fraction)
        self._train_classes = np.arange(n_train)
        self._test_classes = np.arange(n_train, self.n_classes)
        self._rng = rng

    @property
    def dim(self) -> int:
        return self.image_hw * self.image_hw

    def _episode(self, classes: np.ndarray, rng: np.random.Generator):
        way = rng.choice(classes, size=self.n_way, replace=False)
        return self.episode_from_classes(way, rng)

    def episode_from_classes(self, way: np.ndarray, rng: np.random.Generator):
        """Support/query for one episode over an explicit class selection:
        ``((xs, ys), (xq, yq))``, images float32 ``(n, hw·hw)``, labels
        int32 (the class's index in ``way``)."""
        n = self.k_shot + self.n_query
        protos = self._protos[way]  # (way, d)
        x = protos[:, None, :] + self.noise * rng.normal(
            size=(self.n_way, n, self.dim)).astype(np.float32)
        y = np.broadcast_to(np.arange(self.n_way)[:, None], (self.n_way, n))
        xs = x[:, : self.k_shot].reshape(-1, self.dim)
        ys = y[:, : self.k_shot].reshape(-1)
        xq = x[:, self.k_shot:].reshape(-1, self.dim)
        yq = y[:, self.k_shot:].reshape(-1)
        return (xs.astype(np.float32), ys.astype(np.int32)), \
               (xq.astype(np.float32), yq.astype(np.int32))

    def sample(self, n_tasks: int, split: str = "train",
               seed: int | None = None):
        """Support (x, y) and query (x, y) stacked over tasks."""
        rng = self._rng if seed is None else np.random.default_rng(seed)
        classes = (self._train_classes if split == "train"
                   else self._test_classes)
        sup, qry = zip(*[self._episode(classes, rng) for _ in range(n_tasks)])
        return tree_map(_stack, *sup), tree_map(_stack, *qry)

    def sample_agents(self, K: int, tasks_per_agent: int,
                      split: str = "train"):
        """Leading (K, T, ...) axes, all agents sharing the class universe
        (the paper's classification setting).  Legacy path — the
        heterogeneous view is :class:`FewShotTaskSource`."""
        sup, qry = self.sample(K * tasks_per_agent, split)
        reshape = lambda a: a.reshape((K, tasks_per_agent) + a.shape[1:])
        return tree_map(reshape, sup), tree_map(reshape, qry)


@dataclasses.dataclass
class FewShotTaskSource(DomainShardedSource):
    """`TaskSource` view of the few-shot benchmark: a domain = one meta-train
    class, and ``partition_domains`` gives each agent a disjoint class shard
    — agent k composes its N-way episodes only from its own classes
    (heterogeneous π_k), while :meth:`eval_sample` draws from the meta-test
    classes shared by nobody.
    """
    K: int = 6
    tasks_per_agent: int = 2
    n_classes: int = 200
    image_hw: int = 14
    n_way: int = 5
    k_shot: int = 1
    n_query: int = 5
    noise: float = 0.15
    train_fraction: float = 0.8
    seed: int = 0
    heterogeneity: str = "class-shards"

    def __post_init__(self):
        self.sampler = FewShotSampler(
            n_classes=self.n_classes, image_hw=self.image_hw,
            n_way=self.n_way, k_shot=self.k_shot, n_query=self.n_query,
            noise=self.noise, seed=self.seed,
            train_fraction=self.train_fraction)
        per_agent = len(self.sampler._train_classes) // self.K
        if per_agent < self.n_way:
            raise ValueError(
                f"K={self.K} agents over "
                f"{len(self.sampler._train_classes)} meta-train classes "
                f"leaves shards of ~{per_agent} classes — too few for "
                f"{self.n_way}-way episodes (need n_classes*train_fraction "
                f">= K*n_way = {self.K * self.n_way})")

    @property
    def dim(self) -> int:
        return self.image_hw * self.image_hw

    @property
    def n_domains(self) -> int:
        return len(self.sampler._train_classes)

    @property
    def n_test_domains(self) -> int:
        return len(self.sampler._test_classes)

    def eval_domain_pool(self, split):
        """'recurring' = meta-train classes (the trained shards' union),
        'unseen' = meta-test classes (shared by no agent), 'full' = both.
        The default eval split is 'unseen' — the classic meta-test."""
        if split == "recurring":
            return self.sampler._train_classes
        if split in (None, "unseen"):
            return self.sampler._test_classes
        if split == "full":
            return np.arange(self.n_classes)
        raise ValueError(f"unknown eval split {split!r}")

    def _episodes(self, n: int, pool: np.ndarray, rng: np.random.Generator):
        """``n`` episodes over classes of ``pool``, stacked: (support,
        query, ways)."""
        ways, sup, qry = [], [], []
        for _ in range(n):
            way = rng.choice(pool, size=self.n_way, replace=False)
            s, q = self.sampler.episode_from_classes(way, rng)
            ways.append(way); sup.append(s); qry.append(q)
        return tree_map(_stack, *sup), tree_map(_stack, *qry), \
            np.stack(ways, axis=0)

    def _agent_episode(self, k, domains, rng):
        return self._episodes(self.tasks_per_agent, domains, rng)

    def eval_sample(self, n_tasks: int, seed: int | None = None,
                    split: str | None = None) -> Episode:
        rng = self._eval_rng(seed)
        sup, qry, ways = self._episodes(n_tasks, self.eval_domain_pool(split),
                                        rng)
        return Episode(sup, qry, domains=ways)
