"""The paper's sine-wave regression benchmark (§4.1, after Finn et al. 2017;
port of ``repro/data/sine.py``).

Each task: predict ``y = amplitude * sin(x + phase)`` from ``x ∈ [-5, 5]``.
Phases ~ U[0, π].  The amplitude interval [0.1, 5.0] is discretized into
bands sharded across the K agents — agents see *different* task
distributions (the paper's heterogeneous setting).  Sampling is the
reference's numpy code, so episodes are bit-identical to it.

The pre-`TaskSource` API — :class:`SineTaskDistribution` (one agent's
amplitude interval), :func:`agent_sine_distributions` (the paper's K equal
sub-intervals) and :func:`stacked_agent_batch` — is kept as the reference
keeps it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.episodes import DomainShardedSource, Episode, tree_map

AMP_LO, AMP_HI = 0.1, 5.0
PHASE_LO, PHASE_HI = 0.0, np.pi
X_LO, X_HI = -5.0, 5.0


@dataclasses.dataclass
class SineTaskDistribution:
    amp_lo: float = AMP_LO
    amp_hi: float = AMP_HI
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample_batch(self, n_tasks: int, shots: int):
        """Returns (support, query): each (x, y) with shape
        (n_tasks, shots, 1).  Support/query are disjoint draws from the same
        sinusoid (the paper's two-batch X_in / X_o scheme, footnote 1)."""
        amp = self._rng.uniform(self.amp_lo, self.amp_hi, size=(n_tasks, 1, 1))
        phase = self._rng.uniform(PHASE_LO, PHASE_HI, size=(n_tasks, 1, 1))
        xs = self._rng.uniform(X_LO, X_HI, size=(n_tasks, 2 * shots, 1))
        ys = (amp * np.sin(xs + phase)).astype(np.float32)
        xs = xs.astype(np.float32)
        return ((xs[:, :shots], ys[:, :shots]),
                (xs[:, shots:], ys[:, shots:]))


def agent_sine_distributions(K: int, seed: int = 0
                             ) -> list[SineTaskDistribution]:
    """Partition [0.1, 5.0] into K equal amplitude intervals (paper §4.1)."""
    edges = np.linspace(AMP_LO, AMP_HI, K + 1)
    return [SineTaskDistribution(float(edges[k]), float(edges[k + 1]),
                                 seed + k)
            for k in range(K)]


def stacked_agent_batch(dists, tasks_per_agent: int, shots: int):
    """One Dif-MAML step's data: ``((sx, sy), (qx, qy))`` with leading
    (K, tasks_per_agent, shots, 1) axes."""
    sup, qry = zip(*[d.sample_batch(tasks_per_agent, shots) for d in dists])
    stack = lambda *xs: np.stack(xs, axis=0)
    return tree_map(stack, *sup), tree_map(stack, *qry)


@dataclasses.dataclass
class SineTaskSource(DomainShardedSource):
    """`TaskSource` view of the sine benchmark: ``n_domains`` amplitude
    bands sharded across agents via ``partition_domains``.  A task = one
    band draw, amplitude uniform inside the band, phase ~ U[0, π];
    support/query are disjoint draws from the same sinusoid.

    ``holdout_domains`` reserves the top amplitude bands for the unseen
    eval split.
    """
    K: int = 6
    tasks_per_agent: int = 5
    shots: int = 10
    n_domains: int = 60
    holdout_domains: int = 0
    seed: int = 0
    heterogeneity: str = "amplitude-bands"

    def __post_init__(self):
        self._edges = np.linspace(AMP_LO, AMP_HI, self.n_domains + 1)

    @property
    def n_train_domains(self) -> int:
        return self.n_domains - self.holdout_domains

    def _tasks(self, dom: np.ndarray, rng: np.random.Generator):
        """(support, query) for one batch of band-indexed tasks."""
        T, S = len(dom), self.shots
        amp = rng.uniform(self._edges[dom], self._edges[dom + 1])[:, None, None]
        phase = rng.uniform(PHASE_LO, PHASE_HI, size=(T, 1, 1))
        xs = rng.uniform(X_LO, X_HI, size=(T, 2 * S, 1))
        ys = (amp * np.sin(xs + phase)).astype(np.float32)
        xs = xs.astype(np.float32)
        return ((xs[:, :S], ys[:, :S]), (xs[:, S:], ys[:, S:]))

    def _agent_episode(self, k, domains, rng):
        dom = rng.choice(domains, size=self.tasks_per_agent)
        support, query = self._tasks(dom, rng)
        return support, query, dom

    def eval_sample(self, n_tasks: int, seed: int | None = None,
                    split: str | None = None) -> Episode:
        """Eval tasks: ``split=None`` keeps the paper's protocol (the full
        amplitude interval); 'recurring' draws only trained bands,
        'unseen' only the held-out tail."""
        rng = self._eval_rng(seed)
        dom = rng.choice(self.eval_domain_pool(split), size=n_tasks)
        support, query = self._tasks(dom, rng)
        return Episode(support, query, domains=dom)
