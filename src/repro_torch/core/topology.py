"""Graph topologies, doubly-stochastic combination matrices, and
per-step communication-graph schedules.

Pure numpy: a verbatim copy of the reference package's ``core/topology.py``
(the port imports nothing of the reference), held equal to it array for
array by ``tests/test_torch_topology.py``.

The combination matrix ``A = [a_{lk}]`` weights how agent ``k`` combines the
intermediate states of its neighbors ``l`` (paper eq. 6b).  Column ``k`` of
``A`` holds agent ``k``'s incoming weights.  Assumption 6 of the paper
requires ``A`` doubly stochastic and primitive; the Metropolis(-Hastings)
rule below satisfies both for any connected undirected graph with at least
one self-loop weight > 0.

Two object layers sit on top of the raw edge/matrix helpers:

:class:`Topology`
    one named graph instance — K, the edge set, the combination rule, the
    matrix, and the spectral diagnostics (``mixing_rate``, connectivity,
    double stochasticity) Thm 1 reasons about.

:class:`TopologySchedule`
    *who mixes with whom at step i*: a stacked ``(S, K, K)`` array of
    per-step combination matrices, cycled with period ``S``.  The stack is
    precomputed on the host; the combine backend indexes the stack with the
    step counter, so a dynamic graph needs no per-step rebuild.  ``ir()`` additionally emits the sparse
    :class:`ScheduleIR` lowering (the union of circular offsets over the
    period plus per-step weight tables) that the ``*_dynamic`` combine
    backends turn into a fixed set of ``lax.ppermute`` rounds at
    O(deg·|w|) wire cost.  Kinds (:data:`SCHEDULES`):

    ``static``        every step uses the topology's matrix (S = 1)
    ``link_failure``  each edge drops i.i.d. with probability ``p`` per
                      step; weights are re-derived on the surviving
                      subgraph, so every per-step matrix stays doubly
                      stochastic (a pre-sampled period of ``period`` draws
                      is cycled)
    ``gossip``        randomized gossip: one uniformly-drawn edge per step
                      performs a pairwise half-half exchange, everyone
                      else holds (Boyd et al. 2006 flavor)
    ``round_robin``   deterministic matchings: the edge set is greedily
                      colored so no two edges in a round share an agent;
                      round ``i mod S`` activates one matching, covering
                      every edge once per period
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "ring_edges",
    "grid_edges",
    "full_edges",
    "star_edges",
    "erdos_edges",
    "paper_fig2a_edges",
    "adjacency",
    "metropolis_weights",
    "uniform_weights",
    "mixing_rate",
    "is_doubly_stochastic",
    "is_primitive",
    "neighbor_lists",
    "Topology",
    "build_topology",
    "ScheduleIR",
    "schedule_ir",
    "TopologySchedule",
    "make_schedule",
    "SCHEDULES",
    "FIXED_SIZE",
]


# ---------------------------------------------------------------------------
# Edge constructors.  All return a list of undirected edges (l, k), l < k.
# ---------------------------------------------------------------------------

def ring_edges(K: int) -> list[tuple[int, int]]:
    if K < 2:
        return []
    edges = [(i, (i + 1) % K) for i in range(K)]
    return sorted({(min(a, b), max(a, b)) for a, b in edges})


def grid_edges(rows: int, cols: int, torus: bool = False) -> list[tuple[int, int]]:
    """2-D grid (optionally wrapped into a torus)."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            if c + 1 < cols:
                edges.add((k, r * cols + c + 1))
            elif torus and cols > 2:
                edges.add((min(k, r * cols), max(k, r * cols)))
            if r + 1 < rows:
                edges.add((k, (r + 1) * cols + c))
            elif torus and rows > 2:
                edges.add((min(k, c), max(k, c)))
    return sorted(edges)


def full_edges(K: int) -> list[tuple[int, int]]:
    return [(l, k) for l in range(K) for k in range(l + 1, K)]


def star_edges(K: int) -> list[tuple[int, int]]:
    return [(0, k) for k in range(1, K)]


def erdos_edges(K: int, p: float = 0.4, seed: int = 0) -> list[tuple[int, int]]:
    """Erdos-Renyi graph, re-sampled until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        mask = rng.random((K, K)) < p
        edges = [(l, k) for l in range(K) for k in range(l + 1, K) if mask[l, k]]
        if _connected(K, edges):
            return edges
    raise RuntimeError("could not sample a connected graph")


def paper_fig2a_edges() -> list[tuple[int, int]]:
    """The K=6 topology of the paper's Fig. 2a (a connected, non-complete
    graph; the paper does not give the exact edge list, we use a 6-node
    graph with the same flavor: a cycle plus two chords)."""
    return [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (1, 4), (2, 5)]


TOPOLOGIES = {
    "ring": lambda K, **kw: ring_edges(K),
    "full": lambda K, **kw: full_edges(K),
    "star": lambda K, **kw: star_edges(K),
    "grid": lambda K, **kw: grid_edges(*_factor(K), torus=False),
    "torus": lambda K, **kw: grid_edges(*_factor(K), torus=True),
    "erdos": lambda K, **kw: erdos_edges(K, **kw),
    "paper": lambda K, **kw: paper_fig2a_edges(),
}

# Graphs with a hard-wired agent count: requesting any other K would either
# index out of range or silently leave isolated agents, so edge construction
# validates eagerly (see ``_edges_for``).
FIXED_SIZE = {"paper": 6}


def _check_name(topology: str) -> None:
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"available: {tuple(TOPOLOGIES)}")


def _edges_for(K: int, topology: str, **kw) -> list[tuple[int, int]]:
    _check_name(topology)
    fixed = FIXED_SIZE.get(topology)
    if fixed is not None and K != fixed:
        raise ValueError(
            f"topology {topology!r} is a fixed {fixed}-agent graph but "
            f"num_agents={K}; run with {fixed} agents or pick a sized "
            f"topology ({tuple(t for t in TOPOLOGIES if t not in FIXED_SIZE)})")
    return TOPOLOGIES[topology](K, **kw)


def _factor(K: int) -> tuple[int, int]:
    r = int(np.sqrt(K))
    while K % r:
        r -= 1
    return r, K // r


def _connected(K: int, edges) -> bool:
    seen = {0}
    frontier = [0]
    adj = {i: [] for i in range(K)}
    for l, k in edges:
        adj[l].append(k)
        adj[k].append(l)
    while frontier:
        n = frontier.pop()
        for m in adj[n]:
            if m not in seen:
                seen.add(m)
                frontier.append(m)
    return len(seen) == K


# ---------------------------------------------------------------------------
# Combination matrices.
# ---------------------------------------------------------------------------

def adjacency(K: int, edges) -> np.ndarray:
    M = np.zeros((K, K), dtype=np.float64)
    for l, k in edges:
        M[l, k] = M[k, l] = 1.0
    return M


def metropolis_weights(K: int, edges) -> np.ndarray:
    """Metropolis-Hastings rule: a_{lk} = 1 / (1 + max(d_l, d_k)) for an edge,
    self-weight absorbs the remainder.  Symmetric => doubly stochastic."""
    adj = adjacency(K, edges)
    deg = adj.sum(axis=1)
    A = np.zeros((K, K), dtype=np.float64)
    for l, k in edges:
        A[l, k] = A[k, l] = 1.0 / (1.0 + max(deg[l], deg[k]))
    np.fill_diagonal(A, 1.0 - A.sum(axis=1))
    return A


def uniform_weights(K: int, edges) -> np.ndarray:
    """Lazy uniform averaging with max-degree normalization (also doubly
    stochastic for undirected graphs)."""
    adj = adjacency(K, edges)
    dmax = adj.sum(axis=1).max()
    A = adj / (dmax + 1.0)
    np.fill_diagonal(A, 1.0 - A.sum(axis=1))
    return A


def _rule_fn(rule: str):
    if rule == "metropolis":
        return metropolis_weights
    if rule == "uniform":
        return uniform_weights
    raise ValueError(f"unknown combination rule {rule!r}; "
                     f"available: ('metropolis', 'uniform')")


def combination_matrix(K: int, topology: str = "ring", rule: str = "metropolis",
                       **kw) -> np.ndarray:
    fn = _rule_fn(rule)          # validate even on the K=1 degenerate path
    _check_name(topology)        # so a typo never runs green at K=1
    if K == 1:
        return np.ones((1, 1))
    return fn(K, _edges_for(K, topology, **kw))


# ---------------------------------------------------------------------------
# Spectral / validation helpers (theory quantities from §3).
# ---------------------------------------------------------------------------

def mixing_rate(A: np.ndarray) -> float:
    """λ₂ = spectral radius of A^T - (1/K) 1 1^T  (paper Thm 1)."""
    K = A.shape[0]
    B = A.T - np.ones((K, K)) / K
    return float(np.max(np.abs(np.linalg.eigvals(B))))


def is_doubly_stochastic(A: np.ndarray, tol: float = 1e-9) -> bool:
    return (
        bool(np.all(A >= -tol))
        and bool(np.allclose(A.sum(axis=0), 1.0, atol=tol))
        and bool(np.allclose(A.sum(axis=1), 1.0, atol=tol))
    )


def is_primitive(A: np.ndarray) -> bool:
    """Primitive: some power of A is entrywise positive.  For a stochastic A
    it suffices that the graph is connected and at least one self-loop."""
    K = A.shape[0]
    M = (A > 0).astype(np.float64)
    P = np.linalg.matrix_power(M + np.eye(K) * 0, K * K)  # A^(K^2)
    # power of the boolean pattern:
    P = np.linalg.matrix_power(M, max(1, (K - 1) * (K - 1) + 1))
    return bool(np.all(P > 0))


def neighbor_lists(A: np.ndarray) -> list[list[int]]:
    """For each agent k, incoming neighbors l (a_{lk} > 0), excluding self."""
    K = A.shape[0]
    return [[l for l in range(K) if l != k and A[l, k] > 0] for k in range(K)]


def permute_offsets(A: np.ndarray, K: int) -> list[int]:
    """For circulant (ring/torus-on-agent-axis) matrices: the set of nonzero
    offsets d such that a_{(k-d) mod K, k} > 0 for all k.  Used by the sparse
    ppermute combine.  Returns [] if A is not circulant."""
    offsets = []
    for d in range(1, K):
        col = np.array([A[(k - d) % K, k] for k in range(K)])
        if np.all(col > 0):
            offsets.append(d)
        elif np.any(col > 0):
            return []  # not circulant-sparse
    return offsets


def is_circulant(A: np.ndarray, tol: float = 1e-12) -> bool:
    K = A.shape[0]
    first = A[:, 0]
    for k in range(1, K):
        if not np.allclose(np.roll(first, k), A[:, k], atol=tol):
            return False
    return True


# ---------------------------------------------------------------------------
# Topology: one named graph instance with its matrix + diagnostics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Topology:
    """A named communication graph: K agents, an undirected edge set, and
    the combination rule that turns it into a doubly-stochastic matrix."""

    name: str
    K: int
    edges: tuple[tuple[int, int], ...]
    rule: str = "metropolis"

    @functools.cached_property
    def matrix(self) -> np.ndarray:
        if self.K == 1:
            return np.ones((1, 1))
        return _rule_fn(self.rule)(self.K, list(self.edges))

    @functools.cached_property
    def mixing_rate(self) -> float:
        """λ₂ — the linear agreement rate of Thm 1."""
        return mixing_rate(self.matrix)

    @property
    def connected(self) -> bool:
        return _connected(self.K, list(self.edges))

    @property
    def max_degree(self) -> int:
        deg = np.zeros(self.K, dtype=int)
        for l, k in self.edges:
            deg[l] += 1
            deg[k] += 1
        return int(deg.max()) if self.K else 0

    def diagnostics(self) -> dict:
        """Spectral/structural summary (benchmark + run-log reporting)."""
        A = self.matrix
        return {
            "name": self.name,
            "K": self.K,
            "edges": len(self.edges),
            "rule": self.rule,
            "mixing_rate": self.mixing_rate,
            "doubly_stochastic": is_doubly_stochastic(A),
            "primitive": is_primitive(A),
            "connected": self.connected,
        }


def build_topology(name: str, K: int, rule: str = "metropolis",
                   **kw) -> Topology:
    """Construct a :class:`Topology`, validating K against fixed-size graphs
    eagerly (a 'paper' graph with ``--agents 4`` fails here with both
    numbers, not later with a shape error)."""
    _rule_fn(rule)           # validate the rule name eagerly too
    _check_name(name)
    edges = _edges_for(K, name, **kw) if K > 1 else []
    return Topology(name=name, K=K, edges=tuple(edges), rule=rule)


# ---------------------------------------------------------------------------
# ScheduleIR: sparse lowering of a periodic matrix schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleIR:
    """Structured sparse form of a periodic ``(S, K, K)`` matrix schedule.

    Every off-diagonal entry ``A_s[l, k]`` belongs to exactly one circular
    offset ``d = (k - l) mod K``, so any matrix stack decomposes *exactly*
    into per-offset destination-weight vectors:

      ``offsets``         union over the period of offsets ``d`` carrying
                          any nonzero weight at any step — the fixed
                          ``lax.ppermute`` rounds a dynamic-sparse combine
                          executes (round_robin/link_failure/gossip never
                          activate an edge outside the static graph, so
                          this is the static graph's offset set)
      ``self_weights``    ``(S, K)`` — per-step diagonal of ``A_s``
      ``offset_weights``  ``(S, D, K)`` with ``D = len(offsets)``:
                          ``offset_weights[s, i, k] =
                          A_s[(k - offsets[i]) mod K, k]`` — agent ``k``'s
                          incoming weight over round ``i`` at step ``s``.
                          Steps that do not activate an offset carry
                          elementwise-zero weights (the permute still runs:
                          the round set is step-independent, which is what
                          keeps the lowering jit-compatible)

    The combine backends gather row ``step % S`` of both tables with the
    traced step index, so a dynamic graph costs D collective-permutes of
    one model each — O(deg·|w|) wire — instead of the O(K·|w|) gather of
    the dense step-indexed einsum.
    """

    K: int
    offsets: tuple[int, ...]
    self_weights: np.ndarray      # (S, K)
    offset_weights: np.ndarray    # (S, D, K)

    @property
    def period(self) -> int:
        return self.self_weights.shape[0]

    @property
    def degree(self) -> int:
        """Number of permute rounds D (the wire cost in models/step)."""
        return len(self.offsets)

    def matrix_at(self, step: int) -> np.ndarray:
        """Reconstruct the dense matrix of ``step`` (exact inverse of
        :func:`schedule_ir` — regression surface for the lowering)."""
        s = step % self.period
        A = np.zeros((self.K, self.K), dtype=self.self_weights.dtype)
        np.fill_diagonal(A, self.self_weights[s])
        for i, d in enumerate(self.offsets):
            for k in range(self.K):
                A[(k - d) % self.K, k] = self.offset_weights[s, i, k]
        return A

    def stacked(self) -> np.ndarray:
        return np.stack([self.matrix_at(s) for s in range(self.period)])


def schedule_ir(matrices: np.ndarray) -> ScheduleIR:
    """Lower a ``(K, K)`` matrix or stacked ``(S, K, K)`` schedule to its
    exact :class:`ScheduleIR` decomposition."""
    M = np.asarray(matrices)
    if M.ndim == 2:
        M = M[None]
    S, K, _ = M.shape
    # != 0, not > 0: negative off-diagonal weights (e.g. accelerated
    # consensus matrices) are legal entries and must keep their offset
    offsets = tuple(d for d in range(1, K)
                    if any(M[s, (k - d) % K, k] != 0
                           for s in range(S) for k in range(K)))
    self_w = np.stack([np.diagonal(M[s]).copy() for s in range(S)])
    off_w = np.zeros((S, len(offsets), K), dtype=M.dtype)
    for s in range(S):
        for i, d in enumerate(offsets):
            off_w[s, i] = [M[s, (k - d) % K, k] for k in range(K)]
    return ScheduleIR(K=K, offsets=offsets, self_weights=self_w,
                      offset_weights=off_w)


# ---------------------------------------------------------------------------
# TopologySchedule: who mixes with whom at step i, as a stacked matrix array
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A periodic sequence of combination matrices.

    ``matrices`` is ``(S, K, K)``; step ``i`` uses ``matrices[i % S]``.
    Every entry is doubly stochastic by construction, so the centroid is
    invariant at every step (the Thm 2 mechanism survives dynamic graphs).
    ``stacked()`` feeds :func:`repro_torch.core.diffusion.make_combine` —
    the backend indexes the stack with the step counter.
    """

    kind: str
    topology: Topology
    matrices: np.ndarray

    @property
    def period(self) -> int:
        return self.matrices.shape[0]

    @property
    def static(self) -> bool:
        return self.period == 1

    def matrix_at(self, step: int) -> np.ndarray:
        return self.matrices[step % self.period]

    def stacked(self) -> np.ndarray:
        """The array handed to the combine backend: ``(K, K)`` for a static
        schedule (so sparse/mesh backends stay eligible), ``(S, K, K)``
        otherwise."""
        return self.matrices[0] if self.static else self.matrices

    @functools.cached_property
    def _ir(self) -> ScheduleIR:
        return schedule_ir(self.matrices)

    def ir(self) -> ScheduleIR:
        """The sparse :class:`ScheduleIR` lowering of this schedule — what
        the ``sparse_dynamic``/``mesh_sparse_dynamic``/
        ``sparse_host_dynamic`` combine backends consume."""
        return self._ir

    @functools.cached_property
    def mean_matrix(self) -> np.ndarray:
        """E[A] over the period — its λ₂ is the *expected* per-step
        contraction a random schedule achieves (Boyd et al. 2006)."""
        return self.matrices.mean(axis=0)

    @property
    def mean_mixing_rate(self) -> float:
        return mixing_rate(self.mean_matrix)


def _static_schedule(topo: Topology, **kw) -> np.ndarray:
    return topo.matrix[None]


def _link_failure_schedule(topo: Topology, p: float = 0.2, period: int = 64,
                           seed: int = 0, **kw) -> np.ndarray:
    """Each edge drops i.i.d. with probability ``p`` at each step; the
    combination rule is re-applied to the surviving subgraph so every
    per-step matrix is doubly stochastic (a disconnected instant is fine —
    agreement only needs the *sequence* to mix)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"link-failure probability must be in [0, 1], got {p}")
    rng = np.random.default_rng(seed)
    fn = _rule_fn(topo.rule)
    mats = []
    for _ in range(period):
        alive = [e for e in topo.edges if rng.random() >= p]
        mats.append(fn(topo.K, alive) if alive else np.eye(topo.K))
    return np.stack(mats)


def _gossip_schedule(topo: Topology, period: int = 64, seed: int = 0,
                     **kw) -> np.ndarray:
    """Randomized gossip: one uniformly-drawn edge per step does a
    half-half pairwise exchange; all other agents hold their state."""
    if not topo.edges:
        return np.eye(topo.K)[None]
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(period):
        l, k = topo.edges[rng.integers(len(topo.edges))]
        A = np.eye(topo.K)
        A[l, l] = A[k, k] = A[l, k] = A[k, l] = 0.5
        mats.append(A)
    return np.stack(mats)


def _round_robin_schedule(topo: Topology, **kw) -> np.ndarray:
    """Deterministic matchings via greedy edge coloring: each round's edges
    share no agent, so each round is a disjoint set of pairwise half-half
    exchanges; the full edge set is covered once per period."""
    if not topo.edges:
        return np.eye(topo.K)[None]
    rounds: list[list[tuple[int, int]]] = []
    busy: list[set[int]] = []
    for e in topo.edges:
        for r, members in enumerate(busy):
            if e[0] not in members and e[1] not in members:
                rounds[r].append(e)
                members.update(e)
                break
        else:
            rounds.append([e])
            busy.append(set(e))
    mats = []
    for matching in rounds:
        A = np.eye(topo.K)
        for l, k in matching:
            A[l, l] = A[k, k] = A[l, k] = A[k, l] = 0.5
        mats.append(A)
    return np.stack(mats)


SCHEDULES = {
    "static": _static_schedule,
    "link_failure": _link_failure_schedule,
    "gossip": _gossip_schedule,
    "round_robin": _round_robin_schedule,
}


def make_schedule(kind: str, topo: Topology, **kw) -> TopologySchedule:
    """Build a :class:`TopologySchedule` of the registered ``kind``.

    Keyword args are schedule-specific: ``p``/``period``/``seed`` for
    ``link_failure``, ``period``/``seed`` for ``gossip``; ``static`` and
    ``round_robin`` take none.
    """
    if kind not in SCHEDULES:
        raise ValueError(f"unknown topology schedule {kind!r}; "
                         f"available: {tuple(SCHEDULES)}")
    if topo.K == 1:
        return TopologySchedule(kind, topo, np.ones((1, 1, 1)))
    return TopologySchedule(kind, topo, SCHEDULES[kind](topo, **kw))
