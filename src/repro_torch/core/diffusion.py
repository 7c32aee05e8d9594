"""Diffusion (Adapt-then-Combine) over a stacked agent axis — the
single-host part of ``repro/core/diffusion.py``.

Every per-agent launch model is stored with a leading ``K`` (agent) axis on
every parameter leaf.  The combine step (paper eq. 6b)

    w_{k,i} = Σ_l a_{lk} φ_{l,i}

is a contraction over that axis — the algorithm's only communication point.
All implementations sit behind one entry point, :func:`make_combine`, and
return ``combine(phi, step=None)``: ``step`` (a host-side int) selects the
current matrix of a stacked ``(S, K, K)`` schedule; static matrices ignore
it.

Registered backends
===================

``dense``        einsum against the full K×K matrix (step-indexed for a
                 stacked schedule).
``sparse_host``  one weighted ``torch.roll`` per circular neighbor offset;
                 exact for any static A.
``sparse_host_dynamic``
                 the rolls of a stacked schedule's :class:`ScheduleIR`
                 (the period's offset union), weights gathered at
                 ``step % S``.
``pallas``       the ``dif_combine`` kernel over the leaves as they are, one
                 launch per dtype group.  The name is the JAX package's, so
                 a ``MetaConfig`` means the same in both packages; on the
                 port it is the hand-written CUDA kernel of
                 :mod:`repro_torch.kernels.dif_combine` (its plain PyTorch
                 version on CPU tensors).
``fused``        combine-only face of the fused outer update: the same
                 ``dif_combine`` path, used by the cta pre-mix.  The
                 trainer runs the real fused update through
                 :mod:`repro_torch.core.fused` (the ``fused_combine_update``
                 CUDA kernel).
``centralized``  every agent receives the centroid (A = (1/K)11ᵀ).
``none``         identity: the non-cooperative baseline (A = I).

The reference's ppermute/mesh backends (``sparse``, ``mesh_sparse`` and
their ``*_dynamic`` forms) need a multi-process agent group and wait for a
later slice.

Backend selection (``make_combine("auto", ...)``):

  1. K == 1                                         → ``none``
  2. stacked schedule, sparse offset union          → ``sparse_host_dynamic``
  3. stacked schedule, dense offset union           → ``dense``
  4. circular-offset-sparse static A (deg < K−1)    → ``sparse_host``
  5. dense A on a CUDA device                       → ``pallas``
  6. otherwise                                      → ``dense``
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]
CombineFn = Callable[..., Params]

__all__ = [
    "pad_geometry",
    "dense_combine",
    "sparse_combine_host",
    "make_sparse_host_dynamic_combine",
    "make_pallas_combine",
    "pack_pytree",
    "centralized_combine",
    "no_combine",
    "CombineBackend",
    "register_backend",
    "combine_backends",
    "select_backend",
    "resolve_schedule_backend",
    "resolve_combine_dtype",
    "WIRE_DTYPES",
    "make_combine",
    "atc_step",
    "cta_step",
    "disagreement",
    "centroid",
]

LANE = 128     # padding granularity, kept from the TPU layout for parity


def pad_geometry(m: int, block_m: int = 512) -> tuple[int, int]:
    """``(padded width, tile)`` for ``m`` packed columns — the JAX package's
    padding rule for its Pallas kernels, kept for :func:`pack_pytree`:
    widths up to ``block_m`` round up to a 128 multiple, larger ones to a
    ``block_m`` multiple.  Padded columns are zero and stay zero through
    both kernels.  The port's kernels take leaves unpadded."""
    unit = LANE if m <= block_m else block_m
    m_pad = -(-m // unit) * unit
    return m_pad, min(m_pad, block_m)


def _circular_offsets(A: np.ndarray) -> list[int]:
    """Offsets d in [1, K) with any nonzero weight a_{(k-d) mod K, k}."""
    K = A.shape[0]
    return [d for d in range(1, K)
            if any(A[(k - d) % K, k] > 0 for k in range(K))]


# ---------------------------------------------------------------------------
# Combine implementations
# ---------------------------------------------------------------------------

def dense_combine(A: torch.Tensor, phi: Params) -> Params:
    """w_new[k] = Σ_l A[l, k] φ[l] on the leading agent axis of each leaf."""
    return {k: torch.einsum("lk,l...->k...", A.to(x.dtype), x)
            for k, x in phi.items()}


def _roll_mix(x: torch.Tensor, self_w: torch.Tensor,
              offsets, off_w) -> torch.Tensor:
    """Σ over circular offsets d of w_d ⊙ roll(x, d) plus the self term."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    acc = x * self_w.to(x.dtype).reshape(shape)
    for i, d in enumerate(offsets):
        # agent k receives from agent (k - d) mod K  ==  roll by +d
        acc = acc + off_w[i].to(x.dtype).reshape(shape) * torch.roll(x, d, 0)
    return acc


def sparse_combine_host(A: np.ndarray, phi: Params) -> Params:
    """Single-host weighted-roll combine: one ``torch.roll`` per circular
    neighbor offset of the static matrix ``A``."""
    A = np.asarray(A)
    K = A.shape[0]
    offsets = _circular_offsets(A)
    dev = next(iter(phi.values())).device
    self_w = torch.as_tensor(np.diagonal(A).copy(), device=dev)
    off_w = [torch.as_tensor(np.array([A[(k - d) % K, k] for k in range(K)]),
                             device=dev) for d in offsets]
    return {k: _roll_mix(x, self_w, offsets, off_w) for k, x in phi.items()}


def make_sparse_host_dynamic_combine(ir: topology.ScheduleIR,
                                     device) -> CombineFn:
    """Host-roll lowering of a dynamic schedule: one weighted roll per
    offset in the period's union, weights gathered at ``step % S``."""
    S, offsets = ir.period, ir.offsets
    self_w = torch.as_tensor(ir.self_weights, dtype=torch.float32,
                             device=device)                      # (S, K)
    off_w = torch.as_tensor(ir.offset_weights, dtype=torch.float32,
                            device=device)                       # (S, D, K)

    def combine(phi: Params, step=None) -> Params:
        s = _schedule_row(step, S)
        return {k: _roll_mix(x, self_w[s], offsets, off_w[s])
                for k, x in phi.items()}

    return combine


def centralized_combine(phi: Params) -> Params:
    """All agents receive the network centroid: A = (1/K) 1 1ᵀ.  Each agent
    gets its own copy: ``torch.func.jvp`` refuses primals whose elements
    share memory (an expanded view), which the next step's curvature
    products through a convolution take."""
    return {k: x.mean(0, keepdim=True).expand_as(x).contiguous()
            for k, x in phi.items()}


def no_combine(phi: Params) -> Params:
    return phi


# ---------------------------------------------------------------------------
# Kernel backend.  The kernel takes the leaves as they are (ragged widths,
# mixed dtypes: one launch per dtype group).  pack_pytree keeps the JAX
# package's flatten-to-(K, M) layout, which its Pallas kernel needs.
# ---------------------------------------------------------------------------

def pack_pytree(phi: Params, block_m: int = 512
                ) -> tuple[list[torch.Tensor],
                           Callable[[list[torch.Tensor]], Params]]:
    """Pack a dict of (K, ...) leaves into one (K, M_pad) buffer per dtype.

    Leaves are flattened to (K, m_i) and concatenated along the feature dim,
    then zero-padded to :func:`pad_geometry`'s width.  The combine is
    linear and the pad is zero, so padded columns stay zero through the
    kernel and are sliced off on unpack.

    Returns ``(buffers, unpack)`` where ``unpack`` maps same-shaped combined
    buffers back to the original dict.
    """
    if not phi:
        return [], lambda bufs: {}
    names = list(phi)
    K = phi[names[0]].shape[0]
    groups: dict[torch.dtype, list[str]] = {}
    for name in names:
        groups.setdefault(phi[name].dtype, []).append(name)

    buffers: list[torch.Tensor] = []
    for dt, group in groups.items():
        flats = [phi[n].reshape(K, -1) for n in group]
        M = sum(f.shape[1] for f in flats)
        m_pad, _ = pad_geometry(M, block_m)
        if m_pad != M:
            flats.append(flats[0].new_zeros((K, m_pad - M)))
        buffers.append(torch.cat(flats, dim=1) if len(flats) > 1
                       else flats[0].contiguous())

    def unpack(new_buffers: list[torch.Tensor]) -> Params:
        out = {}
        for buf, group in zip(new_buffers, groups.values()):
            off = 0
            for n in group:
                shape = phi[n].shape
                width = int(np.prod(shape[1:], dtype=np.int64))
                out[n] = buf[:, off:off + width].reshape(shape)
                off += width
        return {n: out[n] for n in names}

    return buffers, unpack


def _kernel_apply(A: torch.Tensor, phi: Params) -> Params:
    """One dif_combine launch per dtype group, every leaf in its shape."""
    from repro_torch.kernels.dif_combine.ops import dif_combine_leaves

    return dif_combine_leaves(A, phi) if phi else {}


def make_pallas_combine(A: torch.Tensor) -> CombineFn:
    """The dif_combine kernel over the leaves of ``phi``."""
    return _stepless(functools.partial(_kernel_apply, A))


# ---------------------------------------------------------------------------
# Backend registry + selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CombineBackend:
    """One registered combine implementation: ``build(A=..., device=...)``
    returns a ``CombineFn``; a build function ignores the context keys it
    does not need."""
    name: str
    build: Callable[..., CombineFn]
    needs_matrix: bool = True


_BACKENDS: dict[str, CombineBackend] = {}


def register_backend(name: str, **flags: bool):
    """Decorator: register a combine build function under ``name``."""

    def deco(build: Callable[..., CombineFn]) -> Callable[..., CombineFn]:
        _BACKENDS[name] = CombineBackend(name, build, **flags)
        return build

    return deco


def combine_backends() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def _schedule_row(step, S: int) -> int:
    """The row of an (S, ...) schedule table that ``step`` selects."""
    if step is None:
        if S != 1:
            raise ValueError(
                "a stacked matrix schedule needs the step index: call "
                "combine(phi, step)")
        return 0
    return step % S


def _stepless(fn: Callable[[Params], Params]) -> CombineFn:
    """Adapt a static combine to the ``(phi, step=None)`` surface."""

    def combine(phi: Params, step=None) -> Params:
        return fn(phi)

    return combine


def _stacked(At: torch.Tensor, apply: Callable[[torch.Tensor, Params],
                                               Params]) -> CombineFn:
    """Index a stacked ``(S, K, K)`` schedule with the step (a view of the
    device table, no copy), then run ``apply(A_t, phi)``."""
    S = At.shape[0]

    def combine(phi: Params, step=None) -> Params:
        return apply(At[_schedule_row(step, S)], phi)

    return combine


def _matrix(A, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(A), dtype=torch.float32, device=device)


@register_backend("dense")
def _build_dense(*, A, device, **_ctx) -> CombineFn:
    At = _matrix(A, device)
    if At.ndim == 3:
        return _stacked(At, dense_combine)
    return _stepless(functools.partial(dense_combine, At))


@register_backend("sparse_host")
def _build_sparse_host(*, A, **_ctx) -> CombineFn:
    A = np.asarray(A)
    if A.ndim == 3:
        raise ValueError(
            f"combine backend 'sparse_host' precomputes a static per-offset "
            f"schedule and cannot serve a stacked ({A.shape[0]}-step) "
            f"matrix schedule; use 'sparse_host_dynamic'")
    return _stepless(functools.partial(sparse_combine_host, A))


@register_backend("sparse_host_dynamic")
def _build_sparse_host_dynamic(*, A, device, **_ctx) -> CombineFn:
    return make_sparse_host_dynamic_combine(topology.schedule_ir(np.asarray(A)),
                                            device)


@register_backend("pallas")
def _build_pallas(*, A, device, **_ctx) -> CombineFn:
    At = _matrix(A, device)
    if At.ndim == 3:
        return _stacked(At, _kernel_apply)
    return make_pallas_combine(At)


@register_backend("fused")
def _build_fused(*, A, device, **_ctx) -> CombineFn:
    """Combine-only face of the fused outer backend (the cta pre-mix and
    direct ``make_combine('fused')`` callers): the kernel combine."""
    return _build_pallas(A=A, device=device)


@register_backend("centralized", needs_matrix=False)
def _build_centralized(**_ctx) -> CombineFn:
    return _stepless(centralized_combine)


@register_backend("none", needs_matrix=False)
def _build_none(**_ctx) -> CombineFn:
    return _stepless(no_combine)


def select_backend(A: np.ndarray | None, device) -> str:
    """Pick a backend name from the topology and the device (see the module
    docstring for the rule table)."""
    if A is None:
        return "dense"
    A = np.asarray(A)
    if A.ndim == 3:
        ir = topology.schedule_ir(A)
        if ir.K == 1:
            return "none"
        return "sparse_host_dynamic" if ir.degree < ir.K - 1 else "dense"
    K = A.shape[0]
    if K == 1:
        return "none"
    if len(_circular_offsets(A)) < K - 1:
        return "sparse_host"
    if torch.device(device).type == "cuda":
        return "pallas"
    return "dense"


# Backends able to serve a stacked (S, K, K) schedule with the step.
_STEP_INDEXED_BACKENDS = ("dense", "pallas", "fused", "sparse_host_dynamic")
_DYNAMIC_SIBLING = {"sparse_host": "sparse_host_dynamic"}


def resolve_schedule_backend(backend: str, A) -> str:
    """Route ``backend`` to a stacked-schedule-capable equivalent when ``A``
    is a stacked schedule: ``sparse_host`` upgrades silently to its dynamic
    sibling; a backend with no dynamic form falls back to 'dense', loudly."""
    if (backend != "auto" and A is not None
            and np.asarray(A).ndim == 3
            and backend not in _STEP_INDEXED_BACKENDS):
        b = _BACKENDS.get(backend)
        if b is not None and not b.needs_matrix:
            return backend           # matrix-free (none/centralized): no-op
        sibling = _DYNAMIC_SIBLING.get(backend)
        if sibling is not None:
            return sibling
        warnings.warn(
            f"combine backend {backend!r} cannot step-index a stacked "
            f"({np.asarray(A).shape[0]}-step) matrix schedule; falling back "
            f"to 'dense'", RuntimeWarning, stacklevel=3)
        return "dense"
    return backend


def make_combine(strategy: str, A: np.ndarray | None = None, *,
                 device=None) -> CombineFn:
    """Single entry point: build a combine fn from a backend name or 'auto'.

    ``A`` may be one ``(K, K)`` matrix or a stacked ``(S, K, K)`` schedule.
    ``device`` is where the matrices live and where ``phi`` must be (None:
    the CUDA card, raising if there is none).
    """
    device = resolve_device(device)
    if strategy == "auto":
        strategy = select_backend(A, device)
    backend = _BACKENDS.get(strategy)
    if backend is None:
        raise ValueError(
            f"unknown combine strategy {strategy!r}; "
            f"registered: {combine_backends()}")
    if backend.needs_matrix and A is None:
        raise ValueError(f"{strategy!r} combine needs a matrix A")
    return backend.build(A=A, device=device)


# The reference's combine wire formats: bytes per element of what its
# permute-based backends put on the wire.  The port's backends run on one
# card, so the resolved name is provenance (the run log) only.
WIRE_DTYPES = {"bfloat16": 2, "float32": 4}


def resolve_combine_dtype(outer_dtype: str, override: str | None = None
                          ) -> str:
    """bf16 exactly when the outer (param/grad) dtype is bf16, f32
    otherwise; ``override`` (``--combine-dtype``) wins."""
    chosen = override or ("bfloat16" if outer_dtype == "bfloat16"
                          else "float32")
    if chosen not in WIRE_DTYPES:
        raise ValueError(
            f"combine_dtype {chosen!r} is not a supported wire format; "
            f"pick one of {sorted(WIRE_DTYPES)}")
    return chosen


# ---------------------------------------------------------------------------
# Diffusion steps
# ---------------------------------------------------------------------------

def atc_step(params: Params, updates: Params, combine) -> Params:
    """Adapt-then-Combine (paper eq. 6a-6b): φ = w + u;  w' = A ⊙ φ."""
    return combine({k: p + updates[k] for k, p in params.items()})


def cta_step(params: Params, updates: Params, combine) -> Params:
    """Combine-then-Adapt variant (consensus-flavored)."""
    mixed = combine(params)
    return {k: m + updates[k] for k, m in mixed.items()}


# ---------------------------------------------------------------------------
# Theory metrics
# ---------------------------------------------------------------------------

def centroid(params: Params) -> Params:
    return {k: x.mean(0) for k, x in params.items()}


def disagreement(params: Params) -> torch.Tensor:
    """Network disagreement (Thm 1): (1/K) Σ_k ‖w_k − w_c‖²."""
    leaves = list(params.values())
    K = leaves[0].shape[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        xc = x.mean(0, keepdim=True)
        total = total + torch.sum((x - xc).float() ** 2)
    return total / K

