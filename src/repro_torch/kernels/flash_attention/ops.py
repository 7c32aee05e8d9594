"""Wrappers, autograd pairings, build and launch counters of the CUDA
flash-attention kernels in ``csrc/flash_attention.cu``.

Routing is by the tensors' device and dtype, written out here and never
taken from a failure: CPU tensors go to the plain PyTorch versions in
:mod:`.ref`; bfloat16 CUDA tensors to the Hopper kernels (``wgmma``,
TMA), float32 CUDA tensors to the Hopper kernels of namespace ``tf32``
(three TF32 ``mma.sync`` products on the tensor cores for each float32
product: the forward, the backward, T1 and T2).  Both read any view through
its strides, so nothing is copied, transposed or expanded first: K/V keep
their KV heads.  A CUDA call launches its kernel or raises — there is
no fallback.  The kernels are compiled with ``nvcc`` for ``sm_90a`` at first
use (:mod:`repro_torch.kernels.build`).

:func:`flash_attention` is the JAX package's ``ops.py::flash_attention_fused``
pairing in (B, H, S, d): the kernel forward saves ``out`` and the per-row
logsumexp, and the backward is the backward kernel.
:func:`gqa_flash_attention` is the same in the model's layout, q (B, S, H,
d) and k/v (B, S, KV, d) with KV heads not expanded: query head h reads KV
head h / (H / KV), the ``Function`` saves the unexpanded K and V, and the
backward kernel sums dK and dV over each KV head's query heads itself.
Each is a ``torch.autograd.Function`` in the ``setup_context`` form with a
``vmap`` rule that folds the mapped dimension into the batch, so
``torch.func.vmap`` over ``torch.func.grad`` (the serving tier's batched
adaptation) reaches the kernels: a raw-pointer launch cannot see a batched
tensor.  The backward is itself such a ``Function``, so the gradient's
launch is folded the same way.  Its reverse-mode derivative raises;
its forward-mode rule is below.

``launch_counts`` counts kernel launches: one per forward call and two per
backward call (the backward is two kernels, each counted where it is
launched: dQ, which also computes D = rowsum(dO ⊙ O), then dK/dV).  Plain-version calls are not counted.

Forward mode.  The exact meta-gradient's Hessian-vector products are
``torch.func.jvp`` over ``torch.func.grad``, so each forward ``Function``
and each backward ``Function`` has a ``jvp`` rule.  The rule runs a
tangent ``Function`` of its own (:class:`_FwdTangent`, :class:`_BwdTangent`)
whose ``vmap`` rule folds the mapped dimensions like the others, so the
tangent kernels (T1 :func:`flash_attention_fwd_tangent`, T2
:func:`flash_attention_bwd_tangent`, in ``csrc/flash_attention.cu``) see
plain tensors under ``vmap(vmap(jvp(grad)))``.  Both take either layout
(``heads_dim``) and float32 or bfloat16, and count one launch (T1) and two
(T2: dQ', then dK'/dV') in ``launch_counts``.  bfloat16 runs the Hopper
kernels of namespace ``hop`` (``wgmma``, TMA, K/V read unexpanded, the
float32 P, P ⊙ S', P', dS and dS' taken as bf16 hi/lo pairs); T1 and T2
in float32 run on the tensor cores (namespace ``tf32``, 3×TF32, K/V read
unexpanded).
Reverse-over-reverse (``grad`` of ``grad``) still raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.fold import fold, unfold, zeros_for_none
from repro_torch.kernels.flash_attention.ref import (
    flash_bwd_ref, flash_bwd_tangent_ref, flash_fwd_ref,
    flash_fwd_tangent_ref, gqa_flash_bwd_ref, gqa_flash_fwd_ref)

__all__ = ["MAX_HEAD_DIM", "build", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd_lse",
           "gqa_flash_attention", "gqa_flash_attention_bwd",
           "flash_attention_bwd_tangent", "flash_attention_fwd_tangent",
           "gqa_flash_attention_fwd_lse", "launch_counts",
           "reset_launch_counts"]

MAX_HEAD_DIM = 128        # kMaxHeadDim in the CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPES = (torch.float32, torch.bfloat16)   # 3xTF32 mma.sync, wgmma

launch_counts = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "flash_attention_fwd_tangent": 0,
                 "flash_attention_bwd_tangent": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_max_head_dim.argtypes = []
    lib.repro_flash_max_head_dim.restype = i
    st = ctypes.POINTER(ctypes.c_longlong)
    for fn in (lib.repro_flash_fwd_bf16, lib.repro_flash_fwd_f32):
        fn.argtypes = [p] * 5 + [st] + [i] * 6 + [f] + [i] * 3 + [p]
        fn.restype = i
    for fn in (lib.repro_flash_bwd_bf16, lib.repro_flash_bwd_f32):
        fn.argtypes = [p] * 10 + [st] + [i] * 6 + [f] + [i] * 4 + [p]
        fn.restype = i
    lib.repro_flash_fwd_tangent.argtypes = [p] * 9 + [st] + [i] * 6 + [f] + \
        [i] * 3 + [p]
    lib.repro_flash_fwd_tangent.restype = i
    lib.repro_flash_bwd_tangent.argtypes = [p] * 17 + [st] + [i] * 6 + \
        [f] + [i] * 4 + [p]
    lib.repro_flash_bwd_tangent.restype = i
    if lib.repro_flash_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("kernel library and wrapper disagree on the "
                           "largest supported head dim")


_LIB = CudaLibrary(SOURCE, "flash_attention", _declare)


def build() -> dict:
    """Compile (when the source or flags changed) and load the kernels;
    see :meth:`repro_torch.kernels.build.CudaLibrary.build`."""
    return _LIB.build()


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _check_shapes(name: str, q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k and v must be (B, H, S, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, d = q.shape
    if tuple(k.shape[:2]) != (B, H) or k.shape[3] != d or \
            tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"({B}, {H}, S_k, {d}) for q {tuple(q.shape)} (expand GQA heads "
            f"first)")


def _check_cuda(name: str, window: int | None, **tensors) -> None:
    """What the kernels take: one dtype of float32/bfloat16 on one card,
    d <= 128, a window of at least one key."""
    q = tensors["q"]
    d = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} is not supported by the "
                         f"CUDA kernel; use float32 or bfloat16")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim d={d} exceeds the "
                         f"{MAX_HEAD_DIM} the CUDA kernel supports")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window={window} must be at least 1")
    for tname, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{q.device}")
        want = torch.float32 if tname in ("lse", "tlse", "dsum") \
            else q.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {tname} must be {want}, got "
                             f"{t.dtype}")


def _route(name: str, q: torch.Tensor) -> str:
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise ValueError(f"{name}: no kernel for device {q.device}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its head dim has stride 1, as the Hopper kernels
    read it; otherwise a contiguous copy (no caller in the port passes
    one)."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _launch_strided(name: str, entry, pointers, views, heads_dim: int,
                    *args) -> None:
    """One launch of a Hopper kernel that reads strided views: the data
    pointers of ``pointers``, then the (b, s, h) element strides of
    ``views`` (4-d tensors with their heads on axis ``heads_dim``: 1 for
    (B, H, S, d), 2 for (B, S, H, d)), then ``args``, then the ``vec`` flag:
    16-byte tile copies (TMA in bf16, cp.async in float32) when every
    view's rows are 16-byte aligned (pointers and strides) and d a multiple
    of 16 bytes, element by element otherwise."""
    per16 = 16 // views[0].element_size()
    strides, vec = [], views[0].shape[-1] % per16 == 0
    for t in views:
        sb, s1, s2, _ = t.stride()
        bsh = (sb, s2, s1) if heads_dim == 1 else (sb, s1, s2)
        strides += bsh
        vec = vec and t.data_ptr() % 16 == 0 and all(x % per16 == 0
                                                     for x in bsh)
    with torch.cuda.device(views[0].device):
        err = entry(*(t.data_ptr() for t in pointers),
                    (ctypes.c_longlong * len(strides))(*strides), *args,
                    int(vec), torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)


def _dims(t: torch.Tensor, heads_dim: int) -> tuple[int, int]:
    """(heads, sequence) of a 4-d view with its heads on ``heads_dim``."""
    return (t.shape[1], t.shape[2]) if heads_dim == 1 else (t.shape[2],
                                                            t.shape[1])


def _fwd_strided(q, k, v, causal: bool, window: int | None, scale: float,
                 heads_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Hopper forward of either dtype (bf16: ``wgmma``; float32: 3×TF32
    ``mma.sync``), one launch: out in q's axis order and dtype, lse (B, H,
    S) float32; K/V heads as given (H a multiple of KV)."""
    name = "flash_attention_fwd"
    q, k, v = (_strided(t) for t in (q, k, v))
    (H, S), (KV, Sk) = _dims(q, heads_dim), _dims(k, heads_dim)
    B, d = q.shape[0], q.shape[3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    entry = (_LIB.lib.repro_flash_fwd_bf16 if q.dtype == torch.bfloat16
             else _LIB.lib.repro_flash_fwd_f32)
    _launch_strided(name, entry, (q, k, v, out, lse), (q, k, v, out),
                    heads_dim, B, H, KV, S, Sk, d, scale, int(causal),
                    0 if window is None else int(window))
    launch_counts[name] += 1
    return out, lse


def _bwd_strided(q, k, v, out, lse, do, causal: bool, window: int | None,
                 scale: float, heads_dim: int):
    """The Hopper backward of either dtype (bf16: ``wgmma``; float32: 3×TF32
    ``mma.sync``), two launches: dQ (which also writes D = rowsum(dO ⊙ O)
    into a workspace), then dK/dV, summed over each KV head's query heads.
    Reads the views as given (K/V with their KV heads); gradients in their
    inputs' axis order."""
    name = "flash_attention_bwd"
    q, k, v, out, do = (_strided(t) for t in (q, k, v, out, do))
    lse = lse.contiguous()
    (H, S), (KV, Sk) = _dims(q, heads_dim), _dims(k, heads_dim)
    B, d = q.shape[0], q.shape[3]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    views = (q, k, v, out, do, dq, dk, dv)
    entry = (_LIB.lib.repro_flash_bwd_bf16 if q.dtype == torch.bfloat16
             else _LIB.lib.repro_flash_bwd_f32)
    for part in (0, 1):                     # dQ and D, then dK and dV
        _launch_strided(name, entry,
                        (q, k, v, out, do, lse, dsum, dq, dk, dv), views,
                        heads_dim, B, H, KV, S, Sk, d, scale, int(causal),
                        0 if window is None else int(window), part)
        launch_counts[name] += 1
    return dq, dk, dv


def _fwd(q, k, v, causal: bool, window: int | None, scale: float | None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, S, d), lse (B, H, S) float32)."""
    name = "flash_attention_fwd"
    _check_shapes(name, q, k, v)
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    _check_cuda(name, window, q=q, k=k, v=v)
    return _fwd_strided(q, k, v, causal, window, scale, heads_dim=1)


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None):
    """q/k/v: (B, H, S, d) (GQA pre-expanded).  Returns ``out`` (B, H, S, d)
    in q's dtype and the per-row logsumexp (B, H, S, 1) float32, as the JAX
    package's ``flash_attention_fwd_lse``.  ``scale`` defaults to
    1/sqrt(d)."""
    out, lse = _fwd(q, k, v, causal, window, scale)
    return out, lse[..., None]


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None):
    """q/k/v/out/do: (B, H, S, d); lse: (B, H, S).  Returns (dq, dk, dv)
    in the dtypes of (q, k, v).  ``D = rowsum(dO ⊙ O)`` is computed by the
    dQ kernel (jnp outside the kernels in the reference)."""
    name = "flash_attention_bwd"
    _check_shapes(name, q, k, v)
    for tname, t, shape in (("out", out, q.shape), ("do", do, q.shape),
                            ("lse", lse, q.shape[:3])):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return flash_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             window=window, scale=scale)
    _check_cuda(name, window, q=q, k=k, v=v, out=out, do=do, lse=lse)
    return _bwd_strided(q, k, v, out, lse, do, causal, window, scale,
                        heads_dim=1)


# ---------------------------------------------------------------------------
# forward-mode tangents: T1 (of the forward) and T2 (of the backward)
# ---------------------------------------------------------------------------

_TANGENT_VIEWS = ("q", "k", "v", "o", "dout", "tq", "tk", "tv", "to",
                  "tdout", "tdq", "tdk", "tdv")


def _view_strides(heads_dim: int, **views):
    """The (b, s, h) element strides of the 13 views the tangent kernels
    name, in their order (0s for a view a launch does not touch)."""
    out = []
    for name in _TANGENT_VIEWS:
        t = views.get(name)
        if t is None:
            out += (0, 0, 0)
            continue
        sb, s1, s2, _ = t.stride()
        out += (sb, s2, s1) if heads_dim == 1 else (sb, s1, s2)
    return (ctypes.c_longlong * len(out))(*out)


def _layout(name: str, q, k, v, heads_dim: int) -> tuple[int, int, int, int,
                                                         int, int]:
    """(B, H, KV, S, Sk, d) of either layout, checked."""
    if heads_dim == 1:
        _check_shapes(name, q, k, v)
    elif heads_dim == 2:
        _check_gqa(name, q, k, v)
    else:
        raise ValueError(f"{name}: heads_dim must be 1 ((B, H, S, d)) or 2 "
                         f"((B, S, H, d)), got {heads_dim}")
    (H, S), (KV, Sk) = _dims(q, heads_dim), _dims(k, heads_dim)
    return q.shape[0], H, KV, S, Sk, q.shape[3]


def flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv, *,
                                causal: bool = True,
                                window: int | None = None,
                                scale: float | None = None,
                                heads_dim: int = 1):
    """T1: the tangent (o', lse') of the forward ``(out, lse)`` at (q, k,
    v) along (q', k', v'), from the forward's ``lse`` (B, H, S).  Layout
    (B, H, S, d) with ``heads_dim=1`` (heads expanded), (B, S, H, d) with
    K/V (B, S_k, KV, d) unexpanded with ``heads_dim=2``.  o' in q's dtype,
    lse' (B, H, S) float32; one launch (bfloat16 on ``wgmma``, namespace
    ``hop``; float32 as 3×TF32 ``mma.sync``, namespace ``tf32``).  The
    plain version is
    :func:`.ref.flash_fwd_tangent_ref`."""
    name = "flash_attention_fwd_tangent"
    B, H, KV, S, Sk, d = _layout(name, q, k, v, heads_dim)
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return flash_fwd_tangent_ref(q, k, v, tq, tk, tv, causal=causal,
                                     window=window, scale=scale,
                                     heads_dim=heads_dim)
    _check_cuda(name, window, q=q, k=k, v=v, lse=lse, tq=tq, tk=tk, tv=tv)
    q, k, v, tq, tk, tv = (_strided(t) for t in (q, k, v, tq, tk, tv))
    lse = lse.contiguous()
    to = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tlse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    strides = _view_strides(heads_dim, q=q, k=k, v=v, tq=tq, tk=tk, tv=tv,
                            to=to)
    with torch.cuda.device(q.device):
        err = _LIB.lib.repro_flash_fwd_tangent(
            *(t.data_ptr() for t in (q, k, v, lse, tq, tk, tv, to, tlse)),
            strides, B, H, KV, S, Sk, d, scale, int(causal),
            0 if window is None else int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return to, tlse


def flash_attention_bwd_tangent(q, k, v, out, lse, do, tq, tk, tv, tout,
                                tlse, tdo, *, causal: bool = True,
                                window: int | None = None,
                                scale: float | None = None,
                                heads_dim: int = 1):
    """T2: the tangent (dq', dk', dv') of the backward's (dq, dk, dv) at
    (q, k, v, out, lse, dO) along the tangents of all six, in the layout of
    ``heads_dim`` (as :func:`flash_attention_fwd_tangent`); dk' and dv'
    summed over each KV head's query heads.  Two launches: dq' (which also
    writes D and D' into workspaces), then dk'/dv'; bfloat16 on ``wgmma``
    (namespace ``hop``), float32 on 3×TF32 ``mma.sync``, both on the views
    as given.  The plain version is :func:`.ref.flash_bwd_tangent_ref`."""
    name = "flash_attention_bwd_tangent"
    B, H, KV, S, Sk, d = _layout(name, q, k, v, heads_dim)
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                     tout, tlse, tdo, causal=causal,
                                     window=window, scale=scale,
                                     heads_dim=heads_dim)
    _check_cuda(name, window, q=q, k=k, v=v, out=out, do=do, lse=lse, tq=tq,
                tk=tk, tv=tv, tout=tout, tlse=tlse, tdo=tdo)
    q, k, v, out, do, tq, tk, tv, tout, tdo = (
        _strided(t) for t in (q, k, v, out, do, tq, tk, tv, tout, tdo))
    lse, tlse = lse.contiguous(), tlse.contiguous()
    tdq, tdk, tdv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (q, k, v))
    dsum, tdsum = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
                   for _ in "DD")
    strides = _view_strides(heads_dim, q=q, k=k, v=v, o=out, dout=do, tq=tq,
                            tk=tk, tv=tv, to=tout, tdout=tdo, tdq=tdq,
                            tdk=tdk, tdv=tdv)
    ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse, tq, tk, tv, tout,
                                   tdo, tlse, dsum, tdsum, tdq, tdk, tdv)]
    for part in (0, 1):                     # dq' with D and D', then dk'/dv'
        with torch.cuda.device(q.device):
            err = _LIB.lib.repro_flash_bwd_tangent(
                *ptrs, strides, B, H, KV, S, Sk, d, scale, int(causal),
                0 if window is None else int(window), part,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        raise_on(err, name)
        launch_counts[name] += 1
    return tdq, tdk, tdv


class _FwdTangent(torch.autograd.Function):
    """T1 as a ``Function``: a forward ``Function``'s ``jvp`` rule runs
    below the vmap levels, on batched tensors, so the launch goes through
    this ``vmap`` rule, which folds them."""

    @staticmethod
    def forward(q, k, v, lse, tq, tk, tv, causal, window, scale, heads_dim):
        return flash_attention_fwd_tangent(
            q, k, v, lse, tq, tk, tv, causal=causal, window=window,
            scale=scale, heads_dim=heads_dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the flash-attention tangent kernels are not "
                           "differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, v, lse, tq, tk, tv, causal, window, scale,
             heads_dim):
        n = info.batch_size
        args = [fold(t, dim, n) for t, dim in
                zip((q, k, v, lse, tq, tk, tv), in_dims[:7])]
        to, tlse = _FwdTangent.apply(*args, causal, window, scale, heads_dim)
        return (unfold(to, n), unfold(tlse, n)), (0, 0)


class _BwdTangent(torch.autograd.Function):
    """T2 as a ``Function``, folded under ``vmap`` like :class:`_FwdTangent`."""

    @staticmethod
    def forward(q, k, v, out, lse, do, tq, tk, tv, tout, tlse, tdo, causal,
                window, scale, heads_dim):
        return flash_attention_bwd_tangent(
            q, k, v, out, lse, do, tq, tk, tv, tout, tlse, tdo,
            causal=causal, window=window, scale=scale, heads_dim=heads_dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the flash-attention tangent kernels are not "
                           "differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        n = info.batch_size
        folded = [fold(t, dim, n) for t, dim in zip(args[:12], in_dims[:12])]
        grads = _BwdTangent.apply(*folded, *args[12:])
        return tuple(unfold(g, n) for g in grads), (0, 0, 0)


def _save(ctx, inputs, output) -> None:
    """What both forward ``Function``s keep: (q, k, v, out, lse) for the
    backward, (q, k, v, lse) for the ``jvp`` rule.  lse stays
    differentiable in forward mode, since the backward's tangent reads
    lse'; its reverse-mode gradient is never materialized."""
    q, k, v, causal, window, scale = inputs
    out, lse = output
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.save_for_forward(q, k, v, lse)
    ctx.causal, ctx.window, ctx.scale = causal, window, scale


def _no_lse_grad(g_lse) -> None:
    if g_lse is not None:
        raise RuntimeError("the flash-attention logsumexp output has no "
                           "reverse-mode gradient: use the attention output")


def _fwd_jvp(ctx, tangents, heads_dim: int):
    q, k, v, lse = ctx.saved_tensors
    tq, tk, tv = zeros_for_none(tangents, (q, k, v))
    return _FwdTangent.apply(q, k, v, lse, tq, tk, tv, ctx.causal,
                             ctx.window, ctx.scale, heads_dim)


def _bwd_jvp(ctx, tangents, heads_dim: int):
    primals = ctx.saved_tensors
    return _BwdTangent.apply(*primals, *zeros_for_none(tangents, primals),
                             ctx.causal, ctx.window, ctx.scale, heads_dim)


# ---------------------------------------------------------------------------
# autograd: kernel forward + kernel backward
# ---------------------------------------------------------------------------

class _FlashAttentionBwd(torch.autograd.Function):
    """The backward kernel as a ``Function`` of its own, so that under
    ``torch.func.vmap`` its launch is folded like the forward's."""

    @staticmethod
    def forward(q, k, v, out, lse, do, causal, window, scale):
        return flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:6])
        ctx.causal, ctx.window, ctx.scale = inputs[6:]

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the flash-attention backward is once-differentiable in reverse "
            "mode: reverse-over-reverse (grad of grad) through "
            "flash_attention is not supported; forward-over-reverse (jvp of "
            "grad) runs the tangent kernels")

    @staticmethod
    def jvp(ctx, tq, tk, tv, tout, tlse, tdo, *_):
        return _bwd_jvp(ctx, (tq, tk, tv, tout, tlse, tdo), heads_dim=1)

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, do, causal, window, scale):
        n = info.batch_size
        args = [fold(t, dim, n)
                for t, dim in zip((q, k, v, out, lse, do), in_dims[:6])]
        grads = _FlashAttentionBwd.apply(*args, causal, window, scale)
        return tuple(unfold(g, n) for g in grads), (0, 0, 0)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return _fwd(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save(ctx, inputs, output)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if g_out is None:
            return None, None, None, None, None, None
        _no_lse_grad(g_lse)
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, g_out,
                                              ctx.causal, ctx.window,
                                              ctx.scale)
        return dq, dk, dv, None, None, None

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        return _fwd_jvp(ctx, (tq, tk, tv), heads_dim=1)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size
        args = [fold(t, dim, n) for t, dim in zip((q, k, v), in_dims[:3])]
        out, lse = _FlashAttention.apply(*args, causal, window, scale)
        return (unfold(out, n), unfold(lse, n)), (0, 0)


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q/k/v: (B, H, S, d) (GQA pre-expanded) → (B, H, S, d), differentiable
    in q, k and v through the backward kernel."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)[0]


# ---------------------------------------------------------------------------
# the model's layout: q (B, S, H, d), k/v (B, S, KV, d), KV heads unexpanded
# ---------------------------------------------------------------------------

def _check_gqa(name: str, q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q must be (B, S, H, d) and k, v (B, S_k, "
                         f"KV, d); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or tuple(v.shape) != \
            tuple(k.shape) or H % k.shape[2]:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"({B}, S_k, KV, {d}) with {H} query heads a multiple of KV, for "
            f"q {tuple(q.shape)}")


def gqa_flash_attention_fwd_lse(q, k, v, causal: bool = True,
                                window: int | None = None,
                                scale: float | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, H, d); k/v: (B, S_k, KV, d), KV heads not expanded.
    Returns ``out`` (B, S, H, d) in q's dtype and the per-row logsumexp
    (B, H, S) float32."""
    name = "flash_attention_fwd"
    _check_gqa(name, q, k, v)
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return gqa_flash_fwd_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    _check_cuda(name, window, q=q, k=k, v=v)
    return _fwd_strided(q, k, v, causal, window, scale, heads_dim=2)


def gqa_flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None):
    """The model layout's backward: q/out/do (B, S, H, d), k/v (B, S_k, KV,
    d), lse (B, H, S).  Returns (dq (B, S, H, d), dk and dv (B, S_k, KV,
    d)), dk and dv summed over each KV head's query heads."""
    name = "flash_attention_bwd"
    _check_gqa(name, q, k, v)
    scale = _scale(q, scale)
    if _route(name, q) == "cpu":
        return gqa_flash_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                 window=window, scale=scale)
    _check_cuda(name, window, q=q, k=k, v=v, out=out, do=do, lse=lse)
    return _bwd_strided(q, k, v, out, lse, do, causal, window, scale,
                        heads_dim=2)


class _GQAFlashAttentionBwd(torch.autograd.Function):
    """The model layout's backward kernels as a ``Function``, folded under
    ``torch.func.vmap`` like the forward."""

    @staticmethod
    def forward(q, k, v, out, lse, do, causal, window, scale):
        return gqa_flash_attention_bwd(q, k, v, out, lse, do, causal, window,
                                       scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:6])
        ctx.causal, ctx.window, ctx.scale = inputs[6:]

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the flash-attention backward is once-differentiable in reverse "
            "mode: reverse-over-reverse (grad of grad) through "
            "gqa_flash_attention is not supported; forward-over-reverse "
            "(jvp of grad) runs the tangent kernels")

    @staticmethod
    def jvp(ctx, tq, tk, tv, tout, tlse, tdo, *_):
        return _bwd_jvp(ctx, (tq, tk, tv, tout, tlse, tdo), heads_dim=2)

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, do, causal, window, scale):
        n = info.batch_size
        args = [fold(t, dim, n)
                for t, dim in zip((q, k, v, out, lse, do), in_dims[:6])]
        grads = _GQAFlashAttentionBwd.apply(*args, causal, window, scale)
        return tuple(unfold(g, n) for g in grads), (0, 0, 0)


class _GQAFlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return gqa_flash_attention_fwd_lse(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save(ctx, inputs, output)                   # K and V unexpanded

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if g_out is None:
            return None, None, None, None, None, None
        _no_lse_grad(g_lse)
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _GQAFlashAttentionBwd.apply(q, k, v, out, lse, g_out,
                                                 ctx.causal, ctx.window,
                                                 ctx.scale)
        return dq, dk, dv, None, None, None

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        return _fwd_jvp(ctx, (tq, tk, tv), heads_dim=2)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size
        args = [fold(t, dim, n) for t, dim in zip((q, k, v), in_dims[:3])]
        out, lse = _GQAFlashAttention.apply(*args, causal, window, scale)
        return (unfold(out, n), unfold(lse, n)), (0, 0)


def gqa_flash_attention(q, k, v, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, S, KV, d) with H a multiple of KV → (B, S,
    H, d), differentiable in q, k and v (dk, dv as (B, S, KV, d)): the JAX
    package's GQA wrapper, without expanding K/V or moving the heads."""
    return _GQAFlashAttention.apply(q, k, v, causal, window, scale)[0]
