"""Wrappers, autograd pairings, build and launch counters of the CUDA
flash-attention kernels in ``csrc/flash_attention.cu``.

Routing is by the tensors' device and dtype, written out here and never
taken from a failure: CPU tensors go to the plain PyTorch versions in
:mod:`.ref`; bfloat16 CUDA tensors to the Hopper kernels (``wgmma``,
``cp.async``), which read any view through its strides, so nothing is
copied, transposed or expanded first; float32 CUDA tensors to the float32
kernels on the CUDA cores, which take contiguous (B, H, S, d) with heads
expanded.  A CUDA call launches its kernel or raises — there is no
fallback.  The kernels are compiled with ``nvcc`` for ``sm_90a`` at first
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
launch is folded the same way.  It is single-use: serving adapts
first-order, and differentiating the backward raises.

``launch_counts`` counts kernel launches: one per forward call and two per
backward call (the backward is two kernels, each counted where it is
launched: in bfloat16 dQ, which also computes D = rowsum(dO ⊙ O), then
dK/dV; in float32 dK/dV, then dQ).  Plain-version calls are not counted.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.fold import fold, unfold
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref,
                                                     gqa_flash_bwd_ref,
                                                     gqa_flash_fwd_ref)

__all__ = ["MAX_HEAD_DIM", "build", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd_lse",
           "gqa_flash_attention", "gqa_flash_attention_bwd",
           "gqa_flash_attention_fwd_lse", "launch_counts",
           "reset_launch_counts"]

MAX_HEAD_DIM = 128        # kMaxHeadDim in the CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPES = (torch.float32, torch.bfloat16)   # CUDA-core, Hopper kernels

launch_counts = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_max_head_dim.argtypes = []
    lib.repro_flash_max_head_dim.restype = i
    lib.repro_flash_fwd.argtypes = [p] * 5 + [i] * 4 + [f] + [i] * 2 + [p]
    lib.repro_flash_fwd.restype = i
    lib.repro_flash_bwd.argtypes = [p] * 9 + [i] * 4 + [f] + [i] * 3 + [p]
    lib.repro_flash_bwd.restype = i
    st = ctypes.POINTER(ctypes.c_longlong)
    lib.repro_flash_fwd_bf16.argtypes = [p] * 5 + [st] + [i] * 6 + [f] + \
        [i] * 3 + [p]
    lib.repro_flash_fwd_bf16.restype = i
    lib.repro_flash_bwd_bf16.argtypes = [p] * 10 + [st] + [i] * 6 + [f] + \
        [i] * 4 + [p]
    lib.repro_flash_bwd_bf16.restype = i
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
        want = torch.float32 if tname in ("lse", "dsum") else q.dtype
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


def _launch_bf16(name: str, entry, pointers, views, heads_dim: int,
                 *args) -> None:
    """One launch of a bf16 Hopper kernel: the data pointers of
    ``pointers``, then the (b, s, h) element strides of ``views`` (4-d
    tensors with their heads on axis ``heads_dim``: 1 for (B, H, S, d), 2
    for (B, S, H, d)), then ``args``, then the ``vec`` flag: TMA when every
    view's rows are 16-byte aligned (pointers and strides) and d % 8 == 0,
    element by element otherwise."""
    strides, vec = [], views[0].shape[-1] % 8 == 0
    for t in views:
        sb, s1, s2, _ = t.stride()
        bsh = (sb, s2, s1) if heads_dim == 1 else (sb, s1, s2)
        strides += bsh
        vec = vec and t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in bsh)
    with torch.cuda.device(views[0].device):
        err = entry(*(t.data_ptr() for t in pointers),
                    (ctypes.c_longlong * len(strides))(*strides), *args,
                    int(vec), torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)


def _dims(t: torch.Tensor, heads_dim: int) -> tuple[int, int]:
    """(heads, sequence) of a 4-d view with its heads on ``heads_dim``."""
    return (t.shape[1], t.shape[2]) if heads_dim == 1 else (t.shape[2],
                                                            t.shape[1])


def _fwd_bf16(q, k, v, causal: bool, window: int | None, scale: float,
              heads_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Hopper forward: out in q's axis order and dtype, lse (B, H, S)
    float32; K/V heads as given (H a multiple of KV)."""
    name = "flash_attention_fwd"
    q, k, v = (_strided(t) for t in (q, k, v))
    (H, S), (KV, Sk) = _dims(q, heads_dim), _dims(k, heads_dim)
    B, d = q.shape[0], q.shape[3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    _launch_bf16(name, _LIB.lib.repro_flash_fwd_bf16, (q, k, v, out, lse),
                 (q, k, v, out), heads_dim, B, H, KV, S, Sk, d, scale,
                 int(causal), 0 if window is None else int(window))
    launch_counts[name] += 1
    return out, lse


def _bwd_bf16(q, k, v, out, lse, do, causal: bool, window: int | None,
              scale: float, heads_dim: int):
    """The Hopper backward, two launches: dQ (which also writes D =
    rowsum(dO ⊙ O) into a workspace), then dK/dV, summed over each KV
    head's query heads.  Gradients in their inputs' axis order."""
    name = "flash_attention_bwd"
    q, k, v, out, do = (_strided(t) for t in (q, k, v, out, do))
    lse = lse.contiguous()
    (H, S), (KV, Sk) = _dims(q, heads_dim), _dims(k, heads_dim)
    B, d = q.shape[0], q.shape[3]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    views = (q, k, v, out, do, dq, dk, dv)
    for part in (0, 1):                     # dQ and D, then dK and dV
        _launch_bf16(name, _LIB.lib.repro_flash_bwd_bf16,
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
    if q.dtype == torch.bfloat16:
        return _fwd_bf16(q, k, v, causal, window, scale, heads_dim=1)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, S, d = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    lib = _LIB.lib
    with torch.cuda.device(q.device):
        err = lib.repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, S, Sk, d, scale, int(causal),
            0 if window is None else int(window),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return out, lse


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
    in the dtypes of (q, k, v).  ``D = rowsum(dO ⊙ O)``: in bfloat16 the dQ
    kernel computes it; in float32 it is one PyTorch reduction here, as it
    is jnp outside the kernels in the reference."""
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
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, out, lse, do, causal, window, scale,
                         heads_dim=1)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = lse.contiguous()
    dsum = (do.float() * out.float()).sum(-1).contiguous()
    B, H, S, d = q.shape
    Sk = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _LIB.lib
    for part in (0, 1):                     # dK and dV, then dQ
        with torch.cuda.device(q.device):
            err = lib.repro_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B * H, S, Sk, d, scale,
                int(causal), 0 if window is None else int(window), part,
                torch.cuda.current_stream().cuda_stream)
        raise_on(err, name)
        launch_counts[name] += 1
    return dq, dk, dv


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
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the flash-attention backward is once-differentiable: second-"
            "order gradients through flash_attention are not supported")

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
        q, k, v, causal, window, scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, g_out,
                                              ctx.causal, ctx.window,
                                              ctx.scale)
        return dq, dk, dv, None, None, None

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


def _expand_heads(k: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, KV, d) → (B, H, S, d) with KV heads repeated: what the
    float32 kernels take."""
    return k.repeat_interleave(H // k.shape[2], dim=2).transpose(1, 2)


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
    if q.dtype == torch.bfloat16:
        return _fwd_bf16(q, k, v, causal, window, scale, heads_dim=2)
    H = q.shape[2]
    out, lse = _fwd(q.transpose(1, 2), _expand_heads(k, H),
                    _expand_heads(v, H), causal, window, scale)
    return out.transpose(1, 2), lse


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
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, out, lse, do, causal, window, scale,
                         heads_dim=2)
    B, _, H, d = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    dq, dk, dv = flash_attention_bwd(
        q.transpose(1, 2), _expand_heads(k, H), _expand_heads(v, H),
        out.transpose(1, 2), lse, do.transpose(1, 2), causal=causal,
        window=window, scale=scale)

    def per_kv_head(g):
        return g.reshape(B, KV, H // KV, Sk, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), per_kv_head(dk), per_kv_head(dv)


class _GQAFlashAttentionBwd(torch.autograd.Function):
    """The model layout's backward kernels as a ``Function``, folded under
    ``torch.func.vmap`` like the forward."""

    @staticmethod
    def forward(q, k, v, out, lse, do, causal, window, scale):
        return gqa_flash_attention_bwd(q, k, v, out, lse, do, causal, window,
                                       scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the flash-attention backward is once-differentiable: second-"
            "order gradients through gqa_flash_attention are not supported")

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
        q, k, v, causal, window, scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)   # no zeros for lse's gradient
        ctx.save_for_backward(q, k, v, out, lse)     # K and V unexpanded
        ctx.causal, ctx.window, ctx.scale = causal, window, scale

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if g_out is None:
            return None, None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _GQAFlashAttentionBwd.apply(q, k, v, out, lse, g_out,
                                                 ctx.causal, ctx.window,
                                                 ctx.scale)
        return dq, dk, dv, None, None, None

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
