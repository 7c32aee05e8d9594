"""Wrappers, autograd pairing, build and launch counters of the CUDA
flash-attention kernels in ``csrc/flash_attention.cu``.

Routing is by the tensors' device, nothing else: CPU tensors go to the plain
PyTorch versions in :mod:`.ref`; CUDA tensors launch the kernel or raise —
there is no fallback.  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use (:mod:`repro_torch.kernels.build`).

:func:`flash_attention` is the JAX package's ``ops.py::flash_attention_fused``
pairing: the kernel forward saves ``out`` and the per-row logsumexp, and the
backward is the backward kernel.  It is a ``torch.autograd.Function`` in the
``setup_context`` form with a ``vmap`` rule that folds the mapped dimension
into the batch, so ``torch.func.vmap`` over ``torch.func.grad`` (the serving
tier's batched adaptation) reaches the kernels: a raw-pointer launch cannot
see a batched tensor.  The backward is itself such a ``Function``, so the
gradient's launch is folded the same way.  It is single-use: serving adapts
first-order, and differentiating the backward raises.

``launch_counts`` counts kernel launches: one per forward call and two per
backward call (the backward is two kernels, dK/dV and then dQ, each counted
where it is launched).  Plain-version calls are not counted.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.fold import fold, unfold
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref)

__all__ = ["MAX_HEAD_DIM", "build", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd_lse",
           "gqa_flash_attention", "launch_counts", "reset_launch_counts"]

MAX_HEAD_DIM = 128        # kMaxHeadDim in the CUDA source
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_max_head_dim.argtypes = []
    lib.repro_flash_max_head_dim.restype = i
    lib.repro_flash_fwd.argtypes = [p] * 5 + [i] * 4 + [f] + [i] * 3 + [p]
    lib.repro_flash_fwd.restype = i
    lib.repro_flash_bwd.argtypes = [p] * 9 + [i] * 4 + [f] + [i] * 4 + [p]
    lib.repro_flash_bwd.restype = i
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
            0 if window is None else int(window), _DTYPES[q.dtype],
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
    in the dtypes of (q, k, v).  ``D = rowsum(dO ⊙ O)`` is one PyTorch
    reduction here, as it is jnp outside the kernels in the reference."""
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
                int(causal), 0 if window is None else int(window),
                _DTYPES[q.dtype], part,
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


def gqa_flash_attention(q, k, v, **kw) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, S, KV, d) — the model-layout wrapper
    (GQA expansion + transposes), as the JAX package's."""
    H, KV = q.shape[2], k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return out.transpose(1, 2)
