"""Wrappers, autograd pairing, build and launch counters of the CUDA SSD
scan kernels in ``csrc/ssd_scan.cu`` (port of
``repro/kernels/ssd_scan/ops.py``).

Routing is by the tensors' device and dtype, written out here and never
taken from a failure: CPU tensors go to the plain PyTorch versions in
:mod:`.ref`; bfloat16 CUDA tensors to the three Hopper kernels, one a pass
(:func:`ssd_chunk_state`, :func:`ssd_state_pass`, :func:`ssd_chunk_scan`:
chunk states, states passed across chunks, chunk outputs; the first and
last on the tensor cores); float32 CUDA tensors to the one CUDA-core
kernel.  A CUDA call launches its kernels or raises — there is no
fallback.  The kernels are compiled with ``nvcc`` for ``sm_90a`` at first
use (:mod:`repro_torch.kernels.build`).

The reference expands the B/C groups to heads before its kernel; these
kernels read each head's group instead, with the same results, and the
bfloat16 route forms C·Bᵀ once for all heads of a group.

:func:`ssd_scan` pairs the kernel forward with the VJP of the port's chunked
scan (:func:`.chunked.ssd_scan_vjp`, chunk by chunk) as its backward, in
float32 (the kernel's precision).  The JAX package has no backward kernel either: it
differentiates the jnp chunked scan.  The pairing is a
``torch.autograd.Function`` in the ``setup_context`` form with a ``vmap``
rule that folds the mapped dimension into the batch, so ``torch.func.vmap``
over ``torch.func.grad`` (the serving tier's batched adaptation) reaches the
kernel: a raw-pointer launch cannot see a batched tensor.  The backward is
a ``Function`` of its own, folded the same way; its reverse-mode
derivative raises, its forward-mode rule is below.

Forward mode.  The exact meta-gradient's Hessian-vector products are
``torch.func.jvp`` over ``torch.func.grad``, so both ``Function``s have a
``jvp`` rule, each running a tangent ``Function`` whose ``vmap`` rule folds
the mapped dimensions as above.  The forward's tangent is the kernel T3
(:func:`ssd_scan_tangent`, ``csrc/ssd_scan.cu``, namespace ``jvpk``); the
backward's is ``torch.func.jvp`` of the chunked VJP (PyTorch ops, as the
backward is).  Reverse-over-reverse (``grad`` of ``grad``) still raises.

``launch_counts["ssd_scan"]`` counts the calls of :func:`ssd_scan_kernel`
that went to a kernel route (one launch in float32, three in bfloat16);
``ssd_chunk_state``, ``ssd_state_pass`` and ``ssd_chunk_scan`` count each
pass's launches, ``ssd_scan_tangent`` the tangent kernel's.  Plain-version
calls are not counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.fold import fold, unfold, zeros_for_none
from repro_torch.kernels.ssd_scan.chunked import ssd_scan_vjp
from repro_torch.kernels.ssd_scan.ref import (chunk_scan_ref,
                                              chunk_state_ref, split_hi_lo,
                                              ssd_scan_ref,
                                              ssd_scan_tangent_ref,
                                              state_pass_ref)

__all__ = ["MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "build",
           "launch_counts", "reset_launch_counts", "ssd_chunk_scan",
           "ssd_chunk_state", "ssd_scan", "ssd_scan_kernel",
           "ssd_scan_tangent", "ssd_state_pass"]

MAX_HEAD_DIM = 64         # kMaxP in the CUDA source
MAX_STATE = 128           # kMaxN
MAX_CHUNK = 256           # kMaxChunk
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"ssd_scan": 0, "ssd_chunk_state": 0, "ssd_state_pass": 0,
                 "ssd_chunk_scan": 0, "ssd_scan_tangent": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in ("repro_ssd_max_head_dim", "repro_ssd_max_state",
               "repro_ssd_max_chunk"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
    ll = ctypes.c_longlong
    lib.repro_ssd_scan.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.repro_ssd_chunk_state.argtypes = [p] * 3 + [ll] + [p] * 3 + \
        [i] * 7 + [p]
    lib.repro_ssd_state_pass.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.repro_ssd_chunk_scan.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.repro_ssd_scan_tangent.argtypes = [p] * 12 + [i] * 8 + [p]
    for fn in ("repro_ssd_scan", "repro_ssd_chunk_state",
               "repro_ssd_state_pass", "repro_ssd_chunk_scan",
               "repro_ssd_scan_tangent"):
        getattr(lib, fn).restype = i
    if (lib.repro_ssd_max_head_dim(), lib.repro_ssd_max_state(),
            lib.repro_ssd_max_chunk()) != (MAX_HEAD_DIM, MAX_STATE,
                                           MAX_CHUNK):
        raise RuntimeError("kernel library and wrapper disagree on the "
                           "largest supported head dim, state or chunk")


_LIB = CudaLibrary(SOURCE, "ssd_scan", _declare)


def build() -> dict:
    """Compile (when the source or flags changed) and load the kernel; see
    :meth:`repro_torch.kernels.build.CudaLibrary.build`."""
    return _LIB.build()


def _check_shapes(x, dt, A, Bg, Cg, chunk: int) -> None:
    name = "ssd_scan"
    if x.ndim != 4 or dt.ndim != 3 or Bg.ndim != 4 or Cg.ndim != 4:
        raise ValueError(f"{name}: x, dt, B and C must be (B,L,H,P), "
                         f"(B,L,H), (B,L,G,N), (B,L,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(Bg.shape)}, {tuple(Cg.shape)}")
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    if tuple(dt.shape) != (B, L, H) or tuple(Bg.shape[:2]) != (B, L) or \
            tuple(Cg.shape) != tuple(Bg.shape) or H % G:
        raise ValueError(
            f"{name}: dt {tuple(dt.shape)}, B {tuple(Bg.shape)} and C "
            f"{tuple(Cg.shape)} do not fit x {tuple(x.shape)} (dt must be "
            f"({B}, {L}, {H}), B and C ({B}, {L}, G, N) with G dividing {H})")
    if A is not None and tuple(A.shape) not in ((H,), (B, H)):
        raise ValueError(f"{name}: A has shape {tuple(A.shape)}, expected "
                         f"({H},) or ({B}, {H})")
    if L % chunk:
        raise ValueError(
            f"{name} needs the sequence length to be a multiple of the "
            f"chunk: L={L} % chunk={chunk} = {L % chunk} — pad the sequence "
            f"or pick a chunk dividing it")


def _check_cuda(x, dt, A, Bg, Cg, chunk: int) -> None:
    """What the kernels take: x, B and C in one of float32/bfloat16, dt and
    A float32, all on one card, x, dt, B and C contiguous (A, (H,) or (B,
    H), is read through its strides in bfloat16 and copied into place in
    float32); P <= 64, N <= 128, chunk <= 256."""
    name = "ssd_scan"
    P, N = x.shape[3], Bg.shape[3]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} is not supported by the "
                         f"CUDA kernel; use float32 or bfloat16")
    if P > MAX_HEAD_DIM or N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(
            f"{name}: head dim P={P}, state N={N} and chunk={chunk} must be "
            f"at most {MAX_HEAD_DIM}, {MAX_STATE} and {MAX_CHUNK} for the "
            f"CUDA kernel")
    for tname, t in (("x", x), ("dt", dt), ("A", A), ("B", Bg), ("C", Cg)):
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{x.device}")
        want = torch.float32 if tname in ("dt", "A") else x.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {tname} must be {want}, got "
                             f"{t.dtype}")
        if tname != "A" and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} is not "
                             f"contiguous (strides {t.stride()})")


def _check_hopper(name: str, chunk: int, **tensors) -> None:
    """What the bfloat16 kernels take beyond :func:`_check_cuda`: rows of
    x, B and C (and of every other bf16 operand) 16-byte multiples, P and N
    multiples of 8, data 16-byte aligned (TMA reads and writes them)."""
    for tname, t in tensors.items():
        want = torch.bfloat16 if tname in ("x", "B", "C", "hi", "lo") \
            else torch.float32
        if t.device.type != "cuda" or t.dtype != want:
            raise ValueError(f"{name}: {tname} must be a {want} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if tname != "A" and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} is not "
                             f"contiguous (strides {t.stride()})")
        if tname in ("x", "B", "C", "hi", "lo", "S") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")
    x, Bg = tensors.get("x"), tensors.get("B")
    P = x.shape[3] if x is not None else tensors["S"].shape[3]
    N = Bg.shape[3] if Bg is not None else tensors["S"].shape[4]
    if P % 8 or N % 8 or P > MAX_HEAD_DIM or N > MAX_STATE or \
            chunk > MAX_CHUNK:
        raise ValueError(
            f"{name}: the bfloat16 kernels take a head dim P={P} and state "
            f"N={N} that are multiples of 8, at most {MAX_HEAD_DIM} and "
            f"{MAX_STATE}, and chunk={chunk} at most {MAX_CHUNK}")


def _launch(name: str, entry, *args) -> None:
    """One launch of C entry ``entry``: tensors as their data pointers, the
    current stream last; raises on a refused launch, then counts it."""
    with torch.cuda.device(args[0].device):
        err = entry(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args),
                    torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    launch_counts[name] += 1


def ssd_chunk_state(x, dt, A, Bg, *, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the bfloat16 route: (S (B,nc,H,P,N), seg (B,H,L)), both
    float32, as :func:`.ref.chunk_state_ref` (its plain version, taken for
    CPU tensors).  A: (H,) or per sequence (B,H)."""
    _check_shapes(x, dt, A, Bg, Bg, chunk)
    if x.device.type == "cpu":
        return chunk_state_ref(x, dt, A, Bg, chunk)
    _check_hopper("ssd_chunk_state", chunk, x=x, dt=dt, A=A, B=Bg)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    if A.stride(-1) != 1:
        A = A.contiguous()
    S = torch.empty(B, L // chunk, H, P, N, dtype=torch.float32,
                    device=x.device)
    seg = torch.empty(B, H, L, dtype=torch.float32, device=x.device)
    _launch("ssd_chunk_state", _LIB.lib.repro_ssd_chunk_state, x, dt, A,
            A.stride(0) if A.ndim == 2 else 0, Bg, S, seg, B, L, H, P, G, N,
            chunk)
    return S, seg


def ssd_state_pass(S, seg, *, chunk: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2 of the bfloat16 route: the states entering chunks 1 .. nc-1
    as bf16 planes hi and lo (B,nc-1,H,P,N) whose float32 sum is the state
    (:func:`.ref.split_hi_lo`), and the final state (B,H,P,N) float32; the
    plain version is :func:`.ref.state_pass_ref`, split."""
    B, nc, H, P, N = S.shape
    if tuple(seg.shape) != (B, H, nc * chunk):
        raise ValueError(f"ssd_state_pass: seg {tuple(seg.shape)} does not "
                         f"fit S {tuple(S.shape)} and chunk={chunk}")
    if S.device.type == "cpu":
        entering, state = state_pass_ref(S, seg, chunk)
        return (*split_hi_lo(entering), state)
    _check_hopper("ssd_state_pass", chunk, S=S, seg=seg)
    hi, lo = (torch.empty(B, nc - 1, H, P, N, dtype=torch.bfloat16,
                          device=S.device) for _ in "hl")
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=S.device)
    _launch("ssd_state_pass", _LIB.lib.repro_ssd_state_pass, S, seg, hi, lo,
            state, B, nc * chunk, H, P, N, chunk)
    return hi, lo, state


def ssd_chunk_scan(x, dt, seg, Bg, Cg, hi, lo, *, chunk: int
                   ) -> torch.Tensor:
    """Pass 3 of the bfloat16 route: y (B,L,H,P) in x's dtype from seg
    (pass 1) and the entering states' planes hi and lo (pass 2), as
    :func:`.ref.chunk_scan_ref` of ``hi + lo`` (its plain version)."""
    _check_shapes(x, dt, None, Bg, Cg, chunk)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    want = (B, L // chunk - 1, H, P, N)
    if tuple(seg.shape) != (B, H, L) or tuple(hi.shape) != want or \
            tuple(lo.shape) != want:
        raise ValueError(f"ssd_chunk_scan: seg {tuple(seg.shape)}, hi "
                         f"{tuple(hi.shape)} and lo {tuple(lo.shape)} do not "
                         f"fit x {tuple(x.shape)} (want ({B}, {H}, {L}) and "
                         f"{want})")
    if x.device.type == "cpu":
        return chunk_scan_ref(x, dt, seg, Bg, Cg,
                              hi.float() + lo.float(), chunk)
    _check_hopper("ssd_chunk_scan", chunk, x=x, dt=dt, seg=seg, B=Bg, C=Cg,
                  hi=hi, lo=lo)
    y = torch.empty_like(x)
    _launch("ssd_chunk_scan", _LIB.lib.repro_ssd_chunk_scan, x, dt, seg, Bg,
            Cg, hi, lo, y, B, L, H, P, G, N, chunk)
    return y


def ssd_scan_kernel(x, dt, A, Bg, Cg, *, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,L,H,P); dt: (B,L,H); A: (H,) or per sequence (B,H); Bg/Cg:
    (B,L,G,N) with G dividing H.  Returns (y (B,L,H,P) in x's dtype,
    final_state (B,H,P,N) float32), as the JAX package's
    ``ssd_scan_pallas`` of the head-expanded B and C."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    if x.device.type == "cpu":
        rep = H // G
        y, state = ssd_scan_ref(x, dt, A, Bg.repeat_interleave(rep, dim=2),
                                Cg.repeat_interleave(rep, dim=2))
        return y.to(x.dtype), state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check_cuda(x, dt, A, Bg, Cg, chunk)
    if x.dtype == torch.bfloat16:
        S, seg = ssd_chunk_state(x, dt, A, Bg, chunk=chunk)
        hi, lo, state = ssd_state_pass(S, seg, chunk=chunk)
        y = ssd_chunk_scan(x, dt, seg, Bg, Cg, hi, lo, chunk=chunk)
        launch_counts["ssd_scan"] += 1
        return y, state
    A = A.expand(B, H).contiguous()
    y = torch.empty_like(x)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    _launch("ssd_scan", _LIB.lib.repro_ssd_scan, x, dt, A, Bg, Cg, y, state,
            B, L, H, P, G, N, chunk, _DTYPES[x.dtype])
    return y, state


def ssd_scan_tangent(x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC, *, chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """T3: the tangent (y', final_state') of :func:`ssd_scan_kernel` at
    (x, dt, A, Bg, Cg) along (x', dt', A', B', C') — each tangent shaped
    and typed as its primal (dt, A float32).  y' in x's dtype, the state's
    tangent (B,H,P,N) float32.  The plain version (taken for CPU tensors)
    is :func:`.ref.ssd_scan_tangent_ref`.  One launch, float32 or bfloat16
    inputs, float32 state and tangent state."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    for tname, t, p in (("x'", tx, x), ("dt'", tdt, dt), ("A'", tA, A),
                        ("B'", tB, Bg), ("C'", tC, Cg)):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"ssd_scan_tangent: {tname} has shape "
                             f"{tuple(t.shape)}, expected {tuple(p.shape)}")
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    if x.device.type == "cpu":
        y, state = ssd_scan_tangent_ref(x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC)
        return y.to(x.dtype), state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check_cuda(x, dt, A, Bg, Cg, chunk)
    _check_cuda(tx, tdt, tA, tB, tC, chunk)
    A, tA = (a.expand(B, H).contiguous() for a in (A, tA))
    ty = torch.empty_like(x)
    tstate = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    _launch("ssd_scan_tangent", _LIB.lib.repro_ssd_scan_tangent, x, dt, A,
            Bg, Cg, tx, tdt, tA, tB, tC, ty, tstate, B, L, H, P, G, N, chunk,
            _DTYPES[x.dtype])
    return ty, tstate


# ---------------------------------------------------------------------------
# autograd: kernel forward + the chunked scan's VJP
# ---------------------------------------------------------------------------

def _fold_A(A: torch.Tensor, dim: int | None, n: int, B: int
            ) -> torch.Tensor:
    """A of each mapped call, (H,) or (B, H), as one A per folded
    sequence: (n·B, H)."""
    A = A.expand(n, *A.shape) if dim is None else A.movedim(dim, 0)
    if A.ndim == 2:                                    # (n, H)
        A = A[:, None, :].expand(n, B, A.shape[-1])
    return A.reshape(n * B, A.shape[-1])


def _chunked_vjp(x, dt, A, Bg, Cg, gy, gs, chunk):
    """Gradients of the chunked scan, in float32, at the given inputs."""
    with torch.profiler.record_function("ssd_scan_chunked_bwd"):
        return ssd_scan_vjp(x, dt, A, Bg, Cg, gy, gs, chunk)


def _fold_bwd_call(fn, info, in_dims, tensors, rest):
    """The ``vmap`` rule of a ``Function`` whose tensor inputs are the
    scan's (x, dt, A, B, C, ...) and whose outputs are gradients (or their
    tangents) shaped as (x, dt, A, B, C): every tensor folded (A and, at
    index 9, its tangent by :func:`_fold_A`), one call, and A's result
    summed over each call's sequences where a call's A was (H,)."""
    n = info.batch_size
    B = fold(tensors[0], in_dims[0], n).shape[0] // n
    a_slots = (2, 9)                      # A, and A' when tangents follow
    folded = [_fold_A(t, d, n, B) if i in a_slots else fold(t, d, n)
              for i, (t, d) in enumerate(zip(tensors, in_dims))]
    outs = [unfold(g, n) for g in fn.apply(*folded, *rest)]
    if tensors[2].ndim - (in_dims[2] is not None) == 1:   # each A was (H,)
        outs[2] = outs[2].sum(1)
    return tuple(outs), (0,) * len(outs)


class _SSDScanTangent(torch.autograd.Function):
    """T3 as a ``Function``: the forward's ``jvp`` rule runs below the vmap
    levels, on batched tensors, so the launch goes through this ``vmap``
    rule, which folds them (A and A' by :func:`_fold_A`)."""

    @staticmethod
    def forward(x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC, chunk):
        return ssd_scan_tangent(
            x.contiguous(), dt.float().contiguous(), A.float(),
            Bg.contiguous(), Cg.contiguous(), tx.contiguous(),
            tdt.float().contiguous(), tA.float(), tB.contiguous(),
            tC.contiguous(), chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the SSD scan's tangent kernel is not "
                           "differentiable")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC, chunk):
        n = info.batch_size
        B = fold(x, in_dims[0], n).shape[0] // n
        folded = [_fold_A(t, d, n, B) if i in (2, 7) else fold(t, d, n)
                  for i, (t, d) in enumerate(zip(
                      (x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC), in_dims))]
        y, state = _SSDScanTangent.apply(*folded, chunk)
        return (unfold(y, n), unfold(state, n)), (0, 0)


def _chunked_vjp_tangent(x, dt, A, Bg, Cg, gy, gs, tx, tdt, tA, tB, tC,
                         tgy, tgs, chunk):
    """The tangent of the chunked VJP's gradients: ``torch.func.jvp`` of
    :func:`.chunked.ssd_scan_vjp` (PyTorch ops, as the backward is)."""
    with torch.profiler.record_function("ssd_scan_chunked_bwd_jvp"):
        return torch.func.jvp(
            lambda *a: ssd_scan_vjp(*a, chunk),
            *(tuple(t.contiguous() for t in ts) for ts in (
                (x, dt, A, Bg, Cg, gy, gs),
                (tx, tdt, tA, tB, tC, tgy, tgs))))[1]


class _SSDScanBwdTangent(torch.autograd.Function):
    """The backward's tangent as a ``Function``, folded under ``vmap``."""

    @staticmethod
    def forward(x, dt, A, Bg, Cg, gy, gs, tx, tdt, tA, tB, tC, tgy, tgs,
                chunk):
        return _chunked_vjp_tangent(x, dt, A, Bg, Cg, gy, gs, tx, tdt, tA,
                                    tB, tC, tgy, tgs, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the SSD scan backward's tangent is not "
                           "differentiable")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_bwd_call(_SSDScanBwdTangent, info, in_dims, args[:14],
                              args[14:])


class _SSDScanBwd(torch.autograd.Function):
    """The backward as a ``Function`` of its own, so that under
    ``torch.func.vmap`` it sees folded tensors, like the forward."""

    @staticmethod
    def forward(x, dt, A, Bg, Cg, gy, gs, chunk):
        return _chunked_vjp(x, dt, A, Bg, Cg, gy, gs, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:7])
        ctx.chunk = inputs[7]

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the SSD scan's backward is once-differentiable in reverse mode: "
            "reverse-over-reverse (grad of grad) through ssd_scan is not "
            "supported; forward-over-reverse (jvp of grad) is")

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        return _SSDScanBwdTangent.apply(
            *primals, *zeros_for_none(tangents[:7], primals), ctx.chunk)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bg, Cg, gy, gs, chunk):
        return _fold_bwd_call(_SSDScanBwd, info, in_dims, (x, dt, A, Bg, Cg,
                                                           gy, gs), (chunk,))


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(x, dt, A, Bg, Cg, chunk):
        return ssd_scan_kernel(x.contiguous(), dt.float().contiguous(),
                               A.float(), Bg.contiguous(), Cg.contiguous(),
                               chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bg, Cg, chunk = inputs
        ctx.save_for_backward(x, dt, A, Bg, Cg)
        ctx.save_for_forward(x, dt, A, Bg, Cg)
        ctx.chunk = chunk

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        return _SSDScanTangent.apply(
            *primals, *zeros_for_none(tangents[:5], primals), ctx.chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        x, dt, A, Bg, Cg = ctx.saved_tensors
        grads = _SSDScanBwd.apply(x, dt, A, Bg, Cg, gy, gs, ctx.chunk)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bg, Cg, chunk):
        n = info.batch_size
        fx, fdt, fB, fC = (fold(t, dim, n) for t, dim in
                           zip((x, dt, Bg, Cg), (in_dims[0], in_dims[1],
                                                 in_dims[3], in_dims[4])))
        fA = _fold_A(A, in_dims[2], n, fx.shape[0] // n)
        y, state = _SSDScan.apply(fx, fdt, fA, fB, fC, chunk)
        return (unfold(y, n), unfold(state, n)), (0, 0)


def ssd_scan(x, dt, A, Bg, Cg, *, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-facing layout: x (B,L,H,P), dt (B,L,H), A (H,), Bg/Cg
    (B,L,G,N) group projections.  Returns (y (B,L,H,P) in x's dtype, state
    (B,H,P,N) float32): the kernel on a CUDA tensor (its plain version on a
    CPU tensor), differentiable through the chunked scan's VJP."""
    return _SSDScan.apply(x, dt, A, Bg, Cg, chunk)
