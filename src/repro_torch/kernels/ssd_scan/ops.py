"""Wrappers, autograd pairing, build and launch counters of the CUDA SSD
scan kernels in ``csrc/ssd_scan.cu`` (port of
``repro/kernels/ssd_scan/ops.py``).

Routing is by the tensors' device and dtype, written out here and never
taken from a failure: CPU tensors go to the plain PyTorch versions in
:mod:`.ref`; CUDA tensors to three Hopper kernels, one a pass (chunk
states, states passed across chunks, chunk outputs; the first and last on
the tensor cores): bfloat16 to :func:`ssd_chunk_state`,
:func:`ssd_state_pass`, :func:`ssd_chunk_scan` (``wgmma``, namespace
``hop``), float32 to :func:`ssd_f32_chunk_state`,
:func:`ssd_f32_state_pass`, :func:`ssd_f32_chunk_scan` (three TF32
``mma.sync`` products a product, namespace ``tfs``).  A CUDA call
launches its kernels or raises — there is no fallback.  The kernels are
compiled with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`).

The reference expands the B/C groups to heads before its kernel; these
kernels read each head's group instead, with the same results, and the
bfloat16 route forms C·Bᵀ once for all heads of a block's group.

:func:`ssd_scan` pairs the kernel forward with a float32 backward (the
kernel's precision; below).  The JAX package has no backward kernel: it
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
the mapped dimensions as above.  The forward's tangent is T3
(:func:`ssd_scan_tangent`, ``csrc/ssd_scan.cu``), routed by dtype as the
forward is: bfloat16 CUDA tensors to three Hopper kernels, one a pass, the
forward's passes with the tangent plane beside each
(:func:`ssd_tangent_state`, :func:`ssd_tangent_pass`,
:func:`ssd_tangent_scan`; namespace ``t3``), float32 CUDA tensors to one
CUDA-core kernel (namespace ``jvpk``).  Reverse-over-reverse (``grad`` of
``grad``) still raises.

The backward.  On a CPU tensor it is the chunked scan's VJP
(:func:`.chunked.ssd_scan_vjp`, chunk by chunk) and its tangent
``torch.func.jvp`` of that.  On a CUDA tensor it is :func:`ssd_scan_bwd`,
launches of ``csrc/ssd_bwd.cu``, and its tangent
:func:`ssd_scan_bwd_tangent`, the same passes on dual numbers.  Three
wrappers, one a pass, carry the work, each with its plain version in
:mod:`.ref` (taken for CPU tensors): :func:`ssd_bwd_state` (each chunk's
own state and state cotangent), :func:`ssd_bwd_pass` (the states carried
forward, their cotangents back) and :func:`ssd_bwd_chunk` (each chunk's
gradients: the chunk kernel, then the finish and reduce kernels), and
their tangent twins.  bfloat16 runs the Hopper kernels (namespace ``hbw``:
``wgmma`` and TMA, float32 intermediates as hi/lo bf16 pairs, and a gram
launch before the chunk kernel that forms C·Bᵀ once per group: six
launches).  float32 runs hbw's design on the tensor cores with every
product as three TF32 ``mma.sync`` products (namespace ``tbw``, the same
six launches, in the backward and in its tangent).  The state passing is
one kernel of every route (``ssd::pass_kernel``,
``ssd::tangent_pass_kernel``).

``launch_counts["ssd_scan"]`` counts the calls of :func:`ssd_scan_kernel`
that went to a kernel route (three launches each);
``ssd_chunk_state``, ``ssd_state_pass`` and ``ssd_chunk_scan`` count each
bfloat16 pass's launches, ``ssd_f32_chunk_state``, ``ssd_f32_state_pass``
and ``ssd_f32_chunk_scan`` each float32 pass's.  ``ssd_scan_tangent``
counts the calls of :func:`ssd_scan_tangent` that went to a kernel route
(one launch in float32, three in bfloat16), and ``ssd_tangent_state``,
``ssd_tangent_pass`` and ``ssd_tangent_scan`` each of T3's passes.
``ssd_scan_bwd`` and ``ssd_scan_bwd_tangent`` count the calls of
:func:`ssd_scan_bwd` and :func:`ssd_scan_bwd_tangent`, and
``ssd_bwd_state``, ``ssd_bwd_pass``, ``ssd_bwd_gram``,
``ssd_bwd_chunk``, ``ssd_bwd_finish``, ``ssd_bwd_reduce`` and their
``ssd_bwd_tangent_*`` twins each of their kernels' launches.
Plain-version calls are not counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.fold import fold, unfold, zeros_for_none
from repro_torch.kernels.ssd_scan.chunked import ssd_scan_vjp
from repro_torch.kernels.ssd_scan.ref import (
    bwd_chunk_ref, bwd_state_pass_ref, bwd_state_ref, chunk_scan_ref,
    chunk_state_ref, split_hi_lo, ssd_scan_ref, ssd_scan_tangent_ref,
    state_pass_ref, tangent_bwd_chunk_ref, tangent_bwd_state_pass_ref,
    tangent_bwd_state_ref, tangent_pass_ref, tangent_scan_ref,
    tangent_state_ref)

__all__ = ["BWD_LIB", "MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "build",
           "launch_counts", "reset_launch_counts", "ssd_bwd_chunk",
           "ssd_bwd_pass", "ssd_bwd_state", "ssd_bwd_tangent_chunk",
           "ssd_bwd_tangent_pass", "ssd_bwd_tangent_state",
           "ssd_chunk_scan", "ssd_chunk_state", "ssd_f32_chunk_scan",
           "ssd_f32_chunk_state", "ssd_f32_scan_heads",
           "ssd_f32_state_pass", "ssd_scan",
           "ssd_scan_bwd",
           "ssd_scan_bwd_tangent", "ssd_scan_kernel", "ssd_scan_tangent",
           "ssd_state_pass", "ssd_tangent_pass", "ssd_tangent_scan",
           "ssd_tangent_state"]

MAX_HEAD_DIM = 64         # kMaxP in the CUDA source
MAX_STATE = 128           # kMaxN
MAX_CHUNK = 256           # kMaxChunk
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = SOURCE.with_name("ssd_bwd.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the backward's kernels by pass id of the C entry (the gram kernel is
# launched before chunk)
BWD_PASSES = ("state", "pass", "chunk", "finish", "reduce", "gram")
# the float32 forward's passes (launch-count keys)
F32_PASSES = ("ssd_f32_chunk_state", "ssd_f32_state_pass",
              "ssd_f32_chunk_scan")
launch_counts = {"ssd_scan": 0, "ssd_chunk_state": 0, "ssd_state_pass": 0,
                 "ssd_chunk_scan": 0, **{k: 0 for k in F32_PASSES},
                 "ssd_scan_tangent": 0,
                 "ssd_tangent_state": 0, "ssd_tangent_pass": 0,
                 "ssd_tangent_scan": 0, "ssd_scan_bwd": 0,
                 "ssd_scan_bwd_tangent": 0,
                 **{f"ssd_bwd_{p}": 0 for p in BWD_PASSES},
                 **{f"ssd_bwd_tangent_{p}": 0 for p in BWD_PASSES}}


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
    lib.repro_ssd_f32_chunk_state.argtypes = [p] * 3 + [ll] + [p] * 3 + \
        [i] * 7 + [p]
    lib.repro_ssd_f32_state_pass.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.repro_ssd_f32_chunk_scan.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.repro_ssd_f32_scan_heads.argtypes = [i] * 5
    lib.repro_ssd_chunk_state.argtypes = [p] * 3 + [ll] + [p] * 3 + \
        [i] * 7 + [p]
    lib.repro_ssd_state_pass.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.repro_ssd_chunk_scan.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.repro_ssd_scan_tangent.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.repro_ssd_tangent_state.argtypes = [p] * 3 + [ll] + [p] * 4 + \
        [ll] + [p] * 5 + [i] * 7 + [p]
    lib.repro_ssd_tangent_pass.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.repro_ssd_tangent_scan.argtypes = [p] * 15 + [i] * 7 + [p]
    for fn in ("repro_ssd_f32_chunk_state", "repro_ssd_f32_state_pass",
               "repro_ssd_f32_chunk_scan", "repro_ssd_f32_scan_heads",
               "repro_ssd_chunk_state",
               "repro_ssd_state_pass", "repro_ssd_chunk_scan",
               "repro_ssd_scan_tangent", "repro_ssd_tangent_state",
               "repro_ssd_tangent_pass", "repro_ssd_tangent_scan"):
        getattr(lib, fn).restype = i
    if (lib.repro_ssd_max_head_dim(), lib.repro_ssd_max_state(),
            lib.repro_ssd_max_chunk()) != (MAX_HEAD_DIM, MAX_STATE,
                                           MAX_CHUNK):
        raise RuntimeError("kernel library and wrapper disagree on the "
                           "largest supported head dim, state or chunk")


_LIB = CudaLibrary(SOURCE, "ssd_scan", _declare)

# The C entry's pointer slots, in the order of ssd::Slot in ssd_bwd.cu: each
# tensor's value plane, then its tangent plane.
_BWD_TENSORS = ("x", "gy", "B", "C", "dt", "A", "gs", "seg", "S", "Lc",
                "s_in", "gO", "sg", "dBh", "dCh", "ddd", "dsk", "dsq", "tk",
                "dAp", "dx", "dB", "dC", "ddt", "dA", "gram")


def _declare_bwd(lib: ctypes.CDLL) -> None:
    for fn in ("repro_ssd_bwd_slots", "repro_ssd_bwd_max_head_dim",
               "repro_ssd_bwd_max_state", "repro_ssd_bwd_max_chunk"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_bwd_launch.argtypes = [i, i, i, p, p, p]
    lib.repro_ssd_bwd_launch.restype = i
    if (lib.repro_ssd_bwd_slots(), lib.repro_ssd_bwd_max_head_dim(),
            lib.repro_ssd_bwd_max_state(), lib.repro_ssd_bwd_max_chunk()) != (
            2 * len(_BWD_TENSORS), MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK):
        raise RuntimeError("backward kernel library and wrapper disagree on "
                           "the pointer slots or the largest head dim, state "
                           "or chunk")


# the backward's kernels (their own source, built beside the forward's)
BWD_LIB = CudaLibrary(BWD_SOURCE, "ssd_bwd", _declare_bwd)


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
        want = torch.bfloat16 if tname.lstrip("t") in ("x", "B", "C", "hi",
                                                       "lo") \
            else torch.float32
        if t.device.type != "cuda" or t.dtype != want:
            raise ValueError(f"{name}: {tname} must be a {want} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if tname not in ("A", "tA") and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} is not "
                             f"contiguous (strides {t.stride()})")
        if tname.lstrip("t") in ("x", "B", "C", "hi", "lo", "S") and \
                t.data_ptr() % 16:
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


def _f32(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(*shape, dtype=torch.float32, device=like.device)


def ssd_f32_chunk_state(x, dt, A, Bg, *, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the float32 route: (S (B,nc,H,P,N), seg (B,H,L)), float32,
    as :func:`.ref.chunk_state_ref` (its plain version, taken for CPU
    tensors).  A: (H,) or per sequence (B,H)."""
    _check_shapes(x, dt, A, Bg, Bg, chunk)
    if x.device.type == "cpu":
        return chunk_state_ref(x, dt, A, Bg, chunk)
    _check_bwd("ssd_f32_chunk_state", torch.float32, chunk, x=x, dt=dt, A=A,
               B=Bg)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    S = _f32(B, L // chunk, H, P, N, like=x)
    seg = _f32(B, H, L, like=x)
    _launch("ssd_f32_chunk_state", _LIB.lib.repro_ssd_f32_chunk_state, x, dt,
            A, A.stride(0) if A.ndim == 2 else 0, Bg, S, seg, B, L, H, P, G,
            N, chunk)
    return S, seg


def ssd_f32_state_pass(S, seg, *, chunk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the float32 route: (the states entering chunks 1 .. nc-1
    (B,nc-1,H,P,N), the final state (B,H,P,N)), float32, as
    :func:`.ref.state_pass_ref` (its plain version)."""
    B, nc, H, P, N = S.shape
    if tuple(seg.shape) != (B, H, nc * chunk):
        raise ValueError(f"ssd_f32_state_pass: seg {tuple(seg.shape)} does "
                         f"not fit S {tuple(S.shape)} and chunk={chunk}")
    if S.device.type == "cpu":
        return state_pass_ref(S, seg, chunk)
    _check_bwd("ssd_f32_state_pass", torch.float32, chunk, S=S, seg=seg)
    s_in = _f32(B, nc - 1, H, P, N, like=S)
    state = _f32(B, H, P, N, like=S)
    _launch("ssd_f32_state_pass", _LIB.lib.repro_ssd_f32_state_pass, S, seg,
            s_in, state, B, nc * chunk, H, P, N, chunk)
    return s_in, state


def ssd_f32_chunk_scan(x, dt, seg, Bg, Cg, s_in, *, chunk: int
                       ) -> torch.Tensor:
    """Pass 3 of the float32 route: y (B,L,H,P) float32 from seg (pass 1)
    and the entering states s_in (B,nc-1,H,P,N) (pass 2), as
    :func:`.ref.chunk_scan_ref` (its plain version)."""
    _check_shapes(x, dt, None, Bg, Cg, chunk)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    want = (B, L // chunk - 1, H, P, N)
    if tuple(seg.shape) != (B, H, L) or tuple(s_in.shape) != want:
        raise ValueError(f"ssd_f32_chunk_scan: seg {tuple(seg.shape)} and "
                         f"s_in {tuple(s_in.shape)} do not fit x "
                         f"{tuple(x.shape)} (want ({B}, {H}, {L}) and "
                         f"{want})")
    if x.device.type == "cpu":
        return chunk_scan_ref(x, dt, seg, Bg, Cg, s_in, chunk)
    _check_bwd("ssd_f32_chunk_scan", torch.float32, chunk, x=x, dt=dt,
               seg=seg, B=Bg, C=Cg, s_in=s_in)
    y = torch.empty_like(x)
    _launch("ssd_f32_chunk_scan", _LIB.lib.repro_ssd_f32_chunk_scan, x, dt,
            seg, Bg, Cg, s_in, y, B, L, H, P, G, N, chunk)
    return y


def ssd_f32_scan_heads(B: int, L: int, H: int, G: int, chunk: int) -> int:
    """Heads a block that :func:`ssd_f32_chunk_scan` runs at this shape on
    the current card: 4 (a group's heads share C.B^T) where that grid gives
    every SM two blocks, else 1.  A head's results are the same bits
    either way.  Builds the library: a card is needed."""
    return _LIB.lib.repro_ssd_f32_scan_heads(B, L, H, G, chunk)


def ssd_scan_kernel(x, dt, A, Bg, Cg, *, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,L,H,P); dt: (B,L,H); A: (H,) or per sequence (B,H); Bg/Cg:
    (B,L,G,N) with G dividing H.  Returns (y (B,L,H,P) in x's dtype,
    final_state (B,H,P,N) float32), as the JAX package's
    ``ssd_scan_pallas`` of the head-expanded B and C."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    B, L, H, P = x.shape
    G = Bg.shape[2]
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
    else:
        if A.stride(-1) != 1:
            A = A.contiguous()
        S, seg = ssd_f32_chunk_state(x, dt, A, Bg, chunk=chunk)
        s_in, state = ssd_f32_state_pass(S, seg, chunk=chunk)
        y = ssd_f32_chunk_scan(x, dt, seg, Bg, Cg, s_in, chunk=chunk)
    launch_counts["ssd_scan"] += 1
    return y, state


def ssd_tangent_state(x, dt, A, Bg, tx, tdt, tA, tB, *, chunk: int
                      ) -> tuple[torch.Tensor, ...]:
    """Pass 1 of T3's bfloat16 route: (S, S' (B,nc,H,P,N), seg, seg'
    (B,H,L)), all float32, as :func:`.ref.tangent_state_ref` (its plain
    version, taken for CPU tensors).  A and A': (H,) or per sequence
    (B,H)."""
    _check_shapes(x, dt, A, Bg, Bg, chunk)
    if x.device.type == "cpu":
        return tangent_state_ref(x, dt, A, Bg, tx, tdt, tA, tB, chunk)
    _check_hopper("ssd_tangent_state", chunk, x=x, dt=dt, A=A, B=Bg, tx=tx,
                  tdt=tdt, tA=tA, tB=tB)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    A, tA = (a if a.stride(-1) == 1 else a.contiguous() for a in (A, tA))
    S, tS = (torch.empty(B, L // chunk, H, P, N, dtype=torch.float32,
                         device=x.device) for _ in "sS")
    seg, tseg = (torch.empty(B, H, L, dtype=torch.float32, device=x.device)
                 for _ in "sS")
    _launch("ssd_tangent_state", _LIB.lib.repro_ssd_tangent_state, x, dt, A,
            A.stride(0) if A.ndim == 2 else 0, Bg, tx, tdt, tA,
            tA.stride(0) if tA.ndim == 2 else 0, tB, S, tS, seg, tseg, B, L,
            H, P, G, N, chunk)
    return S, tS, seg, tseg


def ssd_tangent_pass(S, tS, seg, tseg, *, chunk: int
                     ) -> tuple[torch.Tensor, ...]:
    """Pass 2 of T3's bfloat16 route: the entering states and their
    tangents of chunks 1 .. nc-1 as bf16 planes (hi, lo, thi, tlo;
    (B,nc-1,H,P,N) each, :func:`.ref.split_hi_lo`) and the final state's
    tangent (B,H,P,N) float32; the plain version is
    :func:`.ref.tangent_pass_ref`, split."""
    B, nc, H, P, N = S.shape
    if tuple(tS.shape) != tuple(S.shape) or tuple(seg.shape) != \
            (B, H, nc * chunk) or tuple(tseg.shape) != tuple(seg.shape):
        raise ValueError(f"ssd_tangent_pass: S' {tuple(tS.shape)}, seg "
                         f"{tuple(seg.shape)} and seg' {tuple(tseg.shape)} "
                         f"do not fit S {tuple(S.shape)} and chunk={chunk}")
    if S.device.type == "cpu":
        entering, tentering, tstate = tangent_pass_ref(S, tS, seg, tseg,
                                                       chunk)
        return (*split_hi_lo(entering), *split_hi_lo(tentering), tstate)
    _check_hopper("ssd_tangent_pass", chunk, S=S, tS=tS, seg=seg, tseg=tseg)
    hi, lo, thi, tlo = (torch.empty(B, nc - 1, H, P, N, dtype=torch.bfloat16,
                                    device=S.device) for _ in range(4))
    tstate = torch.empty(B, H, P, N, dtype=torch.float32, device=S.device)
    _launch("ssd_tangent_pass", _LIB.lib.repro_ssd_tangent_pass, S, tS, seg,
            tseg, hi, lo, thi, tlo, tstate, B, nc * chunk, H, P, N, chunk)
    return hi, lo, thi, tlo, tstate


def ssd_tangent_scan(x, dt, seg, Bg, Cg, tx, tdt, tseg, tB, tC, hi, lo, thi,
                     tlo, *, chunk: int) -> torch.Tensor:
    """Pass 3 of T3's bfloat16 route: y' (B,L,H,P) in x's dtype from seg,
    seg' (pass 1) and the entering planes (pass 2), as
    :func:`.ref.tangent_scan_ref` of ``hi + lo`` and ``thi + tlo`` (its
    plain version)."""
    _check_shapes(x, dt, None, Bg, Cg, chunk)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    want = (B, L // chunk - 1, H, P, N)
    if tuple(seg.shape) != (B, H, L) or tuple(tseg.shape) != (B, H, L) or \
            any(tuple(t.shape) != want for t in (hi, lo, thi, tlo)):
        raise ValueError(f"ssd_tangent_scan: seg {tuple(seg.shape)}, seg' "
                         f"{tuple(tseg.shape)} and the planes "
                         f"{tuple(hi.shape)} do not fit x {tuple(x.shape)} "
                         f"(want ({B}, {H}, {L}) and {want})")
    if x.device.type == "cpu":
        return tangent_scan_ref(x, dt, seg, Bg, Cg, tx, tdt, tseg, tB, tC,
                                hi.float() + lo.float(),
                                thi.float() + tlo.float(), chunk)
    _check_hopper("ssd_tangent_scan", chunk, x=x, dt=dt, seg=seg, B=Bg, C=Cg,
                  tx=tx, tdt=tdt, tseg=tseg, tB=tB, tC=tC, hi=hi, lo=lo,
                  thi=thi, tlo=tlo)
    ty = torch.empty_like(x)
    _launch("ssd_tangent_scan", _LIB.lib.repro_ssd_tangent_scan, x, dt, seg,
            Bg, Cg, tx, tdt, tseg, tB, tC, hi, lo, thi, tlo, ty, B, L, H, P,
            G, N, chunk)
    return ty


def ssd_scan_tangent(x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC, *, chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """T3: the tangent (y', final_state') of :func:`ssd_scan_kernel` at
    (x, dt, A, Bg, Cg) along (x', dt', A', B', C') — each tangent shaped
    and typed as its primal (dt, A float32).  y' in x's dtype, the state's
    tangent (B,H,P,N) float32.  The plain version (taken for CPU tensors)
    is :func:`.ref.ssd_scan_tangent_ref`.  bfloat16: T3's three passes
    (:func:`ssd_tangent_state`, :func:`ssd_tangent_pass`,
    :func:`ssd_tangent_scan`); float32: one CUDA-core launch."""
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
    if x.dtype == torch.bfloat16:
        S, tS, seg, tseg = ssd_tangent_state(x, dt, A, Bg, tx, tdt, tA, tB,
                                             chunk=chunk)
        hi, lo, thi, tlo, tstate = ssd_tangent_pass(S, tS, seg, tseg,
                                                    chunk=chunk)
        ty = ssd_tangent_scan(x, dt, seg, Bg, Cg, tx, tdt, tseg, tB, tC, hi,
                              lo, thi, tlo, chunk=chunk)
        launch_counts["ssd_scan_tangent"] += 1
        return ty, tstate
    A, tA = (a.expand(B, H).contiguous() for a in (A, tA))
    ty = torch.empty_like(x)
    tstate = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    _launch("ssd_scan_tangent", _LIB.lib.repro_ssd_scan_tangent, x, dt, A,
            Bg, Cg, tx, tdt, tA, tB, tC, ty, tstate, B, L, H, P, G, N, chunk,
            _DTYPES[x.dtype])
    return ty, tstate


# ---------------------------------------------------------------------------
# the backward (csrc/ssd_bwd.cu) and its tangent
# ---------------------------------------------------------------------------

def _check_like(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_bwd(name: str, dtype: torch.dtype, chunk: int, **tensors) -> None:
    """What the backward's kernels and the float32 forward's take: x, gy,
    B, C (and their tangents) in ``dtype``, float32 or bfloat16; every
    other tensor float32; all on one card and contiguous (A in its last
    dim); P <= 64, N <= 128, chunk <= 256."""
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype} is not supported by the "
                         f"CUDA kernels; use float32 or bfloat16")
    device = next(iter(tensors.values())).device
    for tname, t in tensors.items():
        want = dtype if tname.lstrip("t") in ("x", "gy", "B", "C") \
            else torch.float32
        if t.device.type != "cuda" or t.device != device or t.dtype != want:
            raise ValueError(f"{name}: {tname} must be a {want} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")
        if not (t.is_contiguous() or tname.lstrip("t") == "A"
                and t.stride(-1) == 1):
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} is not "
                             f"contiguous (strides {t.stride()})")
    x = tensors.get("x")
    P = x.shape[3] if x is not None else tensors["S"].shape[3]
    N = tensors["B"].shape[3] if "B" in tensors else tensors["S"].shape[4]
    if P > MAX_HEAD_DIM or N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(
            f"{name}: head dim P={P}, state N={N} and chunk={chunk} must be "
            f"at most {MAX_HEAD_DIM}, {MAX_STATE} and {MAX_CHUNK} for the "
            f"CUDA kernels")
    if dtype == torch.bfloat16 and x is not None:
        # the Hopper kernels read x, gy, B and C by TMA: rows of 16-byte
        # multiples from 16-byte aligned data
        if P % 8 or N % 8:
            raise ValueError(f"{name}: the bfloat16 kernels take a head dim "
                             f"P={P} and state N={N} that are multiples of 8")
        for tname, t in tensors.items():
            if tname.lstrip("t") in ("x", "gy", "B", "C") and \
                    t.data_ptr() % 16:
                raise ValueError(f"{name}: {tname} is not 16-byte aligned")


def _bwd_launch(key: str, tangent: bool, dtype: torch.dtype, dims,
                **planes) -> None:
    """One launch of the backward's pass ``key`` (``ssd_bwd_<pass>``):
    ``planes`` maps a tensor of ``_BWD_TENSORS`` to its (value, tangent)
    planes (None where unused); raises on a refused launch, then counts
    it under ``key`` (``ssd_bwd_tangent_<pass>`` in the tangent)."""
    ptrs = (ctypes.c_void_p * (2 * len(_BWD_TENSORS)))()
    device = None
    for name, pair in planes.items():
        i = _BWD_TENSORS.index(name)
        for j, t in enumerate(pair):
            if t is not None:
                ptrs[2 * i + j] = t.data_ptr()
                device = t.device
    name = (key.replace("ssd_bwd_", "ssd_bwd_tangent_") if tangent else key)
    with torch.cuda.device(device):
        err = BWD_LIB.lib.repro_ssd_bwd_launch(
            BWD_PASSES.index(key[len("ssd_bwd_"):]), int(tangent),
            _DTYPES[dtype], ptrs, (ctypes.c_longlong * 10)(*dims),
            torch.cuda.current_stream().cuda_stream)
    raise_on(err, name)
    launch_counts[name] += 1


def _bwd_dims(x, Bg, A, tA, chunk: int) -> list:
    B, L, H, P = x.shape
    return [B, L, H, P, Bg.shape[2], Bg.shape[3], chunk,
            A.stride(0) if A.ndim == 2 else 0,
            tA.stride(0) if tA is not None and tA.ndim == 2 else 0,
            int(A.ndim == 2)]


def ssd_bwd_state(x, dt, A, Bg, Cg, gy, *, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 of :func:`ssd_scan_bwd`: (S, Lc (B,nc,H,P,N), seg (B,H,L)),
    float32, as :func:`.ref.bwd_state_ref` (its plain version, taken for
    CPU tensors): each chunk's own state and state cotangent."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    _check_like("ssd_bwd_state: gy", gy, x.shape)
    if x.device.type == "cpu":
        return bwd_state_ref(x, dt, A, Bg, Cg, gy, chunk)
    _check_bwd("ssd_bwd_state", x.dtype, chunk, x=x, dt=dt, A=A, B=Bg,
               C=Cg, gy=gy)
    B, L, H, P = x.shape
    N = Bg.shape[3]
    S, Lc = (_f32(B, L // chunk, H, P, N, like=x) for _ in "SL")
    seg = _f32(B, H, L, like=x)
    _bwd_launch("ssd_bwd_state", False, x.dtype,
                _bwd_dims(x, Bg, A, None, chunk), x=(x,), gy=(gy,), B=(Bg,),
                C=(Cg,), dt=(dt,), A=(A,), seg=(seg,), S=(S,), Lc=(Lc,))
    return S, Lc, seg


def _check_pass(name, S, Lc, seg, gs, chunk) -> None:
    B, nc, H, P, N = S.shape
    if tuple(Lc.shape) != tuple(S.shape) or tuple(seg.shape) != \
            (B, H, nc * chunk) or tuple(gs.shape) != (B, H, P, N):
        raise ValueError(f"{name}: Lc {tuple(Lc.shape)}, seg "
                         f"{tuple(seg.shape)} and gs {tuple(gs.shape)} do "
                         f"not fit S {tuple(S.shape)} and chunk={chunk}")


def ssd_bwd_pass(S, Lc, seg, gs, *, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2 of :func:`ssd_scan_bwd`: (s_in, gO (B,nc,H,P,N), sg
    (B,H,nc)), float32, as :func:`.ref.bwd_state_pass_ref`: the states
    entering each chunk, the cotangents of the states leaving it, and their
    inner products."""
    _check_pass("ssd_bwd_pass", S, Lc, seg, gs, chunk)
    if S.device.type == "cpu":
        return bwd_state_pass_ref(S, Lc, seg, gs, chunk)
    _check_bwd("ssd_bwd_pass", torch.float32, chunk, S=S, Lc=Lc, seg=seg,
               gs=gs)
    B, nc, H, P, N = S.shape
    s_in, gO = torch.empty_like(S), torch.empty_like(S)
    sg = _f32(B, H, nc, like=S)
    _bwd_launch("ssd_bwd_pass", False, torch.float32,
                [B, nc * chunk, H, P, 1, N, chunk, 0, 0, 0], seg=(seg,),
                S=(S,), Lc=(Lc,), gs=(gs,), s_in=(s_in,), gO=(gO,),
                sg=(sg,))
    return s_in, gO, sg


def _check_chunk(name, x, seg, s_in, gO, sg, chunk) -> None:
    B, L, H, P = x.shape
    nc = L // chunk
    if tuple(seg.shape) != (B, H, L) or tuple(sg.shape) != (B, H, nc) or \
            tuple(s_in.shape) != tuple(gO.shape) or \
            tuple(s_in.shape[:4]) != (B, nc, H, P):
        raise ValueError(f"{name}: seg {tuple(seg.shape)}, s_in "
                         f"{tuple(s_in.shape)}, gO {tuple(gO.shape)} and sg "
                         f"{tuple(sg.shape)} do not fit x {tuple(x.shape)} "
                         f"and chunk={chunk}")


def _gram_tiles(dtype, chunk: int) -> tuple[int, int]:
    """(pairs of tiles a chunk, floats a tile) of the gram kernel's C·Bᵀ
    tiles: in bfloat16 each pair of 64-row tiles q >= k (64·64); in
    float32 each 64-row key tile k with each 32-row query tile that meets
    k <= q (64·32)."""
    if dtype == torch.bfloat16:
        nt = -(-chunk // 64)
        return nt * (nt + 1) // 2, 64 * 64
    nk, nq = -(-chunk // 64), -(-chunk // 32)
    return nk * nq - nk * (nk - 1), 64 * 32


def _scratch(x, Bg, chunk, heads=True):
    """The chunk kernel's outputs for the finish and reduce kernels; dB and
    dC per head (B,L,H,N) only with ``heads``; the gram kernel's C·Bᵀ
    tiles for the chunk kernel, (B·nc, G, pairs, floats a tile) as
    :func:`_gram_tiles`."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    out = {k: _f32(B, H, L, like=x) for k in ("ddd", "dsk", "dsq", "tk")}
    out["dAp"] = _f32(B, L // chunk, H, like=x)
    if heads:
        out.update(dBh=_f32(B, L, H, N, like=x), dCh=_f32(B, L, H, N, like=x))
    out["gram"] = _f32(B * (L // chunk), G, *_gram_tiles(x.dtype, chunk),
                       like=x)
    return out


def _chunk_launches(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, chunk,
                    tangents=None):
    """The chunk wrapper's launches ({key: a call that makes that one
    launch}, in launch order: the gram kernel's C·Bᵀ first) and the
    outputs they fill, (dx, ddt, dA, dB, dC); with ``tangents`` (tx,
    tdt, tA, tB, tC, tgy, tseg, ts_in, tgO, tsg) the tangent's launches and
    the outputs' tangents.  Each launch reads only what the ones before it
    wrote, so each can be run again alone."""
    t = tangents or (None,) * 10
    out = [torch.empty_like(v) for v in (x, dt)] + [
        _f32(*A.shape, like=x)] + [torch.empty_like(v) for v in (Bg, Cg)]
    planes = {k: (v, tv) for k, v, tv in zip(
        ("x", "dt", "A", "B", "C", "gy", "seg", "s_in", "gO", "sg"),
        (x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg), t)}
    if tangents is None:
        planes.update({k: (v,) for k, v in zip(
            ("dx", "ddt", "dA", "dB", "dC"), out)})
        planes.update({k: (v,) for k, v in _scratch(x, Bg, chunk).items()})
    else:
        # the group sums read only the tangent planes of dB and dC per head
        planes.update({k: (None, v) for k, v in zip(
            ("dx", "ddt", "dA", "dB", "dC"), out)})
        scratch = _scratch(x, Bg, chunk, heads=False)
        planes.update({k: (scratch.get(k), v) for k, v in _scratch(
            x, Bg, chunk).items()})
    dims = _bwd_dims(x, Bg, A, t[2], chunk)
    keys = ("ssd_bwd_gram", "ssd_bwd_chunk", "ssd_bwd_finish",
            "ssd_bwd_reduce")
    calls = {k: (lambda k=k: _bwd_launch(k, tangents is not None, x.dtype,
                                         dims, **planes)) for k in keys}
    return calls, tuple(out)


def ssd_bwd_chunk(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, *, chunk: int
                  ) -> tuple[torch.Tensor, ...]:
    """Pass 3 of :func:`ssd_scan_bwd`: (dx in x's dtype, ddt float32, dA
    float32 shaped as A, dB, dC in their dtypes), as
    :func:`.ref.bwd_chunk_ref`.  First the gram kernel (C·Bᵀ of each pair
    of a key and a query tile, once per group); then the chunk kernel
    (each chunk's tiles), the finish kernel (ddt and each chunk's dA) and
    the reduce kernel (dB and dC over a group's heads, dA over chunks)."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    _check_like("ssd_bwd_chunk: gy", gy, x.shape)
    _check_chunk("ssd_bwd_chunk", x, seg, s_in, gO, sg, chunk)
    if x.device.type == "cpu":
        return bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, chunk)
    _check_bwd("ssd_bwd_chunk", x.dtype, chunk, x=x, dt=dt, A=A, B=Bg, C=Cg,
               gy=gy, seg=seg, s_in=s_in, gO=gO, sg=sg)
    calls, out = _chunk_launches(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg,
                                 chunk)
    for call in calls.values():
        call()
    return out


def _check_bwd_inputs(name, x, dt, A, Bg, Cg, gy, gs, chunk) -> None:
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    B, L, H, P = x.shape
    _check_like(f"{name}: gy", gy, x.shape)
    _check_like(f"{name}: gs", gs, (B, H, P, Bg.shape[3]))


def ssd_scan_bwd(x, dt, A, Bg, Cg, gy, gs, *, chunk: int
                 ) -> tuple[torch.Tensor, ...]:
    """The scan's backward: the VJP of :func:`ssd_scan_kernel` from a zero
    state for the cotangents gy (y's, in x's dtype) and gs (the final
    state's, float32), computed in float32: (dx, ddt, dA, dB, dC), each
    shaped and typed as its input (dt and A float32).  On CPU tensors the
    plain versions of the three passes composed; on CUDA tensors
    :func:`ssd_bwd_state`, :func:`ssd_bwd_pass` and :func:`ssd_bwd_chunk`,
    six launches in either dtype."""
    _check_bwd_inputs("ssd_scan_bwd", x, dt, A, Bg, Cg, gy, gs, chunk)
    if x.device.type == "cpu":
        S, Lc, seg = bwd_state_ref(x, dt, A, Bg, Cg, gy, chunk)
        s_in, gO, sg = bwd_state_pass_ref(S, Lc, seg, gs, chunk)
        return bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
    _check_bwd("ssd_scan_bwd", x.dtype, chunk, x=x, dt=dt, A=A, B=Bg, C=Cg,
               gy=gy, gs=gs)
    S, Lc, seg = ssd_bwd_state(x, dt, A, Bg, Cg, gy, chunk=chunk)
    s_in, gO, sg = ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk)
    grads = ssd_bwd_chunk(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg,
                          chunk=chunk)
    launch_counts["ssd_scan_bwd"] += 1
    return grads


def _check_tangents(name, primals, tangents) -> None:
    for tname, t, p in zip(("x'", "dt'", "A'", "B'", "C'", "gy'", "gs'"),
                           tangents, primals):
        _check_like(f"{name}: {tname}", t, p.shape)


def ssd_bwd_tangent_state(x, dt, A, Bg, Cg, gy, tx, tdt, tA, tB, tC, tgy, *,
                          chunk: int) -> tuple[torch.Tensor, ...]:
    """Pass 1 of :func:`ssd_scan_bwd_tangent`: (S, S', Lc, Lc', seg,
    seg'), float32, as :func:`.ref.tangent_bwd_state_ref`."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    _check_tangents("ssd_bwd_tangent_state", (x, dt, A, Bg, Cg, gy),
                    (tx, tdt, tA, tB, tC, tgy))
    if x.device.type == "cpu":
        return tangent_bwd_state_ref(x, dt, A, Bg, Cg, gy, tx, tdt, tA, tB,
                                     tC, tgy, chunk)
    _check_bwd("ssd_bwd_tangent_state", x.dtype, chunk, x=x, dt=dt, A=A,
               B=Bg, C=Cg, gy=gy, tx=tx, tdt=tdt, tA=tA, tB=tB, tC=tC,
               tgy=tgy)
    B, L, H, P = x.shape
    N = Bg.shape[3]
    S, tS, Lc, tLc = (_f32(B, L // chunk, H, P, N, like=x) for _ in range(4))
    seg, tseg = _f32(B, H, L, like=x), _f32(B, H, L, like=x)
    _bwd_launch("ssd_bwd_state", True, x.dtype, _bwd_dims(x, Bg, A, tA, chunk),
                x=(x, tx), gy=(gy, tgy), B=(Bg, tB), C=(Cg, tC), dt=(dt, tdt),
                A=(A, tA), seg=(seg, tseg), S=(S, tS), Lc=(Lc, tLc))
    return S, tS, Lc, tLc, seg, tseg


def ssd_bwd_tangent_pass(S, tS, Lc, tLc, seg, tseg, gs, tgs, *, chunk: int
                         ) -> tuple[torch.Tensor, ...]:
    """Pass 2 of :func:`ssd_scan_bwd_tangent`: (s_in, s_in', gO, gO', sg,
    sg'), float32, as :func:`.ref.tangent_bwd_state_pass_ref`."""
    _check_pass("ssd_bwd_tangent_pass", S, Lc, seg, gs, chunk)
    _check_pass("ssd_bwd_tangent_pass", tS, tLc, tseg, tgs, chunk)
    if S.device.type == "cpu":
        return tangent_bwd_state_pass_ref(S, tS, Lc, tLc, seg, tseg, gs, tgs,
                                          chunk)
    _check_bwd("ssd_bwd_tangent_pass", torch.float32, chunk, S=S, tS=tS,
               Lc=Lc, tLc=tLc, seg=seg, tseg=tseg, gs=gs, tgs=tgs)
    B, nc, H, P, N = S.shape
    s_in, ts_in, gO, tgO = (torch.empty_like(S) for _ in range(4))
    sg, tsg = _f32(B, H, nc, like=S), _f32(B, H, nc, like=S)
    _bwd_launch("ssd_bwd_pass", True, torch.float32,
                [B, nc * chunk, H, P, 1, N, chunk, 0, 0, 0],
                seg=(seg, tseg), S=(S, tS), Lc=(Lc, tLc), gs=(gs, tgs),
                s_in=(s_in, ts_in), gO=(gO, tgO), sg=(sg, tsg))
    return s_in, ts_in, gO, tgO, sg, tsg


def ssd_bwd_tangent_chunk(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, tx, tdt,
                          tA, tB, tC, tgy, tseg, ts_in, tgO, tsg, *,
                          chunk: int) -> tuple[torch.Tensor, ...]:
    """Pass 3 of :func:`ssd_scan_bwd_tangent`: the tangents (dx', ddt',
    dA', dB', dC') of :func:`ssd_bwd_chunk`'s outputs, each in its output's
    dtype, as :func:`.ref.tangent_bwd_chunk_ref`; the launches of
    :func:`ssd_bwd_chunk`."""
    _check_shapes(x, dt, A, Bg, Cg, chunk)
    _check_tangents("ssd_bwd_tangent_chunk", (x, dt, A, Bg, Cg, gy),
                    (tx, tdt, tA, tB, tC, tgy))
    _check_chunk("ssd_bwd_tangent_chunk", x, seg, s_in, gO, sg, chunk)
    _check_chunk("ssd_bwd_tangent_chunk", x, tseg, ts_in, tgO, tsg, chunk)
    if x.device.type == "cpu":
        return tangent_bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg,
                                     tx, tdt, tA, tB, tC, tgy, tseg, ts_in,
                                     tgO, tsg, chunk)
    _check_bwd("ssd_bwd_tangent_chunk", x.dtype, chunk, x=x, dt=dt, A=A,
               B=Bg, C=Cg, gy=gy, seg=seg, s_in=s_in, gO=gO, sg=sg, tx=tx,
               tdt=tdt, tA=tA, tB=tB, tC=tC, tgy=tgy, tseg=tseg, ts_in=ts_in,
               tgO=tgO, tsg=tsg)
    calls, out = _chunk_launches(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg,
                                 chunk, (tx, tdt, tA, tB, tC, tgy, tseg,
                                         ts_in, tgO, tsg))
    for call in calls.values():
        call()
    return out


def ssd_scan_bwd_tangent(x, dt, A, Bg, Cg, gy, gs, tx, tdt, tA, tB, tC, tgy,
                         tgs, *, chunk: int) -> tuple[torch.Tensor, ...]:
    """The backward's forward-mode tangent: the tangents of
    :func:`ssd_scan_bwd`'s five gradients along the tangents of (x, dt, A,
    B, C, gy, gs), each shaped and typed as its primal.  On CPU tensors the
    plain versions of the three tangent passes composed; on CUDA tensors
    :func:`ssd_bwd_tangent_state`, :func:`ssd_bwd_tangent_pass` and
    :func:`ssd_bwd_tangent_chunk`, the backward's kernels on dual
    numbers."""
    _check_bwd_inputs("ssd_scan_bwd_tangent", x, dt, A, Bg, Cg, gy, gs,
                      chunk)
    _check_tangents("ssd_scan_bwd_tangent", (x, dt, A, Bg, Cg, gy, gs),
                    (tx, tdt, tA, tB, tC, tgy, tgs))
    if x.device.type == "cpu":
        S, tS, Lc, tLc, seg, tseg = tangent_bwd_state_ref(
            x, dt, A, Bg, Cg, gy, tx, tdt, tA, tB, tC, tgy, chunk)
        s_in, ts_in, gO, tgO, sg, tsg = tangent_bwd_state_pass_ref(
            S, tS, Lc, tLc, seg, tseg, gs, tgs, chunk)
        return tangent_bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg,
                                     tx, tdt, tA, tB, tC, tgy, tseg, ts_in,
                                     tgO, tsg, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd_tangent: no kernel for device "
                         f"{x.device}")
    _check_bwd("ssd_scan_bwd_tangent", x.dtype, chunk, x=x, dt=dt, A=A,
               B=Bg, C=Cg, gy=gy, gs=gs, tx=tx, tdt=tdt, tA=tA, tB=tB, tC=tC,
               tgy=tgy, tgs=tgs)
    S, tS, Lc, tLc, seg, tseg = ssd_bwd_tangent_state(
        x, dt, A, Bg, Cg, gy, tx, tdt, tA, tB, tC, tgy, chunk=chunk)
    s_in, ts_in, gO, tgO, sg, tsg = ssd_bwd_tangent_pass(
        S, tS, Lc, tLc, seg, tseg, gs, tgs, chunk=chunk)
    out = ssd_bwd_tangent_chunk(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, tx,
                                tdt, tA, tB, tC, tgy, tseg, ts_in, tgO, tsg,
                                chunk=chunk)
    launch_counts["ssd_scan_bwd_tangent"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd: kernel forward + the backward (the chunked scan's VJP on the CPU)
# ---------------------------------------------------------------------------

def _fold_A(A: torch.Tensor, dim: int | None, n: int, B: int
            ) -> torch.Tensor:
    """A of each mapped call, (H,) or (B, H), as one A per folded
    sequence: (n·B, H)."""
    A = A.expand(n, *A.shape) if dim is None else A.movedim(dim, 0)
    if A.ndim == 2:                                    # (n, H)
        A = A[:, None, :].expand(n, B, A.shape[-1])
    return A.reshape(n * B, A.shape[-1])


def _kernel_args(x, dt, A, Bg, Cg, gy, gs):
    """The backward kernels' operands: contiguous, x's dtype for gy, float32
    for dt, A and gs."""
    return (x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
            Bg.contiguous(), Cg.contiguous(), gy.to(x.dtype).contiguous(),
            gs.float().contiguous())


def _chunked_vjp(x, dt, A, Bg, Cg, gy, gs, chunk):
    """Gradients of the chunked scan, in float32, at the given inputs, each
    in its input's dtype: the chunked VJP on CPU tensors, the backward's
    kernels (:func:`ssd_scan_bwd`) on CUDA tensors."""
    if x.device.type == "cpu":
        with torch.profiler.record_function("ssd_scan_chunked_bwd"):
            return ssd_scan_vjp(x, dt, A, Bg, Cg, gy, gs, chunk)
    grads = ssd_scan_bwd(*_kernel_args(x, dt, A, Bg, Cg, gy, gs),
                         chunk=chunk)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bg, Cg)))


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
    """The tangent of :func:`_chunked_vjp`'s gradients, each in its
    gradient's dtype: ``torch.func.jvp`` of :func:`.chunked.ssd_scan_vjp`
    on CPU tensors, the backward's kernels on dual numbers
    (:func:`ssd_scan_bwd_tangent`) on CUDA tensors."""
    if x.device.type == "cpu":
        with torch.profiler.record_function("ssd_scan_chunked_bwd_jvp"):
            return torch.func.jvp(
                lambda *a: ssd_scan_vjp(*a, chunk),
                *(tuple(t.contiguous() for t in ts) for ts in (
                    (x, dt, A, Bg, Cg, gy, gs),
                    (tx, tdt, tA, tB, tC, tgy, tgs))))[1]
    out = ssd_scan_bwd_tangent(*_kernel_args(x, dt, A, Bg, Cg, gy, gs),
                               *_kernel_args(tx, tdt, tA, tB, tC, tgy, tgs),
                               chunk=chunk)
    return tuple(g.to(t.dtype) for g, t in zip(out, (x, dt, A, Bg, Cg)))


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
    CPU tensor), differentiable through the backward's kernels (the chunked
    scan's VJP on a CPU tensor)."""
    return _SSDScan.apply(x, dt, A, Bg, Cg, chunk)
