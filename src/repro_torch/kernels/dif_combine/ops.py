"""Wrappers, build and launch counters of the two CUDA kernels in
``csrc/dif_combine.cu`` (``dif_combine`` and ``fused_combine_update``).

Routing is by the tensors' device, nothing else: CPU tensors go to the plain
PyTorch versions in :mod:`.ref`; CUDA tensors launch the kernel or raise —
there is no fallback.  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` at the repository root
(named by a hash of the source and flags, so an edited source rebuilds) and
bound through their plain C interface with ``ctypes``.  A launch runs on
PyTorch's current stream; outputs are allocated here with ``torch.empty``,
and the kernels allocate nothing and do not synchronise.

``launch_counts`` counts kernel launches (plain-version calls are not
counted), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels.dif_combine.ref import (dif_combine_ref,
                                                 fused_update_ref)

__all__ = ["dif_combine", "fused_combine_update", "build", "launch_counts",
           "reset_launch_counts", "KINDS", "MODES", "MAX_AGENTS"]

KINDS = ("sgd", "momentum", "adam")
MODES = ("atc", "consensus", "local")
MAX_AGENTS = 64          # kMaxK in the CUDA source: A and the tiles in smem

SOURCE = Path(__file__).resolve().parent / "csrc" / "dif_combine.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"dif_combine": 0, "fused_combine_update": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_info: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "dif_combine CUDA kernels cannot be built")
    return path


def build() -> dict:
    """Compile (when the source or flags changed) and load the kernels.
    Returns ``{"path", "seconds", "compiled", "log"}``, where ``log`` is
    nvcc's output (``-Xptxas -v``: registers and shared memory per kernel).
    Raises if nvcc fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _build_info
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        so = BUILD_DIR / f"libdif_combine_{tag}.so"
        t0 = time.perf_counter()
        log, compiled = "", not so.exists()
        if compiled:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.repro_max_agents.argtypes = []
        lib.repro_max_agents.restype = i
        lib.repro_dif_combine.argtypes = [p, p, p, i, ll, i, i, p]
        lib.repro_dif_combine.restype = i
        lib.repro_fused_update.argtypes = ([p] * 11 + [i, i, ll, i, i, i, i]
                                           + [f] * 8 + [p])
        lib.repro_fused_update.restype = i
        if lib.repro_max_agents() != MAX_AGENTS:
            raise RuntimeError("kernel library and wrapper disagree on the "
                               "largest supported agent count")
        _build_info.update(path=str(so), compiled=compiled, log=log,
                           seconds=time.perf_counter() - t0)
        _lib = lib
    return _build_info


def _check_cuda(name: str, K: int, dtype: torch.dtype,
                tensors: dict[str, torch.Tensor | None]) -> None:
    """What the kernels take: contiguous buffers, f32/bf16, K <= 64."""
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype} is not supported by the "
                         f"CUDA kernel; use float32 or bfloat16")
    if K > MAX_AGENTS:
        raise ValueError(f"{name}: K={K} agents exceeds the {MAX_AGENTS} "
                         f"the CUDA kernel supports")
    for tname, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _aligned(tensors, elems: int) -> bool:
    return all(t.data_ptr() % (elems * t.element_size()) == 0
               for t in tensors if t is not None)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _check_same_device(name: str, device: torch.device, **tensors) -> None:
    for tname, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{device}")


# ---------------------------------------------------------------------------
# dif_combine
# ---------------------------------------------------------------------------

def dif_combine(A: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """A: (K, K) combination matrix; phi: (K, M).  Returns (K, M) in phi's
    dtype: ``out[k] = Σ_l A[l, k] φ[l]`` with float32 accumulation."""
    if phi.ndim != 2:
        raise ValueError(f"phi must be (K, M), got shape {tuple(phi.shape)}")
    K, M = phi.shape
    if tuple(A.shape) != (K, K):
        raise ValueError(
            f"combination matrix shape {tuple(A.shape)} does not match the "
            f"K={K} stacked agents of phi {tuple(phi.shape)}; need A of "
            f"shape ({K}, {K})")
    _check_same_device("dif_combine", phi.device, A=A)
    if phi.device.type == "cpu":
        return dif_combine_ref(A, phi)
    if phi.device.type != "cuda":
        raise ValueError(f"dif_combine: no kernel for device {phi.device}")
    _check_cuda("dif_combine", K, phi.dtype, {"phi": phi})
    build()
    lib = _lib
    A32 = A.to(torch.float32).contiguous()
    out = torch.empty_like(phi)
    per16 = 16 // phi.element_size()       # elements in one 16-byte load
    vec = M % per16 == 0 and _aligned((phi, out), per16)
    with torch.cuda.device(phi.device):
        err = lib.repro_dif_combine(
            A32.data_ptr(), phi.data_ptr(), out.data_ptr(), K, M,
            _DTYPES[phi.dtype], int(vec),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "dif_combine")
    launch_counts["dif_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# fused_combine_update
# ---------------------------------------------------------------------------

def fused_combine_update(table, sel, ctl, scale, params, grads, mu=None,
                         nu=None, *, mode: str = "atc", kind: str = "adam",
                         lr: float, b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, weight_decay: float = 0.0,
                         beta: float = 0.9):
    """One-pass combine-then-update over a packed (K, M) dtype group.

    ``table``  (S, K, K) float32 stacked schedule (S=1 for a static graph);
               for ``mode='local'`` it is unread but must still be (S, K, K).
    ``sel``    (1, 1) int32 — the ``step % S`` row index, a device tensor.
    ``ctl``    (1, 3) float32 — ``[gate, bc1, bc2]``: the CommSchedule gate
               (1.0 = mix this step) and the Adam bias corrections
               (ignored for sgd/momentum), a device tensor.
    ``scale``  (K, 1) float32 per-agent global-norm clip scale.
    ``params``/``grads``  (K, M), one float dtype.
    ``mu``/``nu``  both fp32 for ``kind='adam'``; ``mu`` = velocity (param
               dtype) for ``'momentum'``; neither for ``'sgd'``.

    Returns ``(new_params, new_mu, new_nu)`` with ``None`` for absent
    moment buffers.  Zero-padded columns stay zero.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer kind {kind!r}; one of {KINDS}")
    if mode not in MODES:
        raise ValueError(f"unknown combine mode {mode!r}; one of {MODES}")
    if params.ndim != 2:
        raise ValueError(f"params must be (K, M), got {tuple(params.shape)}")
    K, M = params.shape
    if tuple(grads.shape) != (K, M):
        raise ValueError(f"grads shape {tuple(grads.shape)} does not match "
                         f"params {tuple(params.shape)}")
    if table.ndim != 3 or tuple(table.shape[1:]) != (K, K):
        raise ValueError(
            f"schedule table shape {tuple(table.shape)} does not match the "
            f"K={K} stacked agents of params {tuple(params.shape)}; need "
            f"(S, {K}, {K})")
    n_mom = {"sgd": 0, "momentum": 1, "adam": 2}[kind]
    moments = list((mu, nu)[:n_mom])
    if len([m for m in (mu, nu) if m is not None]) != n_mom:
        raise ValueError(
            f"optimizer kind {kind!r} takes exactly {n_mom} moment "
            f"buffer(s); got mu={'set' if mu is not None else None}, "
            f"nu={'set' if nu is not None else None}")
    for name, m in zip(("mu", "nu"), moments):
        if tuple(m.shape) != (K, M):
            raise ValueError(f"{name} shape {tuple(m.shape)} does not match "
                             f"params {tuple(params.shape)}")
    if kind == "adam":
        for name, m in zip(("mu", "nu"), moments):
            if m.dtype != torch.float32:
                raise ValueError(
                    f"adam moment {name} must be float32 (fp32 moments are "
                    f"the fused contract), got {m.dtype}")
    _check_same_device("fused_combine_update", params.device, table=table,
                       sel=sel, ctl=ctl, scale=scale, grads=grads, mu=mu,
                       nu=nu)
    hyper = dict(mode=mode, kind=kind, lr=lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, beta=beta)
    if params.device.type == "cpu":
        return fused_update_ref(table, sel, ctl, scale, params, grads, mu,
                                nu, **hyper)
    if params.device.type != "cuda":
        raise ValueError(f"fused_combine_update: no kernel for device "
                         f"{params.device}")
    name = "fused_combine_update"
    _check_cuda(name, K, params.dtype,
                {"table": table, "sel": sel, "ctl": ctl, "scale": scale,
                 "params": params, "grads": grads, "mu": mu, "nu": nu})
    expect = {"table": (table, torch.float32), "sel": (sel, torch.int32),
              "ctl": (ctl, torch.float32), "scale": (scale, torch.float32),
              "grads": (grads, params.dtype)}
    if kind == "momentum":
        expect["mu"] = (mu, params.dtype)
    for tname, (t, dt) in expect.items():
        if t.dtype != dt:
            raise ValueError(f"{name}: {tname} must be {dt}, got {t.dtype}")
    for tname, t, shape in (("sel", sel, (1, 1)), ("ctl", ctl, (1, 3)),
                            ("scale", scale, (K, 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got "
                             f"{tuple(t.shape)}")
    build()
    lib = _lib
    w_out = torch.empty_like(params)
    outs = [torch.empty_like(m) for m in moments]
    mu_out, nu_out = (outs + [None, None])[:2]
    bufs = (params, grads, mu, nu, w_out, mu_out, nu_out)
    vec = M % 4 == 0 and _aligned(bufs, 4)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(params.device):
        err = lib.repro_fused_update(
            table.data_ptr(), sel.data_ptr(), ctl.data_ptr(),
            scale.data_ptr(), *(ptr(t) for t in bufs), table.shape[0], K, M,
            _DTYPES[params.dtype], KINDS.index(kind), MODES.index(mode),
            int(vec), -lr, b1, 1 - b1, b2, 1 - b2, eps, lr * weight_decay,
            beta, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return w_out, mu_out, nu_out
