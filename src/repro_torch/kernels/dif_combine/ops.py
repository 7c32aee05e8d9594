"""Wrappers, build and launch counters of the two CUDA kernels in
``csrc/dif_combine.cu`` (``dif_combine`` and ``fused_combine_update``).

Each kernel takes a list of leaves, (K, ...) tensors read and written in
their own shapes, and runs one launch per dtype group (and per
``MAX_LEAVES`` leaves of a group): :func:`dif_combine_leaves` and
:func:`fused_combine_update_leaves`.  The single-buffer :func:`dif_combine`
and :func:`fused_combine_update` are the TPU kernels' counterparts over one
(K, M) buffer; they run the same kernels on a group of one.

Routing is by the tensors' device, nothing else: CPU tensors go to the plain
PyTorch versions in :mod:`.ref`; CUDA tensors launch the kernel or raise —
there is no fallback.  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use and bound through their plain C interface with
``ctypes`` (:mod:`repro_torch.kernels.build`).  A launch runs on
PyTorch's current stream; outputs are allocated here with ``torch.empty``,
and the kernels allocate nothing and do not synchronise.  The leaf list
travels in the launch's parameters and the fused update reads its step
from the card, so a CUDA graph can capture either call.

``launch_counts`` counts kernel launches (plain-version calls are not
counted), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, raise_on
from repro_torch.kernels.dif_combine.ref import (dif_combine_leaves_ref,
                                                 dif_combine_ref,
                                                 fused_update_leaves_ref,
                                                 fused_update_ref)

__all__ = ["dif_combine", "dif_combine_leaves", "fused_combine_update",
           "fused_combine_update_leaves", "build", "launch_counts",
           "reset_launch_counts", "KINDS", "MODES", "MAX_AGENTS",
           "MAX_LEAVES"]

KINDS = ("sgd", "momentum", "adam")
MODES = ("atc", "consensus", "local")
MAX_AGENTS = 64          # kMaxK in the CUDA source: A and the tiles in smem
MAX_LEAVES = 48          # kMaxLeaves: the leaf table in a launch's parameters

SOURCE = Path(__file__).resolve().parent / "csrc" / "dif_combine.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"dif_combine": 0, "fused_combine_update": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    for name in ("repro_max_agents", "repro_max_leaves"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.repro_dif_combine_leaves.argtypes = [p, i, i, p, p, i, p]
    lib.repro_dif_combine_leaves.restype = i
    lib.repro_fused_update_leaves.argtypes = (
        [p, p, p, p, ll, i, p, i, i, p, i, i, p, p, i, i, i] + [f] * 8
        + [p])
    lib.repro_fused_update_leaves.restype = i
    if (lib.repro_max_agents(), lib.repro_max_leaves()) != (MAX_AGENTS,
                                                            MAX_LEAVES):
        raise RuntimeError("kernel library and wrapper disagree on the "
                           "largest agent count or leaf table")


_LIB = CudaLibrary(SOURCE, "dif_combine", _declare)


def build() -> dict:
    """Compile (when the source or flags changed) and load the kernels.
    Returns ``{"path", "seconds", "compiled", "log"}``, where ``log`` is
    nvcc's output (``-Xptxas -v``: registers and shared memory per kernel).
    Raises if nvcc fails."""
    return _LIB.build()


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


def _check_same_device(name: str, device: torch.device,
                       tensors: dict[str, torch.Tensor | None]) -> None:
    for tname, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{device}")


def _agents(name: str, leaves: Mapping[str, torch.Tensor]) -> int:
    """The shared leading (agent) size of a non-empty leaf dict."""
    if not leaves:
        raise ValueError(f"{name}: no leaves")
    sizes = {k: (x.shape[0] if x.ndim else None) for k, x in leaves.items()}
    K = next(iter(sizes.values()))
    if K is None or any(s != K for s in sizes.values()):
        raise ValueError(f"{name}: every leaf needs the same leading agent "
                         f"axis, got {sizes}")
    return K


def _columns(x: torch.Tensor) -> int:
    return x.numel() // x.shape[0] if x.shape[0] else 0


def _launch_groups(name, leaves, pointers, launch) -> None:
    """One C call per dtype group (``launch(dtype, n, ptrs, m)``), each of
    ceil(n / MAX_LEAVES) launches, counted."""
    groups: dict[torch.dtype, list[str]] = {}
    for k, x in leaves.items():
        groups.setdefault(x.dtype, []).append(k)
    for dtype, keys in groups.items():
        flat = [ptr for k in keys for ptr in pointers(k)]
        ptrs = (ctypes.c_void_p * len(flat))(*flat)
        cols = [_columns(leaves[k]) for k in keys]
        m = (ctypes.c_longlong * len(keys))(*cols)
        with torch.cuda.device(leaves[keys[0]].device):
            raise_on(launch(_DTYPES[dtype], len(keys), ptrs, m), name)
        # a launch covers MAX_LEAVES leaves and none runs without columns
        launch_counts[name] += sum(
            any(cols[i:i + MAX_LEAVES])
            for i in range(0, len(keys), MAX_LEAVES))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# dif_combine
# ---------------------------------------------------------------------------

def dif_combine_leaves(A: torch.Tensor, leaves: Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """``out[k] = Σ_l A[l, k] φ[l]`` for every (K, ...) leaf, float32
    accumulation, each output in its leaf's shape and dtype.  On the card,
    one launch per dtype group."""
    name = "dif_combine"
    K = _agents(name, leaves)
    if tuple(A.shape) != (K, K):
        raise ValueError(
            f"combination matrix shape {tuple(A.shape)} does not match the "
            f"K={K} stacked agents of the leaves; need A of shape ({K}, {K})")
    device = next(iter(leaves.values())).device
    _check_same_device(name, device, {"A": A, **{f"leaves[{k}]": x
                                                 for k, x in leaves.items()}})
    if device.type == "cpu":
        return dif_combine_leaves_ref(A, leaves)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for k, x in leaves.items():
        _check_cuda(name, K, x.dtype, {k: x})
    out = {k: torch.empty_like(x) for k, x in leaves.items()}
    _combine_launch(A.to(torch.float32).contiguous(), leaves, out)
    return out


def _combine_launch(A32, leaves, out) -> None:
    """Launch the combine from ``leaves`` into the same-shaped ``out``."""
    lib = _LIB.lib
    device = next(iter(leaves.values())).device
    stream = torch.cuda.current_stream(device).cuda_stream
    _launch_groups(
        "dif_combine", leaves,
        lambda k: (leaves[k].data_ptr(), None, None, None,
                   out[k].data_ptr(), None, None),
        lambda dt, n, ptrs, m: lib.repro_dif_combine_leaves(
            A32.data_ptr(), A32.shape[0], n, ptrs, m, dt, stream))


def dif_combine(A: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """A: (K, K) combination matrix; phi: (K, M).  Returns (K, M) in phi's
    dtype: ``out[k] = Σ_l A[l, k] φ[l]`` with float32 accumulation."""
    if phi.ndim != 2:
        raise ValueError(f"phi must be (K, M), got shape {tuple(phi.shape)}")
    return dif_combine_leaves(A, {"phi": phi})["phi"]


# ---------------------------------------------------------------------------
# fused_combine_update
# ---------------------------------------------------------------------------

def _check_hyper(mode: str, kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer kind {kind!r}; one of {KINDS}")
    if mode not in MODES:
        raise ValueError(f"unknown combine mode {mode!r}; one of {MODES}")
    return {"sgd": 0, "momentum": 1, "adam": 2}[kind]


def _check_moments(kind: str, n_mom: int, params, mu, nu) -> None:
    """Shapes and dtypes of the moment leaves against the params."""
    given = [m for m in (mu, nu) if m is not None]
    if len(given) != n_mom:
        raise ValueError(
            f"optimizer kind {kind!r} takes exactly {n_mom} moment "
            f"buffer(s); got mu={'set' if mu is not None else None}, "
            f"nu={'set' if nu is not None else None}")
    for mname, tree in zip(("mu", "nu"), given):
        if set(tree) != set(params):
            raise ValueError(f"{mname} leaves {sorted(tree)} do not match "
                             f"params {sorted(params)}")
        for k, m in tree.items():
            if m.shape != params[k].shape:
                raise ValueError(f"{mname} shape {tuple(m.shape)} does not "
                                 f"match params {tuple(params[k].shape)}")
            want = torch.float32 if kind == "adam" else params[k].dtype
            if m.dtype != want:
                raise ValueError(
                    f"{kind} moment {mname} must be {want} (fp32 moments are "
                    f"the fused contract for adam), got {m.dtype}")


def _fused_launch(name, table, scale, params, grads, mu, nu, control, *,
                  mode, kind, lr, b1, b2, eps, weight_decay, beta):
    """Check, allocate ``(params', mu', nu')`` dicts (None: absent) and
    launch the fused kernel over a leaf dict into them; ``control`` is
    ``(sel, ctl, step, step_host, step64, count, every)`` as the C entry
    takes them."""
    K = table.shape[-1]
    for k, p in params.items():
        _check_cuda(name, K, p.dtype, {k: p, f"grads[{k}]": grads[k],
                                       **({f"mu[{k}]": mu[k]} if mu else {}),
                                       **({f"nu[{k}]": nu[k]} if nu else {})})
        if grads[k].dtype != p.dtype:
            raise ValueError(f"{name}: grads[{k}] must be {p.dtype}, got "
                             f"{grads[k].dtype}")
    for tname, t, dt in (("table", table, torch.float32),
                         ("scale", scale, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be contiguous {dt}")
    if scale is not None and scale.numel() != K:
        raise ValueError(f"{name}: scale must hold K={K} values, got "
                         f"{tuple(scale.shape)}")
    new = tuple(None if tree is None else
                {k: torch.empty_like(x) for k, x in tree.items()}
                for tree in (params, mu, nu))
    _fused_into(table, scale, params, grads, mu, nu, new, control,
                mode=mode, kind=kind, lr=lr, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, beta=beta)
    return new


def _fused_into(table, scale, params, grads, mu, nu, new, control, *,
                mode, kind, lr, b1, b2, eps, weight_decay, beta) -> None:
    """Launch the fused kernel into the same-shaped dicts ``new``."""
    lib = _LIB.lib
    new_p, new_mu, new_nu = new
    sel, ctl, step, step_host, step64, count, every = control
    K = table.shape[-1]
    device = next(iter(params.values())).device
    stream = torch.cuda.current_stream(device).cuda_stream

    def pointers(k):
        return (params[k].data_ptr(), grads[k].data_ptr(),
                _ptr(mu and mu[k]), _ptr(nu and nu[k]), new_p[k].data_ptr(),
                _ptr(new_mu and new_mu[k]), _ptr(new_nu and new_nu[k]))

    _launch_groups("fused_combine_update", params, pointers,
                   lambda dt, n, ptrs, m: lib.repro_fused_update_leaves(
                       table.data_ptr(), _ptr(sel), _ptr(ctl), _ptr(step),
                       step_host, step64, _ptr(count), table.shape[0], every,
                       _ptr(scale), K, n, ptrs, m, dt, KINDS.index(kind),
                       MODES.index(mode), -lr, b1, 1 - b1, b2, 1 - b2, eps,
                       lr * weight_decay, beta, stream))


def fused_combine_update_leaves(table, scale, params, grads, mu=None,
                                nu=None, *, step, count=None, every: int = 1,
                                mode: str = "atc", kind: str = "adam",
                                lr: float, b1: float = 0.9, b2: float = 0.999,
                                eps: float = 1e-8, weight_decay: float = 0.0,
                                beta: float = 0.9):
    """One-pass combine-then-update over dicts of (K, ...) leaves: one launch
    per dtype group, each leaf read and written in its own shape.

    ``table``  (S, K, K) float32 stacked schedule (S=1 for a static graph);
               unread for ``mode='local'``.
    ``scale``  (K, 1) float32 per-agent clip scale, or None for no clip.
    ``step``   the schedule step: a host int or a 0-d int32/int64 tensor on
               the leaves' device.  The kernel takes row ``step % S`` and,
               for atc/consensus, mixes when ``step % every == every - 1``
               (the CommSchedule gate), else keeps the identity.
    ``count``  adam: its step count before this update (0-d int32 tensor on
               the device); the bias corrections use ``t = count + 1``.
    ``params``/``grads``  leaf dicts, each leaf f32 or bf16, grads as params.
    ``mu``/``nu``  leaf dicts: both fp32 for ``kind='adam'``; ``mu`` the
               velocity (param dtype) for ``'momentum'``; neither for
               ``'sgd'``.

    Returns ``(new_params, new_mu, new_nu)`` dicts, None for absent moments.
    """
    name = "fused_combine_update"
    n_mom = _check_hyper(mode, kind)
    K = _agents(name, params)
    if set(grads) != set(params):
        raise ValueError(f"grads leaves {sorted(grads)} do not match params "
                         f"{sorted(params)}")
    for k, p in params.items():
        if grads[k].shape != p.shape:
            raise ValueError(f"grads shape {tuple(grads[k].shape)} does not "
                             f"match params {tuple(p.shape)}")
    if table.ndim != 3 or tuple(table.shape[1:]) != (K, K):
        raise ValueError(
            f"schedule table shape {tuple(table.shape)} does not match the "
            f"K={K} stacked agents of the params; need (S, {K}, {K})")
    _check_moments(kind, n_mom, params, mu, nu)
    if kind == "adam" and count is None:
        raise ValueError("adam needs its step count (count=) for the bias "
                         "corrections")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    device = next(iter(params.values())).device
    dev_step = isinstance(step, torch.Tensor)
    _check_same_device(name, device, {
        "table": table, "scale": scale, "count": count,
        "step": step if dev_step else None,
        **{f"{t}[{k}]": x for t, tree in (("params", params),
                                          ("grads", grads), ("mu", mu),
                                          ("nu", nu)) if tree
           for k, x in tree.items()}})
    hyper = dict(mode=mode, kind=kind, lr=lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, beta=beta)
    if device.type == "cpu":
        return fused_update_leaves_ref(table, scale, params, grads, mu, nu,
                                       step=step, count=count, every=every,
                                       **hyper)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if dev_step and (step.numel() != 1 or step.dtype not in (torch.int32,
                                                             torch.int64)):
        raise ValueError(f"{name}: a device step must be one int32 or int64 "
                         f"value, got {step.dtype} {tuple(step.shape)}")
    if count is not None and (count.numel() != 1
                              or count.dtype != torch.int32):
        raise ValueError(f"{name}: count must be one int32 value, got "
                         f"{count.dtype} {tuple(count.shape)}")
    control = (None, None, step if dev_step else None,
               0 if dev_step else int(step),
               int(dev_step and step.dtype == torch.int64), count, every)
    return _fused_launch(name, table, scale, params, grads, mu, nu, control,
                         **hyper)


def fused_combine_update(table, sel, ctl, scale, params, grads, mu=None,
                         nu=None, *, mode: str = "atc", kind: str = "adam",
                         lr: float, b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, weight_decay: float = 0.0,
                         beta: float = 0.9):
    """One-pass combine-then-update over one (K, M) buffer group, the TPU
    kernel's interface (the kernel of :func:`fused_combine_update_leaves`
    on a group of one).

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
    name = "fused_combine_update"
    n_mom = _check_hyper(mode, kind)
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
    wrap = lambda t: None if t is None else {"x": t}
    _check_moments(kind, n_mom, {"x": params}, wrap(mu), wrap(nu))
    _check_same_device(name, params.device, {
        "table": table, "sel": sel, "ctl": ctl, "scale": scale,
        "grads": grads, "mu": mu, "nu": nu})
    hyper = dict(mode=mode, kind=kind, lr=lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, beta=beta)
    if params.device.type == "cpu":
        return fused_update_ref(table, sel, ctl, scale, params, grads, mu,
                                nu, **hyper)
    if params.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {params.device}")
    for tname, t, dt, shape in (("sel", sel, torch.int32, (1, 1)),
                                ("ctl", ctl, torch.float32, (1, 3)),
                                ("scale", scale, torch.float32, (K, 1))):
        if t.dtype != dt:
            raise ValueError(f"{name}: {tname} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got "
                             f"{tuple(t.shape)}")
    _check_cuda(name, K, params.dtype, {"sel": sel, "ctl": ctl})
    new_p, new_mu, new_nu = _fused_launch(
        name, table, scale, {"x": params}, {"x": grads}, wrap(mu), wrap(nu),
        (sel, ctl, None, 0, 0, None, 1), **hyper)
    return (new_p["x"], new_mu and new_mu["x"], new_nu and new_nu["x"])
