"""Fused combine-then-update outer step: one kernel launch per dtype group
of the parameter leaves (port of ``repro/core/fused.py``).

One :func:`repro_torch.kernels.dif_combine.ops.fused_combine_update_leaves`
call replaces the trainer's unfused ``clip → opt.update → strategy.apply``
chain — params, grads and moments are each read once and written once per
step, every leaf in its own shape (no padding, no packing).  The reference
launches per leaf because XLA fuses a step into one program; eager PyTorch
does not, so the port's kernel walks all leaves of a dtype in one launch.
The only pre-kernel work is the global-norm reduction (the clip scale must
exist before any column is updated).  The control stays on the device: the
kernel derives the schedule row ``step % S``, the CommSchedule gate and the
Adam bias corrections from the step (a host int, passed in the launch's
parameters, or a 0-d device tensor) and the optimizer's device step count,
so nothing is read back to the host and a CUDA graph can capture the call
with the step as a device tensor that the graph advances.

Qualification (:func:`fused_unsupported_reason`): the optimizer must carry
a :class:`repro_torch.optim.FusedSpec` and the strategy must be one of
atc / consensus / centralized / cta / none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.diffusion import Params
from repro_torch.device import resolve_device
from repro_torch.optim import global_norm_scale
from repro_torch.optim.optimizers import AdamState, MomentumState, Optimizer

# DiffusionStrategy -> kernel combine mode.  cta mixes *before* the
# gradient (the pre-combine runs through a combine backend); its post-step,
# like 'none', is the plain local update.  centralized is uniform-ATC.
_STRATEGY_MODES = {"atc": "atc", "consensus": "consensus",
                   "centralized": "atc", "cta": "local", "none": "local"}


def fused_unsupported_reason(opt: Optimizer, strategy: str) -> str | None:
    """Why (opt, strategy) cannot take the fused path — None when it can."""
    if opt.fused is None:
        return ("optimizer does not expose a FusedSpec (custom Optimizer "
                "instances must declare their per-leaf scalar math to run "
                "in-kernel); use sgd/momentum/adam/adamw or backend='dense'")
    if strategy not in _STRATEGY_MODES:
        return (f"diffusion strategy {strategy!r} has no fused composition; "
                f"supported: {tuple(_STRATEGY_MODES)}")
    return None


def make_fused_outer(opt: Optimizer, strategy: str, comm, A,
                     *, grad_clip: float | None = None,
                     num_agents: int | None = None, device=None):
    """Build ``outer(params, grads, opt_state, step) -> (params, opt_state)``
    — the fused replacement for the trainer's post-gradient block.

    ``comm``: a :class:`repro_torch.core.update.CommSchedule`; ``A``: one
    (K, K) matrix or a stacked (S, K, K) schedule (ignored for local-mode
    strategies); ``step`` is the schedule step, a host int or a 0-d int
    tensor on the device.  Raises
    ``ValueError`` when (opt, strategy) do not qualify.
    """
    from repro_torch.kernels.dif_combine.ops import \
        fused_combine_update_leaves

    reason = fused_unsupported_reason(opt, strategy)
    if reason is not None:
        raise ValueError(f"fused outer update unavailable: {reason}")
    device = resolve_device(device)
    spec = opt.fused
    mode = _STRATEGY_MODES[strategy]

    An = np.asarray(A, np.float32) if A is not None else None
    if mode == "local":
        K = num_agents or (An.shape[-1] if An is not None else 1)
        table = np.eye(K, dtype=np.float32)[None]          # unread
    elif strategy == "centralized":
        K = num_agents or (An.shape[-1] if An is not None else None)
        if K is None:
            raise ValueError("fused centralized strategy needs num_agents "
                             "or a matrix to size the uniform table")
        table = np.full((1, K, K), 1.0 / K, np.float32)
    else:
        if An is None:
            raise ValueError(f"fused strategy {strategy!r} needs the "
                             f"combination matrix/schedule A")
        table = An[None] if An.ndim == 2 else An
        K = table.shape[-1]
    if num_agents is not None and K != num_agents:
        raise ValueError(
            f"combination table is over K={K} agents but the trainer runs "
            f"num_agents={num_agents}")
    tab = torch.as_tensor(table, device=device)
    hyper = dict(mode=mode, kind=spec.kind, lr=spec.lr, b1=spec.b1,
                 b2=spec.b2, eps=spec.eps, weight_decay=spec.weight_decay,
                 beta=spec.beta)

    def outer(params: Params, grads: Params, opt_state, step):
        scale = None
        if grad_clip is not None:      # 0.0 is a valid (total) clip
            scale = torch.func.vmap(
                lambda g: global_norm_scale(g, grad_clip))(grads)
            scale = scale.reshape(K, 1).float()
        if spec.kind == "adam":
            moments = dict(mu=opt_state.mu, nu=opt_state.nu,
                           count=opt_state.step)
        elif spec.kind == "momentum":
            moments = dict(mu=opt_state.velocity)
        else:
            moments = {}
        new_params, mu, nu = fused_combine_update_leaves(
            tab, scale, params, grads, step=step, every=comm.every,
            **moments, **hyper)
        if spec.kind == "adam":
            new_state = AdamState(opt_state.step + 1, mu, nu)
        elif spec.kind == "momentum":
            new_state = MomentumState(mu)
        else:
            new_state = opt_state
        return new_params, new_state

    return outer


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nest of dicts, tuples and named tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def capture_outer(outer, params: Params, grads: Params, opt_state,
                  step: torch.Tensor):
    """Capture one ``outer(params, grads, opt_state, step)`` call in a CUDA
    graph.  Each replay reads ``grads`` from their buffers, writes the new
    params and optimizer state into the tensors of ``params`` and
    ``opt_state``, and advances ``step`` (a 0-d int tensor on the card) by
    one, so the schedule row, the gate and the bias corrections of each
    replay are the step's.  Returns ``replay()``."""
    if not (isinstance(step, torch.Tensor) and step.numel() == 1
            and step.device.type == "cuda"):
        raise ValueError("capture_outer needs the step as a 0-d tensor on "
                         "the card")
    state = _tensors(opt_state)

    def body():
        new_params, new_state = outer(params, grads, opt_state, step)
        for k, p in params.items():
            p.copy_(new_params[k])
        for old, new in zip(state, _tensors(new_state)):
            if new is not old:
                old.copy_(new)
        step.add_(1)

    side = torch.cuda.Stream(step.device)
    side.wait_stream(torch.cuda.current_stream(step.device))
    with torch.cuda.stream(side):       # build, load and warm the kernels
        outer(params, grads, opt_state, step)
    torch.cuda.current_stream(step.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay
