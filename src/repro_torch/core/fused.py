"""Fused combine-then-update outer step: one kernel launch per leaf (port of
``repro/core/fused.py``).

One :func:`repro_torch.kernels.dif_combine.ops.fused_combine_update` launch
per parameter leaf replaces the trainer's unfused ``clip → opt.update →
strategy.apply`` chain — params, grads and moments are each read once and
written at most once per step.  The only pre-kernel work is the global-norm
reduction (the clip scale must exist before any column is updated) and the
control scalars, which stay on the device: the schedule row ``sel`` is a
view into a device table of row indices, the CommSchedule gate a view into
a device ``[0, 1]`` pair chosen by the host-side step, and the Adam bias
corrections come from the device step counter.  Nothing is read back to
the host.

Leaves are flattened to (K, m) and zero-padded by
:func:`repro_torch.core.diffusion.pad_geometry` — the same rule the packed
``pallas`` path uses; the kernel keeps padded columns at zero, and the pad
is sliced off on the way out.

Qualification (:func:`fused_unsupported_reason`): the optimizer must carry
a :class:`repro_torch.optim.FusedSpec` and the strategy must be one of
atc / consensus / centralized / cta / none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.diffusion import Params, pad_geometry
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
                     num_agents: int | None = None, block_m: int = 512,
                     device=None):
    """Build ``outer(params, grads, opt_state, step) -> (params, opt_state)``
    — the fused replacement for the trainer's post-gradient block.

    ``comm``: a :class:`repro_torch.core.update.CommSchedule`; ``A``: one
    (K, K) matrix or a stacked (S, K, K) schedule (ignored for local-mode
    strategies); ``step`` is the host-side step counter.  Raises
    ``ValueError`` when (opt, strategy) do not qualify.
    """
    from repro_torch.kernels.dif_combine.ops import fused_combine_update

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
    S = table.shape[0]
    tab = torch.as_tensor(table, device=device)
    sel_rows = torch.arange(S, dtype=torch.int32,
                            device=device).reshape(S, 1, 1)
    gates = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
    ones = torch.ones((K, 1), dtype=torch.float32, device=device)
    hyper = dict(mode=mode, kind=spec.kind, lr=spec.lr, b1=spec.b1,
                 b2=spec.b2, eps=spec.eps, weight_decay=spec.weight_decay,
                 beta=spec.beta)

    def outer(params: Params, grads: Params, opt_state, step: int):
        if grad_clip is not None:      # 0.0 is a valid (total) clip
            scale = torch.func.vmap(
                lambda g: global_norm_scale(g, grad_clip))(grads)
            scale = scale.reshape(K, 1).float()
        else:
            scale = ones
        sel = sel_rows[step % S]
        gate = gates[int(mode != "local" and comm.is_comm_step(step))]
        if spec.kind == "adam":
            t = (opt_state.step + 1).float()
            bc1, bc2 = 1 - spec.b1 ** t, 1 - spec.b2 ** t
        else:
            bc1 = bc2 = gates[1]
        ctl = torch.stack([gate, bc1, bc2]).reshape(1, 3)

        if spec.kind == "adam":
            mom_trees = (opt_state.mu, opt_state.nu)
        elif spec.kind == "momentum":
            mom_trees = (opt_state.velocity,)
        else:
            mom_trees = ()

        def leaf(p, g, *ms):
            m = int(np.prod(p.shape[1:], dtype=np.int64))
            m_pad, _ = pad_geometry(m, block_m)

            def prep(x):
                x = x.reshape(K, m)
                if m_pad != m:
                    x = torch.nn.functional.pad(x, (0, m_pad - m))
                return x.contiguous()

            outs = fused_combine_update(tab, sel, ctl, scale, prep(p),
                                        prep(g), *(prep(x) for x in ms),
                                        **hyper)
            # absent moment outputs (None) fall off the end of the zip
            return tuple(o[:, :m].reshape(ref.shape)
                         for o, ref in zip(outs, (p,) + ms))

        results = {k: leaf(p, grads[k], *(t[k] for t in mom_trees))
                   for k, p in params.items()}
        new_params = {k: r[0] for k, r in results.items()}
        if spec.kind == "adam":
            new_state = AdamState(
                opt_state.step + 1,
                {k: r[1] for k, r in results.items()},
                {k: r[2] for k, r in results.items()})
        elif spec.kind == "momentum":
            new_state = MomentumState({k: r[1] for k, r in results.items()})
        else:
            new_state = opt_state
        return new_params, new_state

    return outer
