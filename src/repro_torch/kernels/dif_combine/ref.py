"""Plain PyTorch versions of the combine and combine-then-update kernels
(port of ``repro/kernels/dif_combine/ref.py``), over one (K, M) buffer and
over dicts of (K, ...) leaves.

On CPU tensors the wrappers in :mod:`.ops` compute with these; on the card
``chip_smoke.py`` and the CUDA tests hold each kernel against them."""
from __future__ import annotations

import torch

from repro_torch.optim import optimizers as om


def dif_combine_ref(A: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """out[k] = Σ_l A[l, k] φ[l]  (float32 accumulation)."""
    out = torch.einsum("lk,lm->km", A.float(), phi.float())
    return out.to(phi.dtype)


def dif_combine_leaves_ref(A: torch.Tensor, leaves) -> dict:
    """:func:`dif_combine_ref` on each (K, ...) leaf, flattened to (K, m)."""
    return {k: dif_combine_ref(A, x.reshape(x.shape[0], -1)).reshape(x.shape)
            for k, x in leaves.items()}


def fused_update_ref(table, sel, ctl, scale, params, grads, mu=None, nu=None,
                     *, mode: str = "atc", kind: str = "adam", lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0, beta: float = 0.9):
    """Same math as :func:`.ops.fused_combine_update` in plain torch (fp32
    throughout, identity-blend gating).  Takes/returns the same (K, M)
    buffers and ``(w', mu', nu')`` tuple."""
    w32 = params.float()
    g32 = grads.float() * scale.float()
    new_mu = new_nu = None
    if kind == "adam":
        bc1, bc2 = ctl[0, 1], ctl[0, 2]
        new_mu = om.adam_mu(mu, g32, b1)
        new_nu = om.adam_nu(nu, g32, b2)
        u = om.adam_direction(new_mu, new_nu, bc1, bc2, lr=lr, eps=eps,
                              weight_decay=weight_decay, p32=w32)
    elif kind == "momentum":
        v = om.momentum_velocity(mu.float(), g32, beta)
        u = om.momentum_direction(v, lr=lr)
        new_mu = v.to(mu.dtype)
    else:
        u = om.sgd_direction(g32, lr=lr)
    if mode == "local":
        new = w32 + u
    else:
        K = params.shape[0]
        # the selected row, gathered on the device (no host round trip)
        A = torch.index_select(table.float(), 0,
                               sel.reshape(1).long()).reshape(K, K)
        gate = ctl[0, 0]
        eye = torch.eye(K, dtype=torch.float32, device=params.device)
        A_eff = gate * A + (1.0 - gate) * eye
        phi = w32 + u if mode == "atc" else w32
        mixed = torch.einsum("lk,lm->km", A_eff, phi)
        new = mixed if mode == "atc" else mixed + u
    return new.to(params.dtype), new_mu, new_nu


def step_control(step, S: int, every: int, count=None, *, b1: float = 0.9,
                 b2: float = 0.999, device=None):
    """``(sel, ctl)`` of the single-buffer interface from a step counter, as
    the fused kernel derives them: ``sel = step % S``; the gate is 1 when
    ``step % every == every - 1``; the Adam bias corrections from
    ``t = count + 1`` as the optimizer evaluates them (1 without ``count``).
    ``step`` may be a host int or a 0-d tensor."""
    if isinstance(step, torch.Tensor):
        step = step.reshape(1, 1).long()
    else:       # a fill, not a host copy: a CUDA graph can capture it
        step = torch.full((1, 1), step, dtype=torch.long, device=device)
    sel = torch.remainder(step, S).int()
    gate = (torch.remainder(step, every) == every - 1).float().reshape(1)
    if count is None:
        bc1 = bc2 = torch.ones(1, device=step.device)
    else:
        t = (count + 1).float().reshape(1)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    return sel, torch.cat([gate, bc1, bc2]).reshape(1, 3)


def fused_update_leaves_ref(table, scale, params, grads, mu=None, nu=None,
                            *, step, count=None, every: int = 1,
                            mode: str = "atc", kind: str = "adam", lr: float,
                            b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8, weight_decay: float = 0.0,
                            beta: float = 0.9):
    """:func:`fused_update_ref` on each (K, ...) leaf, with the row, gate and
    bias corrections from :func:`step_control`.  ``scale`` None is no clip.
    Returns ``(params', mu', nu')`` dicts, None for absent moments."""
    K = table.shape[-1]
    device = table.device
    sel, ctl = step_control(step, table.shape[0], every,
                            count if kind == "adam" else None, b1=b1, b2=b2,
                            device=device)
    if scale is None:
        scale = torch.ones(K, 1, device=device)
    hyper = dict(mode=mode, kind=kind, lr=lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, beta=beta)
    out = {}
    for k, p in params.items():
        flat = lambda x: None if x is None else x.reshape(K, -1)
        res = fused_update_ref(table, sel, ctl, scale.reshape(K, 1), flat(p),
                               flat(grads[k]), flat(mu and mu[k]),
                               flat(nu and nu[k]), **hyper)
        out[k] = [None if r is None else r.reshape(p.shape) for r in res]
    pick = lambda i: ({k: r[i] for k, r in out.items()}
                      if out and next(iter(out.values()))[i] is not None
                      else None)
    return pick(0), pick(1), pick(2)
