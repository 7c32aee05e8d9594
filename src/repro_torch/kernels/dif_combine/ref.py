"""Plain PyTorch versions of the combine and combine-then-update kernels
(port of ``repro/kernels/dif_combine/ref.py``).

On CPU tensors the wrappers in :mod:`.ops` compute with these; on the card
``chip_smoke.py`` and the CUDA tests hold each kernel against them."""
from __future__ import annotations

import torch

from repro_torch.optim import optimizers as om


def dif_combine_ref(A: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """out[k] = Σ_l A[l, k] φ[l]  (float32 accumulation)."""
    out = torch.einsum("lk,lm->km", A.float(), phi.float())
    return out.to(phi.dtype)


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
