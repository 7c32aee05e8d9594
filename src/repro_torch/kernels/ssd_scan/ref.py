"""Plain PyTorch version of the SSD scan kernel: the JAX package's
``kernels/ssd_scan/ref.py::ssd_scan_ref`` copied, the naive per-step
recurrence (independent of the chunked formulation, so it cross-checks the
SSD math itself):

  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ        y_t = C_t · h_t

The kernel wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref"]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,L,H,P); dt: (B,L,H); A: (H,) or per sequence (B,H); Bm/Cm:
    (B,L,H,N) (head-expanded).  Returns (y (B,L,H,P), final_state
    (B,H,P,N)), both float32."""
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dtt = dt[:, t]                                      # (B,H)
        decay = torch.exp(dtt * A)[..., None, None]         # (B,H,1,1)
        upd = dtt[..., None, None] * torch.einsum("bhp,bhn->bhpn", x[:, t],
                                                  Bm[:, t])
        h = h * decay + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h
