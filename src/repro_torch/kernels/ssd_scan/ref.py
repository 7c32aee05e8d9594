"""Plain PyTorch versions of the SSD scan kernels.

:func:`ssd_scan_ref` is the JAX package's
``kernels/ssd_scan/ref.py::ssd_scan_ref`` copied, the naive per-step
recurrence (independent of the chunked formulation, so it cross-checks the
SSD math itself):

  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ        y_t = C_t · h_t

The scan's wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds the
kernels against it on the card.  :func:`chunk_state_ref`,
:func:`state_pass_ref` and :func:`chunk_scan_ref` are the plain versions of
the three kernels of the bfloat16 route, one a pass, and
:func:`split_hi_lo` the bf16 pair that carries a float32 state between the
last two.  :func:`ssd_scan_tangent_ref` is the plain version of the
forward-mode tangent kernel: ``torch.func.jvp`` of :func:`ssd_scan_ref`
with B and C read by group.
"""
from __future__ import annotations

import torch

__all__ = ["chunk_scan_ref", "chunk_state_ref", "split_hi_lo",
           "ssd_scan_ref", "ssd_scan_tangent_ref", "state_pass_ref"]


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


def ssd_scan_tangent_ref(x, dt, A, Bg, Cg, tx, tdt, tA, tB, tC
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y', final_state'): ``torch.func.jvp`` of :func:`ssd_scan_ref` at
    (x, dt, A, Bg, Cg) along their tangents, Bg/Cg (B,L,G,N) read by group
    (repeated to heads inside the function).  Both float32."""
    rep = x.shape[2] // Bg.shape[2]

    def scan(x, dt, A, Bg, Cg):
        return ssd_scan_ref(x, dt, A, Bg.repeat_interleave(rep, dim=2),
                            Cg.repeat_interleave(rep, dim=2))

    return torch.func.jvp(scan, *(tuple(t.contiguous() for t in ts) for ts
                                  in ((x, dt, A, Bg, Cg),
                                      (tx, tdt, tA, tB, tC))))[1]


# ---------------------------------------------------------------------------
# The three passes of the bfloat16 Hopper route, one plain version each.
# Composed (chunk_state_ref -> state_pass_ref -> chunk_scan_ref) they are
# the chunked scan; B and C are read by group (C·Bᵀ once per group).
# ---------------------------------------------------------------------------

def _per_sequence(A: torch.Tensor, B: int) -> torch.Tensor:
    """A (H,) or (B, H) as (B, H) float32."""
    A = A.float()
    return A.expand(B, A.shape[-1]) if A.ndim == 1 else A


def chunk_state_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bg: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1.  x (B,L,H,P), dt (B,L,H), A (H,) or (B,H), Bg (B,L,G,N).
    Returns (S (B,nc,H,P,N), seg (B,H,L)), both float32: seg the inclusive
    cumsum of dt·A within each chunk, S each chunk's own state
    ``Σ_k exp(seg_end - seg_k) dt_k x_k B_kᵀ``."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc = L // chunk
    dtc = dt.float().reshape(B, nc, chunk, H)
    seg = torch.cumsum(dtc * _per_sequence(A, B)[:, None, None, :], dim=2)
    w = torch.exp(seg[:, :, -1:] - seg) * dtc                # (B,nc,c,H)
    S = torch.einsum("bckgr,bckgrp,bckgn->bcgrpn",
                     w.reshape(B, nc, chunk, G, H // G),
                     x.float().reshape(B, nc, chunk, G, H // G, P),
                     Bg.float().reshape(B, nc, chunk, G, N))
    return (S.reshape(B, nc, H, P, N),
            seg.permute(0, 3, 1, 2).reshape(B, H, L))


def state_pass_ref(S: torch.Tensor, seg: torch.Tensor, chunk: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2.  S (B,nc,H,P,N) and seg (B,H,L) from pass 1.  Returns (the
    states entering chunks 1 .. nc-1 (B,nc-1,H,P,N), the final state
    (B,H,P,N)), float32: ``s_in[c+1] = exp(seg_end_c) s_in[c] + S_c`` from
    ``s_in[0] = 0``."""
    B, nc, H, P, N = S.shape
    decay = torch.exp(seg.reshape(B, H, nc, chunk)[..., -1])  # (B,H,nc)
    s = torch.zeros(B, H, P, N, dtype=torch.float32, device=S.device)
    entering = []
    for c in range(nc):
        if c:
            entering.append(s)
        s = decay[:, :, c, None, None] * s + S[:, c]
    empty = S.new_zeros(B, 0, H, P, N)
    return (torch.stack(entering, 1) if entering else empty), s


def chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, seg: torch.Tensor,
                   Bg: torch.Tensor, Cg: torch.Tensor, s_in: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """Pass 3.  x (B,L,H,P), dt (B,L,H), seg (B,H,L) from pass 1, Bg/Cg
    (B,L,G,N), s_in (B,nc-1,H,P,N) float32 from pass 2.  Returns y
    (B,L,H,P) in x's dtype: ``M x + exp(seg_q) C s_inᵀ`` with ``M = C·Bᵀ ⊙
    exp(seg_q - seg_k)[k <= q] ⊙ dt_k``, C·Bᵀ formed once per group and the
    exponential taken of the masked difference."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    xc = x.float().reshape(B, nc, chunk, G, r, P)
    dtc = dt.float().reshape(B, nc, chunk, G, r)
    sg = seg.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
    Bc, Cc = (t.float().reshape(B, nc, chunk, G, N) for t in (Bg, Cg))
    cb = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)          # per group
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[:, :, None, None]
    diff = sg[:, :, :, None] - sg[:, :, None, :]             # (B,nc,q,k,G,r)
    M = (cb[..., None] * torch.exp(torch.where(causal, diff, -torch.inf))
         * dtc[:, :, None])
    y = torch.einsum("bcqkgr,bckgrp->bcqgrp", M, xc)
    s_in = torch.cat([s_in.new_zeros(B, 1, H, P, N), s_in.float()], 1)
    y = y + torch.exp(sg)[..., None] * torch.einsum(
        "bcqgn,bcgrpn->bcqgrp", Cc, s_in.reshape(B, nc, G, r, P, N))
    return y.reshape(B, L, H, P).to(x.dtype)


def split_hi_lo(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 tensor as two bfloat16 tensors, hi = bf16(s) and lo =
    bf16(s - hi), whose float32 sum keeps about 16 significant bits of s:
    how pass 2 hands the entering states to the tensor cores of pass 3."""
    hi = s.to(torch.bfloat16)
    return hi, (s - hi.float()).to(torch.bfloat16)
