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
forward-mode tangent T3: ``torch.func.jvp`` of :func:`ssd_scan_ref` with B
and C read by group.  :func:`tangent_state_ref`, :func:`tangent_pass_ref`
and :func:`tangent_scan_ref` are the plain versions of T3's three bfloat16
kernels, the passes above with the tangent plane carried beside each.
"""
from __future__ import annotations

import torch

__all__ = ["chunk_scan_ref", "chunk_state_ref", "split_hi_lo",
           "ssd_scan_ref", "ssd_scan_tangent_ref", "state_pass_ref",
           "tangent_pass_ref", "tangent_scan_ref", "tangent_state_ref"]


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


# ---------------------------------------------------------------------------
# T3's three passes (bfloat16 route), one plain version each: the passes
# above with the tangent of every chunk quantity beside it.  Composed
# (tangent_state_ref -> tangent_pass_ref -> tangent_scan_ref) they equal
# ssd_scan_tangent_ref.  With seg' the cumsum of a' = dt' A + dt A' and w_k =
# exp(seg_end - seg_k), the tangent of w_k is w_k (seg'_end - seg'_k).
# ---------------------------------------------------------------------------

def tangent_state_ref(x, dt, A, Bg, tx, tdt, tA, tB, chunk: int):
    """Pass 1.  The primals as :func:`chunk_state_ref`, their tangents
    shaped alike.  Returns (S, S' (B,nc,H,P,N), seg, seg' (B,H,L)), float32:
    ``S' = Σ_k [u'_k x_k + u_k x'_k] B_kᵀ + u_k x_k B'_kᵀ`` with ``u_k = w_k
    dt_k`` and ``u'_k = w_k ((seg'_end - seg'_k) dt_k + dt'_k)``."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    dtc, tdtc = (t.float().reshape(B, nc, chunk, H) for t in (dt, tdt))
    a = _per_sequence(A, B)[:, None, None, :]
    ta = _per_sequence(tA, B)[:, None, None, :]
    seg = torch.cumsum(dtc * a, dim=2)
    tseg = torch.cumsum(tdtc * a + dtc * ta, dim=2)
    w = torch.exp(seg[:, :, -1:] - seg)
    u = (w * dtc).reshape(B, nc, chunk, G, r)
    tu = (w * ((tseg[:, :, -1:] - tseg) * dtc + tdtc)).reshape(
        B, nc, chunk, G, r)
    xs, txs = (t.float().reshape(B, nc, chunk, G, r, P) for t in (x, tx))
    bs, tbs = (t.float().reshape(B, nc, chunk, G, N) for t in (Bg, tB))

    def state(u, x, b):
        return torch.einsum("bckgr,bckgrp,bckgn->bcgrpn", u, x, b)

    S = state(u, xs, bs)
    tS = state(tu, xs, bs) + state(u, txs, bs) + state(u, xs, tbs)

    def per_head(s):
        return s.permute(0, 3, 1, 2).reshape(B, H, L)

    return (S.reshape(B, nc, H, P, N), tS.reshape(B, nc, H, P, N),
            per_head(seg), per_head(tseg))


def tangent_pass_ref(S, tS, seg, tseg, chunk: int):
    """Pass 2.  From pass 1's outputs: (the states entering chunks 1 ..
    nc-1 and their tangents (B,nc-1,H,P,N), the final state's tangent
    (B,H,P,N)), float32: ``s'_in[c+1] = exp(seg_end_c) (seg'_end_c s_in[c]
    + s'_in[c]) + S'_c`` beside :func:`state_pass_ref`'s recurrence."""
    B, nc, H, P, N = S.shape
    ends = seg.reshape(B, H, nc, chunk)[..., -1]
    decay = torch.exp(ends)[..., None, None]                 # (B,H,nc,1,1)
    tend = tseg.reshape(B, H, nc, chunk)[..., -1, None, None]
    s = torch.zeros(B, H, P, N, dtype=torch.float32, device=S.device)
    ts = torch.zeros_like(s)
    entering, tentering = [], []
    for c in range(nc):
        if c:
            entering.append(s)
            tentering.append(ts)
        ts = decay[:, :, c] * (tend[:, :, c] * s + ts) + tS[:, c]
        s = decay[:, :, c] * s + S[:, c]
    empty = S.new_zeros(B, 0, H, P, N)
    return (torch.stack(entering, 1) if entering else empty,
            torch.stack(tentering, 1) if tentering else empty, ts)


def tangent_scan_ref(x, dt, seg, Bg, Cg, tx, tdt, tseg, tB, tC, s_in,
                     ts_in, chunk: int) -> torch.Tensor:
    """Pass 3.  y' (B,L,H,P) in x's dtype from pass 1's seg, seg' and pass
    2's entering states and their tangents (float32): ``M1 x + M2 x' +
    exp(seg_q) (seg'_q C s_inᵀ + C' s_inᵀ + C s'_inᵀ)`` with ``M2 = G E dt_k``,
    ``M1 = E [(G' + G (seg'_q - seg'_k)) dt_k + G dt'_k]``, ``G = C·Bᵀ`` and
    ``G' = C'·Bᵀ + C·B'ᵀ`` once per group, E the exponential of the masked
    difference."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    xs, txs = (t.float().reshape(B, nc, chunk, G, r, P) for t in (x, tx))
    dts, tdts = (t.float().reshape(B, nc, chunk, G, r) for t in (dt, tdt))
    sg, tsg = (t.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
               for t in (seg, tseg))
    bs, cs, tbs, tcs = (t.float().reshape(B, nc, chunk, G, N)
                        for t in (Bg, Cg, tB, tC))
    gram = torch.einsum("bcqgn,bckgn->bcqkg", cs, bs)[..., None]
    tgram = (torch.einsum("bcqgn,bckgn->bcqkg", tcs, bs)
             + torch.einsum("bcqgn,bckgn->bcqkg", cs, tbs))[..., None]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[:, :, None, None]
    E = torch.exp(torch.where(causal, sg[:, :, :, None] - sg[:, :, None, :],
                              -torch.inf))                  # (B,nc,q,k,G,r)
    tdiff = tsg[:, :, :, None] - tsg[:, :, None, :]
    dk, tdk = dts[:, :, None], tdts[:, :, None]
    M1 = E * ((tgram + gram * tdiff) * dk + gram * tdk)
    M2 = E * gram * dk
    y = (torch.einsum("bcqkgr,bckgrp->bcqgrp", M1, xs)
         + torch.einsum("bcqkgr,bckgrp->bcqgrp", M2, txs))

    def full(s):                    # the entering states of chunks 0 .. nc-1
        return torch.cat([s.new_zeros(B, 1, H, P, N), s.float()], 1
                         ).reshape(B, nc, G, r, P, N)

    s_full, ts_full = full(s_in), full(ts_in)
    y0 = torch.einsum("bcqgn,bcgrpn->bcqgrp", cs, s_full)
    y1 = (torch.einsum("bcqgn,bcgrpn->bcqgrp", tcs, s_full)
          + torch.einsum("bcqgn,bcgrpn->bcqgrp", cs, ts_full))
    y = y + torch.exp(sg)[..., None] * (tsg[..., None] * y0 + y1)
    return y.reshape(B, L, H, P).to(x.dtype)


# ---------------------------------------------------------------------------
# The backward's passes (kernel ssd_scan_bwd), one plain version each.
# Composed (bwd_state_ref -> bwd_state_pass_ref -> bwd_chunk_ref) they are
# the VJP of the chunked scan from a zero state, in float32.  Per chunk,
# with seg the in-chunk cumsum of dt·A, E_qk = exp(seg_q - seg_k) (k <= q),
# G = C·Bᵀ, M = G E dt_k, w_k = exp(seg_end - seg_k) and u_k = w_k dt_k:
#
#   y_q   = Σ_k M_qk x_k + exp(seg_q) s_in C_q
#   s_out = exp(seg_end) s_in + Σ_k u_k x_k B_kᵀ
#
# Pass 1 recomputes each chunk's own state and forms its state cotangent
# Σ_q exp(seg_q) gy_q C_qᵀ; pass 2 carries the states forward and their
# cotangents back across chunks; pass 3 forms each chunk's gradients.
# ---------------------------------------------------------------------------

def _chunked(t: torch.Tensor, B: int, nc: int, chunk: int, G: int
             ) -> torch.Tensor:
    """(B, L, H, ...) float32 as (B, nc, c, G, H/G, ...)."""
    return t.float().reshape(B, nc, chunk, G, t.shape[2] // G,
                             *t.shape[3:])


def bwd_state_ref(x, dt, A, Bg, Cg, gy, chunk: int):
    """Pass 1.  x, gy (B,L,H,P), dt (B,L,H), A (H,) or (B,H), Bg/Cg
    (B,L,G,N).  Returns (S, Lc (B,nc,H,P,N), seg (B,H,L)), float32: S and
    seg as :func:`chunk_state_ref`, Lc each chunk's state cotangent from its
    own rows, ``Σ_q exp(seg_q) gy_q C_qᵀ``."""
    S, seg = chunk_state_ref(x, dt, A, Bg, chunk)
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    sg = seg.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
    v = torch.exp(sg)[..., None] * _chunked(gy, B, nc, chunk, G)
    Lc = torch.einsum("bcqgrp,bcqgn->bcgrpn", v,
                      Cg.float().reshape(B, nc, chunk, G, N))
    return S, Lc.reshape(B, nc, H, P, N), seg


def bwd_state_pass_ref(S, Lc, seg, gs, chunk: int):
    """Pass 2.  S, Lc and seg from pass 1, gs (B,H,P,N) the final state's
    cotangent.  Returns (s_in, gO (B,nc,H,P,N), sg (B,H,nc)), float32: the
    state entering each chunk (zero for the first), the cotangent of the
    state leaving it (``gO[nc-1] = gs``, ``gO[c-1] = exp(seg_end_c) gO[c] +
    Lc[c]``) and their inner product per chunk."""
    B, nc, H, P, N = S.shape
    decay = torch.exp(seg.reshape(B, H, nc, chunk)[..., -1])[..., None, None]
    s = torch.zeros(B, H, P, N, dtype=torch.float32, device=S.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c] * s + S[:, c]
    g, gO = gs.float(), [None] * nc
    for c in reversed(range(nc)):
        gO[c] = g
        g = decay[:, :, c] * g + Lc[:, c]
    s_in, gO = torch.stack(s_in, 1), torch.stack(gO, 1)
    return s_in, gO, (s_in * gO).sum((-2, -1)).transpose(1, 2)


def bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, chunk: int):
    """Pass 3.  The inputs as :func:`bwd_state_ref`'s, seg from pass 1 and
    s_in, gO, sg from pass 2.  Returns (dx (B,L,H,P) in x's dtype, ddt
    (B,L,H) float32, dA float32 shaped as A, dB, dC (B,L,G,N) in their
    dtypes): the causal c x c tiles D = gy xᵀ, Z = D E dt_k and R = D ⊙ M
    give dx = Mᵀ gy + u_k gO B_k, dC = Z B + exp(seg_q) gy s_in, dB = Zᵀ C
    + u_k gOᵀ x (summed over a group's heads), and dseg (row sums of R less
    its column sums, plus the state terms), whose reverse cumsum within the
    chunk gives ddt = (direct terms) + A·rcs and dA = Σ dt·rcs (over L, and
    over B where A is (H,))."""
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc, r = L // chunk, H // G
    xs, gys = _chunked(x, B, nc, chunk, G), _chunked(gy, B, nc, chunk, G)
    dts = dt.float().reshape(B, nc, chunk, G, r)
    sgm = seg.reshape(B, G, r, nc, chunk).permute(0, 3, 4, 1, 2)
    bs, cs = (t.float().reshape(B, nc, chunk, G, N) for t in (Bg, Cg))
    sin, go = (t.reshape(B, nc, G, r, P, N) for t in (s_in, gO))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[:, :, None, None]
    E = torch.exp(torch.where(causal, sgm[:, :, :, None] - sgm[:, :, None],
                              -torch.inf))                 # (B,nc,q,k,G,r)
    gram = torch.einsum("bcqgn,bckgn->bcqkg", cs, bs)[..., None]
    D = torch.einsum("bcqgrp,bckgrp->bcqkgr", gys, xs)
    GE = gram * E
    M = GE * dts[:, :, None]
    Z = D * E * dts[:, :, None]
    # R's diagonal enters dseg_q once as a row sum and once, negated, as a
    # column sum: it is left out of both (in float32 the two would not
    # cancel where seg falls steeply), as T_k of the last row below
    R = D * M * ~torch.eye(chunk, dtype=torch.bool, device=x.device
                           )[:, :, None, None]
    w = torch.exp(sgm[:, :, -1:] - sgm)                    # (B,nc,c,G,r)
    u = w * dts
    v = torch.einsum("bckgn,bcgrpn->bckgrp", bs, go)       # gO B_k
    xv = (xs * v).sum(-1)
    dx = torch.einsum("bcqkgr,bcqgrp->bckgrp", M, gys) + u[..., None] * v
    wq = torch.einsum("bcqgrp,bcgrpn->bcqgrn", gys, sin)   # gy_q s_in
    es = torch.exp(sgm)
    dC = (torch.einsum("bcqkgr,bckgn->bcqgrn", Z, bs)
          + es[..., None] * wq).sum(4)
    dB = (torch.einsum("bcqkgr,bcqgn->bckgrn", Z, cs)
          + u[..., None] * torch.einsum("bckgrp,bcgrpn->bckgrn", xs, go)
          ).sum(4)
    T = torch.cat([u[:, :, :-1] * xv[:, :, :-1],
                   torch.zeros_like(u[:, :, -1:])], 2)
    dseg = (R.sum(3) - R.sum(2)
            + es * (cs[:, :, :, :, None] * wq).sum(-1) - T)
    end = T.sum(2) + torch.exp(sgm[:, :, -1]) * sg.reshape(
        B, G, r, nc).permute(0, 3, 1, 2)
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + end[:, :, None]], 2)
    rcs = dseg.flip(2).cumsum(2).flip(2)
    a = _per_sequence(A, B).reshape(B, 1, 1, G, r)
    ddt = (GE * D).sum(2) + w * xv + a * rcs
    dA = (dts * rcs).sum((1, 2)).reshape(B, H)
    if A.ndim == 1:
        dA = dA.sum(0)
    return (dx.reshape(B, L, H, P).to(x.dtype), ddt.reshape(B, L, H), dA,
            dB.reshape(B, L, G, N).to(Bg.dtype),
            dC.reshape(B, L, G, N).to(Cg.dtype))


def _jvp(fn, primals, tangents):
    """``torch.func.jvp`` of ``fn`` in float32 (inputs made contiguous, as
    ``make_dual`` needs)."""
    return torch.func.jvp(fn, tuple(p.float().contiguous() for p in primals),
                          tuple(t.float().contiguous() for t in tangents))


def tangent_bwd_state_ref(x, dt, A, Bg, Cg, gy, tx, tdt, tA, tB, tC, tgy,
                          chunk: int):
    """Pass 1 of the backward's tangent: (S, S', Lc, Lc', seg, seg'),
    float32, ``torch.func.jvp`` of :func:`bwd_state_ref`."""
    (S, Lc, seg), (tS, tLc, tseg) = _jvp(
        lambda *a: bwd_state_ref(*a, chunk), (x, dt, A, Bg, Cg, gy),
        (tx, tdt, tA, tB, tC, tgy))
    return S, tS, Lc, tLc, seg, tseg


def tangent_bwd_state_pass_ref(S, tS, Lc, tLc, seg, tseg, gs, tgs,
                               chunk: int):
    """Pass 2 of the backward's tangent: (s_in, s_in', gO, gO', sg, sg'),
    float32, ``torch.func.jvp`` of :func:`bwd_state_pass_ref`."""
    (s_in, gO, sg), (ts_in, tgO, tsg) = _jvp(
        lambda *a: bwd_state_pass_ref(*a, chunk), (S, Lc, seg, gs),
        (tS, tLc, tseg, tgs))
    return s_in, ts_in, gO, tgO, sg, tsg


def tangent_bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, tx, tdt,
                          tA, tB, tC, tgy, tseg, ts_in, tgO, tsg,
                          chunk: int):
    """Pass 3 of the backward's tangent: the tangents (dx', ddt', dA', dB',
    dC') of :func:`bwd_chunk_ref`'s outputs, each in its output's dtype,
    from ``torch.func.jvp``."""
    grads = bwd_chunk_ref(x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg, chunk)
    _, tangents = _jvp(
        lambda *a: bwd_chunk_ref(*a, chunk),
        (x, dt, A, Bg, Cg, gy, seg, s_in, gO, sg),
        (tx, tdt, tA, tB, tC, tgy, tseg, ts_in, tgO, tsg))
    return tuple(t.to(g.dtype) for t, g in zip(tangents, grads))
