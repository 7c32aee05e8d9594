"""The chunked SSD scan in PyTorch (port of the reference's jnp
``models/layers.py::ssd_scan``) and its VJP, chunk by chunk.

:func:`ssd_scan` is what ``models.layers.mamba2_apply`` runs on a CPU
tensor.  :func:`ssd_scan_vjp` is the backward the kernel's autograd pairing
(:mod:`.ops`) takes on the card: the VJP of the same scan in float32.  Both
keep one chunk's (B, c, c, H) decay tile live at a time, as the reference
does with a ``jax.checkpoint`` per chunk: the forward loops over chunks,
and the VJP first carries the states forward (no tile needed) and then
walks the chunks in reverse, recomputing each chunk's tile for its own VJP
and carrying the state's cotangent back.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan", "ssd_scan_vjp"]


def _check_length(L: int, chunk: int) -> None:
    if L % chunk:
        raise ValueError(f"ssd_scan needs the sequence length to be a "
                         f"multiple of the chunk: L={L} % chunk={chunk} = "
                         f"{L % chunk}")


def _per_step_A(A: torch.Tensor) -> torch.Tensor:
    """A (H,) or per sequence (B, H), broadcastable against (B, c, H)."""
    return A if A.ndim == 1 else A[:, None, :]


def _advance(state, seg, dtc, Bh, xc):
    """The state after one chunk: decayed over the chunk, plus each step's
    ``exp(seg_end - seg_k) dt_k x_k B_k^T``."""
    end = seg[:, -1:, :]
    w = (torch.exp(end - seg) * dtc).to(xc.dtype)          # (B,c,H)
    return (state * torch.exp(end[:, 0])[..., None, None].to(xc.dtype)
            + torch.einsum("bkh,bkhn,bkhp->bhpn", w, Bh, xc))


def _chunk(xc, dtc, A, Bc, Cc, state):
    """One chunk: (y (B,c,H,P), the state after it), in xc's dtype.

    The decay ``exp(seg_q - seg_k)`` is taken of the masked difference
    (``-inf`` above the diagonal), where the reference masks after the
    exponential.  The values are the same; the reference's gradient is NaN
    once ``seg`` falls by more than about 88 within a chunk (the masked
    ``exp`` overflows and its VJP multiplies the overflow by zero), as it
    does at chunk 256 with dt near 1."""
    c, H = xc.shape[1], xc.shape[2]
    rep = H // Bc.shape[2]
    Bh = Bc.repeat_interleave(rep, dim=2)                  # (B,c,H,N)
    Ch = Cc.repeat_interleave(rep, dim=2)
    dtc = dtc.float()
    seg = torch.cumsum(dtc * _per_step_A(A), dim=1)        # (B,c,H), <= 0
    li = seg[:, :, None, :] - seg[:, None, :, :]           # (B,cq,ck,H)
    causal = torch.ones(c, c, dtype=torch.bool,
                        device=xc.device).tril()[None, :, :, None]
    decay = torch.exp(torch.where(causal, li, -torch.inf))
    cb = torch.einsum("bqhn,bkhn->bqkh", Ch, Bh)
    M = (cb * decay * dtc[:, None, :, :]).to(xc.dtype)
    y = torch.einsum("bqkh,bkhp->bqhp", M, xc)             # intra-chunk
    y = y + torch.exp(seg)[..., None].to(xc.dtype) * torch.einsum(
        "bqhn,bhpn->bqhp", Ch, state)                      # entering state
    return y, _advance(state, seg, dtc, Bh, xc)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (B,L,H,P), dt: (B,L,H), A: (H,) (<0) or per
    sequence (B,H), B/C: (B,L,G,N).  Returns (y (B,L,H,P), final_state
    (B,H,P,N)) in x's dtype: a Python loop over chunks carrying the
    (B,H,P,N) state."""
    Bb, L, H, P = x.shape
    _check_length(L, chunk)
    state = (torch.zeros(Bb, H, P, B.shape[3], dtype=x.dtype,
                         device=x.device)
             if init_state is None else init_state.to(x.dtype))
    ys = []
    for lo in range(0, L, chunk):
        sl = slice(lo, lo + chunk)
        y, state = _chunk(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_scan_vjp(x, dt, A, B, C, gy, gs, chunk: int):
    """The VJP of :func:`ssd_scan` from a zero state, computed in float32:
    the gradients (dx, ddt, dA, dB, dC), each in its input's dtype, for the
    cotangents ``gy`` of y and ``gs`` of the final state."""
    Bb, L, H, P = x.shape
    _check_length(L, chunk)
    Af = A.float()
    chunks = [slice(lo, lo + chunk) for lo in range(0, L, chunk)]
    states = [torch.zeros(Bb, H, P, B.shape[3], dtype=torch.float32,
                          device=x.device)]
    with torch.no_grad():                   # the state entering each chunk
        for sl in chunks[:-1]:
            dtc = dt[:, sl].float()
            seg = torch.cumsum(dtc * _per_step_A(Af), dim=1)
            Bh = B[:, sl].float().repeat_interleave(H // B.shape[2], dim=2)
            states.append(_advance(states[-1], seg, dtc, Bh,
                                   x[:, sl].float()))

    def step(xc, dtc, A, Bc, Cc, state):
        return _chunk(xc.float(), dtc.float(), A.float(), Bc.float(),
                      Cc.float(), state)

    dxs, ddts, dBs, dCs = [], [], [], []
    dA, gstate = torch.zeros_like(A), gs.float()
    for sl, state in zip(reversed(chunks), reversed(states)):
        _, vjp_fn = torch.func.vjp(step, x[:, sl], dt[:, sl], A, B[:, sl],
                                   C[:, sl], state)
        dxc, ddtc, dAc, dBc, dCc, gstate = vjp_fn((gy[:, sl].float(),
                                                   gstate))
        del vjp_fn                          # this chunk's tiles go here
        dxs.append(dxc)
        ddts.append(ddtc)
        dBs.append(dBc)
        dCs.append(dCc)
        dA = dA + dAc

    def cat(parts):                         # collected last chunk first
        return torch.cat(parts[::-1], dim=1)

    return cat(dxs), cat(ddts), dA, cat(dBs), cat(dCs)
