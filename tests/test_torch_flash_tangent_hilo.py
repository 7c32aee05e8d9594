"""The bfloat16 flash-attention tangents' rounding (T1 and T2 on the
tensor cores, namespace ``hop`` of ``csrc/flash_attention.cu``), modelled
in plain torch on the CPU and held against the plain tangents within the
tolerance that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernels to.

The model takes what the kernels take and rounds where they round: bf16
inputs, whose products are exact in float32; float32 sums; P, P ⊙ S', P',
dS and dS' formed in float32 and fed to the products that take them as
two bf16 halves, hi = bf16(x) and lo = bf16(x - hi); lse', D and D' as
float32 sums; the outputs rounded to bf16.  Without the lo halves (P and
the rest rounded once to bf16) the same check must fail, so the tolerance
tells the design from the cheaper one before any card runs it.

The values share a mean (and the keys a direction), as a trained model's
do: then o' = O' - lse' O is a difference of two large sums, and dq' =
dS' K + dS K' one whose rows of dS sum to 0, which is where a P rounded
once to bf16 shows.  Inputs drawn about 0 alone give a model without lo
halves within the tolerance too.
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ref as fref

# chip_smoke.py's TANGENT_TOL: (rtol, share of the output's largest |value|)
TANGENT_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (1.6e-2, 2.0 ** -8)}
V_MEAN, K_DIRECTION = 4.0, 1.0

# (B, S, S_k, H, KV, d, causal): whisper's encoder reduced to one sequence
# of 1500 frames and 2 heads, and a causal GQA 6:1 shape at d = 128
SHAPES = [(1, 1500, 1500, 2, 2, 64, False), (1, 256, 256, 6, 1, 128, True)]
IDS = ["whisper-like-1500x1500-2x64", "gqa-causal-256-6x1-128"]


def _outside(got, want) -> int:
    rtol, rel = TANGENT_TOL[want.dtype]
    g, w = got.float(), want.float()
    return int(((g - w).abs() > rtol * w.abs() + rel * w.abs().max()).sum())


def _halves(x, lo: bool):
    """x as the tensor core reads it: bf16(x) + bf16(x - bf16(x)), or
    bf16(x) alone."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if lo else hi


def _heads(t, H):
    """(B, S, KV, d) → (B, H, S, d) float32, each KV head read by its H / KV
    query heads."""
    return t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2).float()


def tangents_model(q, k, v, do, tq, tk, tv, tout, tlse, tdo, out, lse,
                   causal, lo=True):
    """((o', lse'), (dq', dk', dv')) as the bf16 kernels round them, in the
    model layout (K/V unexpanded; dk', dv' summed over each KV head's
    query heads)."""
    B, S, H, d = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    scale = 1.0 / math.sqrt(d)
    Q, TQ, DO, TDO, O, TO = (t.transpose(1, 2).float()
                             for t in (q, tq, do, tdo, out, tout))
    K, V, TK, TV = (_heads(t, H) for t in (k, v, tk, tv))
    mask = fref.band_mask(S, Sk, causal, None)
    s = torch.where(mask, Q @ K.transpose(-1, -2) * scale, fref.NEG_INF)
    sd = torch.where(mask, (TQ @ K.transpose(-1, -2)
                            + Q @ TK.transpose(-1, -2)) * scale, 0.0)
    P = torch.exp(s - lse[..., None])
    # T1
    PS = P * sd
    t_lse = PS.sum(-1)
    Pk = _halves(P, lo)
    O1 = Pk @ V
    O1t = Pk @ TV + _halves(PS, lo) @ V
    t_out = (O1t - t_lse[..., None] * O1).to(q.dtype).transpose(1, 2)
    # T2, on the tangents T1's plain version gives
    D = (DO * O).sum(-1, keepdim=True)
    Dt = (TDO * O + DO * TO).sum(-1, keepdim=True)
    dp = DO @ V.transpose(-1, -2)
    dpt = TDO @ V.transpose(-1, -2) + DO @ TV.transpose(-1, -2)
    Pt = P * (sd - tlse[..., None])
    dS = P * (dp - D) * scale
    dSt = (Pt * (dp - D) + P * (dpt - Dt)) * scale
    hS, hSt = _halves(dS, lo), _halves(dSt, lo)
    dq = hSt @ K + hS @ TK
    dk = hSt.transpose(-1, -2) @ Q + hS.transpose(-1, -2) @ TQ
    dv = _halves(Pt, lo).transpose(-1, -2) @ DO + \
        Pk.transpose(-1, -2) @ TDO

    def per_kv_head(g):
        return g.reshape(B, KV, H // KV, Sk, d).sum(2).transpose(1, 2)

    return ((t_out, t_lse), (dq.transpose(1, 2).to(q.dtype),
                             per_kv_head(dk).to(k.dtype),
                             per_kv_head(dv).to(v.dtype)))


def _case(shape):
    """The inputs (bf16), the plain forward's out and lse, and the plain
    tangents of T1 and T2 (T2 given T1's plain o' and lse', as the checks
    on the card give it)."""
    B, S, Sk, H, KV, d, causal = shape
    gen = torch.Generator().manual_seed(0)
    draw = lambda *s: torch.randn(*s, generator=gen)
    q, tq, do, tdo = (draw(B, S, H, d).to(torch.bfloat16) for _ in range(4))
    k, v, tk, tv = (draw(B, Sk, KV, d) for _ in range(4))
    k = (k + K_DIRECTION * draw(d)).to(torch.bfloat16)
    v = (v + V_MEAN).to(torch.bfloat16)
    tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    kw = dict(causal=causal, window=None, heads_dim=2)
    out, lse = fref.gqa_flash_fwd_ref(q, k, v, causal=causal, window=None)
    tout, tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv, **kw)
    wants = fref.flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                       tout, tlse, tdo, **kw)
    args = (q, k, v, do, tq, tk, tv, tout, tlse, tdo, out, lse, causal)
    return args, (tout, tlse), wants


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_hi_lo_model_is_within_the_tangent_tolerance(shape):
    args, (tout, tlse), wants = _case(shape)
    (m_out, m_lse), grads = tangents_model(*args)
    assert m_out.dtype == tout.dtype and m_lse.dtype == tlse.dtype
    outside = {"o'": _outside(m_out, tout), "lse'": _outside(m_lse, tlse),
               **{f"{n}'": _outside(g, w)
                  for n, g, w in zip(("dq", "dk", "dv"), grads, wants)}}
    assert not any(outside.values()), outside


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_model_without_lo_halves_falls_outside(shape):
    args, (tout, tlse), wants = _case(shape)
    (m_out, _), grads = tangents_model(*args, lo=False)
    outside = _outside(m_out, tout) + sum(
        _outside(g, w) for g, w in zip(grads, wants))
    assert outside > 0
