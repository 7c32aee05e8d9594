"""Plain PyTorch versions of the flash-attention kernels.

:func:`attention_ref` is the JAX package's ``kernels/flash_attention/ref.py``
oracle copied: float32 logits, masked softmax, output cast to q's dtype.
Its autograd gradient is the plain backward.

:func:`flash_fwd_ref` and :func:`flash_bwd_ref` compute what the CUDA
kernels compute, with the kernels' interface: the forward also returns the
per-row logsumexp, and the backward takes it (with ``out``) instead of
recomputing the softmax's normaliser — the FlashAttention-2 backward of the
JAX package's ``flash_bwd.py``.  :func:`gqa_flash_fwd_ref` and
:func:`gqa_flash_bwd_ref` are the same in the model's layout, with K/V
heads not expanded.  The kernel wrappers use them for CPU tensors, and
``chip_smoke.py`` holds the kernels against them on the card.

:func:`flash_fwd_tangent_ref` and :func:`flash_bwd_tangent_ref` are the
plain versions of the two tangent kernels: ``torch.func.jvp`` of the
forward and of the backward above (the backward's sums in float64, so dS
stays exactly 0 where a row sees one key), in either layout.

:func:`split_tf32` and :func:`tf32_matmul` model how the float32 backward
kernels multiply on the tensor cores: each float32 operand split into two
TF32 values, hi + lo, and each product taken as three TF32 products.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

__all__ = ["NEG_INF", "attention_ref", "band_mask", "flash_bwd_ref",
           "flash_bwd_tangent_ref", "flash_fwd_ref", "flash_fwd_tangent_ref",
           "gqa_flash_bwd_ref", "gqa_flash_fwd_ref", "split_tf32",
           "tf32_matmul", "tf32_round"]


def band_mask(S: int, Sk: int, causal: bool, window: int | None,
              device=None) -> torch.Tensor:
    """(S, Sk) bool: query i may see key j iff (j <= i if causal) and
    (j > i - window if a window is given)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """q/k/v: (B, H, S, d).  Full-materialization masked softmax."""
    d = q.shape[-1]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()
                          ) / math.sqrt(d)
    mask = band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)


def _logits(q, k, causal, window, scale):
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(mask, s, NEG_INF)


def flash_fwd_ref(q, k, v, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, S, d) in q's dtype, lse (B, H, S) float32)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = _logits(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def _bwd_f64(q, k, v, out, lse, do, causal, window, scale):
    """The backward's sums in float64, where dP = dO Vᵀ and D = rowsum(dO ⊙
    O) are exact for bf16 inputs: a query row that sees one key (P = 1,
    O = V) gets dS = 0 exactly, as in exact arithmetic and as the kernels
    give, where float32 would leave a rounding residue that depends on the
    order of each sum."""
    p = torch.exp(_logits(q, k, causal, window, scale) - lse[..., None])
    p, qd, kd, vd = p.double(), q.double(), k.double(), v.double()
    dod = do.double()
    dsum = (dod * out.double()).sum(-1, keepdim=True)
    dp = torch.einsum("bhsd,bhtd->bhst", dod, vd)
    ds = p * (dp - dsum) * scale
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kd)
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qd)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dod)
    return dq, dk, dv


def flash_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of (q, k, v):  P = exp(S − lse) in
    float32, then in float64 dP = dO Vᵀ, dS = P ⊙ (dP − D) · scale with
    D = rowsum(dO ⊙ O), dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    dq, dk, dv = _bwd_f64(q, k, v, out, lse, do, causal, window, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _heads_first(k: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, KV, d) → (B, H, S, d), each KV head repeated for its H / KV
    query heads."""
    return k.repeat_interleave(H // k.shape[2], dim=2).transpose(1, 2)


def gqa_flash_fwd_ref(q, k, v, *, causal: bool = True,
                      window: int | None = None, scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model layout: q (B, S, H, d), k/v (B, S_k, KV, d) with H a
    multiple of KV → (out (B, S, H, d) in q's dtype, lse (B, H, S)
    float32)."""
    H = q.shape[2]
    out, lse = flash_fwd_ref(q.transpose(1, 2), _heads_first(k, H),
                             _heads_first(v, H), causal=causal,
                             window=window, scale=scale)
    return out.transpose(1, 2), lse


def gqa_flash_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                      window: int | None = None, scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The model layout's backward: (dq (B, S, H, d), dk and dv (B, S_k,
    KV, d)), dk and dv summed over each KV head's query heads before they
    are rounded."""
    B, _, H, d = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq, dk, dv = _bwd_f64(q.transpose(1, 2), _heads_first(k, H),
                          _heads_first(v, H), out.transpose(1, 2), lse,
                          do.transpose(1, 2), causal, window, scale)

    def per_kv_head(g):
        return g.reshape(B, KV, H // KV, Sk, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def flash_fwd_tangent_ref(q, k, v, tq, tk, tv, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None, heads_dim: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o', lse'): ``torch.func.jvp`` of :func:`flash_fwd_ref`
    (``heads_dim=1``, (B, H, S, d)) or :func:`gqa_flash_fwd_ref`
    (``heads_dim=2``, (B, S, H, d) with K/V heads unexpanded) at (q, k, v)
    along (q', k', v')."""
    fwd = flash_fwd_ref if heads_dim == 1 else gqa_flash_fwd_ref
    return torch.func.jvp(
        lambda q, k, v: fwd(q, k, v, causal=causal, window=window,
                            scale=scale),
        *(tuple(t.contiguous() for t in ts) for ts in ((q, k, v),
                                                        (tq, tk, tv))))[1]


def flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv, tout, tlse,
                          tdo, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None, heads_dim: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(dq', dk', dv'): ``torch.func.jvp`` of :func:`flash_bwd_ref` or
    :func:`gqa_flash_bwd_ref` (by ``heads_dim``) at (q, k, v, out, lse, dO)
    along the tangents of all six."""
    bwd = flash_bwd_ref if heads_dim == 1 else gqa_flash_bwd_ref
    return torch.func.jvp(
        lambda *a: bwd(*a, causal=causal, window=window, scale=scale),
        *(tuple(t.contiguous() for t in ts) for ts in (
            (q, k, v, out, lse, do), (tq, tk, tv, tout, tlse, tdo))))[1]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped
    13 bits to the magnitude's bit pattern, then mask them off."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as hi = tf32(x), rounded to nearest, and lo = x - hi as the tensor
    core reads it, TF32 rounded toward zero (its low 13 bits masked off):
    hi + lo keeps about 21 significant bits of x, one TF32 value 11."""
    hi = tf32_round(x)
    lo = (x.float() - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int = 3
                ) -> torch.Tensor:
    """a @ b in float32 as the float32 backward kernels take it on the
    tensor cores: ``products=3`` sums lo_a hi_b + hi_a lo_b + hi_a hi_b
    (3×TF32); ``products=1`` is one TF32 product, hi_a hi_b.  A product of
    two TF32 values is exact in float32, so only the split and the float32
    sums round."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh
