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
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

__all__ = ["NEG_INF", "attention_ref", "band_mask", "flash_bwd_ref",
           "flash_fwd_ref", "gqa_flash_bwd_ref", "gqa_flash_fwd_ref"]


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
