"""Neural layers of the dense decoder, Mamba2, MoE, encoder-decoder and
vision families: norms, RoPE, sinusoidal positions, GQA attention
(full-sequence self- and cross-attention, single-token decode with the
sliding-window ring buffer, and decode-time cross-attention against the
encoder's fixed K/V), MLA (DeepSeek's latent attention, with its
latent-cache decode), the MLP, the token-choice MoE (sorted and one-hot
dispatch, shared experts) and the Mamba2 mixer (the chunked SSD scan,
full-sequence and single-token decode) — port of
``repro/models/layers.py``.

Everything is functional: ``*_specs(cfg)`` builds a Spec tree,
``*_apply(params, ...)`` runs it on a dict of tensors keyed as the specs.

:func:`sdpa` is where the hand-written flash-attention kernel goes: on a
CUDA tensor it calls the flash-attention ``Function`` (kernel forward and
backward) on the unexpanded K/V heads; on a CPU tensor it expands them and
runs the port's copy of the reference's
``_sdpa``/``_sdpa_chunked``, the same function the JAX package's ``sdpa``
computes.  The numbers differ in one place: the jnp path rounds the
probabilities to the value dtype before P·V, the kernel keeps them float32
(as the Pallas kernel does).  In float32 the two agree to rounding.

:func:`mla_apply` runs the plain attention (:func:`_plain_sdpa`, the
reference's ``_sdpa``/``_sdpa_chunked``) on every device: its q/k head is
``qk_nope_dim + qk_rope_dim`` (192 in deepseek-v2-lite) and its v head
``v_head_dim`` (128), and no TPU kernel of the reference computes attention
with two head dims (the reference's MLA runs the jnp ``sdpa`` too).

:func:`moe_apply` routes in float32 (``moe_router_dtype``) with TF32 off
for the router product, so a card and a CPU pick the same experts for the
same activations (:func:`record_routes` collects the picks); the expert
products are plain ``torch.einsum``, as the reference computes them
outside any Pallas kernel.

:func:`mamba2_apply` is where the hand-written SSD scan kernel goes: on a
CUDA tensor it calls the SSD scan ``Function`` (kernel forward, the
backward's kernels as backward); on a CPU tensor it runs :func:`ssd_scan`, the
port of the reference's jnp chunked scan (its ``use_kernel=False``
branch), which lives in ``kernels/ssd_scan/chunked.py`` beside its VJP and
is exported here under the reference's name.  The kernel keeps the state and the decay tile in float32, where
the chunked scan keeps them in the model dtype; in float32 the two agree to
rounding.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.kernels.flash_attention.ref import band_mask
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.chunked import ssd_scan
from repro_torch.models.init import Spec

Params = dict[str, torch.Tensor]
NEG_INF = -1e30

__all__ = ["norm_specs", "norm_apply", "rope", "sinusoidal_positions",
           "sdpa", "causal_mask", "attention_specs", "attention_apply",
           "attention_decode", "cross_attention_decode", "cross_kv",
           "mla_specs", "mla_apply", "mla_decode", "mlp_specs", "mlp_apply",
           "moe_specs", "moe_apply", "moe_apply_sorted", "moe_apply_einsum",
           "moe_load_balance_loss", "record_routes", "mamba2_specs",
           "ssd_scan", "mamba2_apply", "mamba2_decode", "sub"]


def sub(params: Params, prefix: str) -> Params:
    """The sub-dict of ``params`` under ``prefix/``, keys without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ArchConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    p = {"scale": Spec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        p["bias"] = Spec((d,), ("embed",), "zeros")
    return p


def norm_apply(params: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if "bias" in params:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32,
                            device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(S: int, d: int) -> np.ndarray:
    """(S, d) float32 absolute positions (sin on even, cos on odd
    columns), computed in float64 by numpy as the reference does."""
    pos = np.arange(S)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    return out


# ---------------------------------------------------------------------------
# Scaled-dot-product attention
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale):
    """q:(B,S,H,D) k/v:(B,T,H,D) mask:(B,S,T) or (S,T) broadcastable."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    logits = torch.where(mask[..., None, :, :] if mask.ndim == 3 else mask,
                         logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_chunked(q, k, v, scale, *, causal: bool, window: int | None,
                  q_chunk: int):
    """Query-chunked attention: only (q_chunk, T) logit tiles exist at a
    time (the reference scans the chunks under ``jax.checkpoint``)."""
    S, T = q.shape[1], k.shape[1]
    kpos = torch.arange(T, device=q.device)[None, :]
    outs = []
    for ci in range(S // q_chunk):
        qi = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        logits = torch.einsum("bshd,bthd->bhst", qi, k).float() * scale
        qpos = ci * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        mask = torch.ones(q_chunk, T, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, v))
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, scale, *, causal: bool, window: int | None = None,
         q_chunk: int | None = 512):
    """q: (B,S,H,D), k/v: (B,T,KV,D) with H a multiple of KV (GQA heads
    not expanded).  On a CUDA tensor, the flash-attention kernels, which
    read each KV head for its query heads in place; on a CPU tensor, K/V
    expanded to H heads, then chunked when the query length divides
    cleanly, full otherwise (the reference's dispatch)."""
    if q.device.type == "cuda":
        return gqa_flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    H = q.shape[2]
    return _plain_sdpa(q, _expand_kv(k, H), _expand_kv(v, H), scale,
                       causal=causal, window=window, q_chunk=q_chunk)


def _plain_sdpa(q, k, v, scale, *, causal: bool, window: int | None = None,
                q_chunk: int | None = 512):
    """The reference's ``sdpa`` (K/V with H heads): chunked when the query
    length divides cleanly, full otherwise.  v's head dim may differ from
    q's and k's."""
    S, T = q.shape[1], k.shape[1]
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        return _sdpa_chunked(q, k, v, scale, causal=causal, window=window,
                             q_chunk=q_chunk)
    return _sdpa(q, k, v, band_mask(S, T, causal, window, q.device), scale)


def causal_mask(S: int, T: int, offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """(S, T) mask: query i (global pos offset+i) may see key j iff j <= pos
    and (pos - j) < window."""
    qpos = offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    """The projections of a self-attention block, or (``cross``) of a
    cross-attention block, which has no biases."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": Spec((d, H, hd), ("embed", "heads", "head_dim"), "fan_in"),
        "wk": Spec((d, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wv": Spec((d, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wo": Spec((H, hd, d), ("heads", "head_dim", "embed"), "fan_in"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Spec((H, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = Spec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    return p


def _qkv(params: Params, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", kv_x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    KV = k.shape[-2]
    if KV == H:
        return k
    return k.repeat_interleave(H // KV, dim=-2)


def attention_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention.  x: (B,S,d); kv_x (B,T,d) for
    cross-attention, which takes no rope, no causal mask and no window."""
    hd = cfg.head_dim
    q, k, v = _qkv(params, x, kv_x)
    if cfg.use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    is_causal = causal and kv_x is None
    out = sdpa(q, k, v, 1.0 / math.sqrt(hd), causal=is_causal,
               window=cfg.sliding_window if is_causal else None,
               q_chunk=cfg.attn_q_chunk)
    return torch.einsum("bshd,hdo->bso", out, params["wo"])


def attention_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode.  x: (B,1,d); pos: (B,) current position;
    cache_k/v: (B, C, KV, hd) where C = full seq (dense) or window (SWA).
    Returns (out (B,1,d), cache_k, cache_v).  The caches are updated in
    place (the reference returns updated copies): decode is never
    differentiated, and a copy per layer per token is pure traffic."""
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x)
    C = cache_k.shape[1]
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    slot = pos % C if cfg.sliding_window else pos               # ring buffer
    bidx = torch.arange(x.shape[0], device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    kpos = torch.arange(C, device=x.device)[None, :]
    if cfg.sliding_window:
        # ring buffer: index r holds global position g, the largest g <= pos
        # with g ≡ r (mod C); valid iff g >= 0 and within the window.
        g = pos[:, None] - torch.remainder(pos[:, None] - kpos, C)
        mask = (g >= 0) & (pos[:, None] - g < min(cfg.sliding_window, C))
    else:
        mask = kpos <= pos[:, None]
    # grouped-query attention against the *unexpanded* cache
    KV = cache_k.shape[2]
    qg = q[:, 0].reshape(q.shape[0], KV, H // KV, hd)           # (B,KV,G,hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.to(x.dtype))
    logits = logits.float() / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v.to(x.dtype))
    out = out.reshape(x.shape[0], 1, H, hd)
    return torch.einsum("bshd,hdo->bso", out, params["wo"]), cache_k, cache_v


def cross_attention_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                           cross_k: torch.Tensor, cross_v: torch.Tensor
                           ) -> torch.Tensor:
    """Decode-time cross-attention against the encoder's fixed K/V (B, T,
    KV, hd), read unexpanded; no cache update.  Plain PyTorch on every
    device, as the reference computes it outside any kernel."""
    H, hd = cfg.num_heads, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    B, S = q.shape[:2]
    KV = cross_k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)                      # (B,S,KV,G,hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, cross_k.to(x.dtype))
    logits = logits.float() * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cross_v.to(x.dtype))
    out = out.reshape(B, S, H, hd)
    return torch.einsum("bshd,hdo->bso", out, params["wo"])


def cross_kv(params: Params, enc: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B,T,KV,hd) from encoder states (B,T,d)."""
    k = torch.einsum("btd,dhk->bthk", enc, params["wk"])
    v = torch.einsum("btd,dhk->bthk", enc, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2) [arXiv:2405.04434]
# ---------------------------------------------------------------------------

def mla_specs(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    return {
        "wq": Spec((d, H, dn + dr), ("embed", "heads", "head_dim"), "fan_in"),
        "w_dkv": Spec((d, r), ("embed", "kv_lora"), "fan_in"),
        "w_kr": Spec((d, dr), ("embed", None), "fan_in"),
        "w_uk": Spec((r, H, dn), ("kv_lora", "heads", "head_dim"), "fan_in"),
        "w_uv": Spec((r, H, dv), ("kv_lora", "heads", "head_dim"), "fan_in"),
        "wo": Spec((H, dv, d), ("heads", "head_dim", "embed"), "fan_in"),
        "kv_norm": {"scale": Spec((r,), ("kv_lora",), "ones")},
    }


def mla_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA: standard causal attention on the concatenated
    (nope ‖ rope) keys, every head reading the one shared rope key."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])
    c_kv = norm_apply(sub(params, "kv_norm"), c_kv)
    k_rope = rope(torch.einsum("bsd,dk->bsk", x, params["w_kr"])[:, :, None],
                  positions, cfg.rope_theta)                     # (B,S,1,dr)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    H = q.shape[2]
    k_full = torch.cat([k_nope, k_rope.expand(-1, -1, H, -1)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    # The plain attention on every device, by name: no TPU kernel of the
    # reference computes attention with a q/k head (dn + dr, 192 at full
    # width) other than its v head (dv, 128), so sdpa's flash route does
    # not apply; the reference's MLA runs its jnp sdpa as well.
    out = _plain_sdpa(q_full, k_full, v, 1.0 / math.sqrt(dn + dr),
                      causal=True, q_chunk=cfg.attn_q_chunk)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def mla_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
               pos: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Latent-cache decode with the absorption trick: the cache holds only
    c_kv (B, C, r) and the rope key (B, C, dr), and W_uk is folded into the
    query.  Both caches are updated in place."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, pos[:, None], cfg.rope_theta)
    # absorb W_uk into the query: q_lat = q_nope @ W_uk^T, in latent space
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    c_kv = norm_apply(sub(params, "kv_norm"),
                      torch.einsum("bsd,dr->bsr", x, params["w_dkv"]))
    k_r = rope(torch.einsum("bsd,dk->bsk", x, params["w_kr"])[:, :, None],
               pos[:, None], cfg.rope_theta)[:, :, 0]
    bidx = torch.arange(x.shape[0], device=x.device)
    cache_ckv[bidx, pos] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_kr[bidx, pos] = k_r[:, 0].to(cache_kr.dtype)
    C = cache_ckv.shape[1]
    mask = torch.arange(C, device=x.device)[None, :] <= pos[:, None]  # (B,C)
    scale = 1.0 / math.sqrt(dn + dr)
    ckv = cache_ckv.to(x.dtype)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
              + torch.einsum("bshk,btk->bhst", q_rope,
                             cache_kr.to(x.dtype)))
    logits = torch.where(mask[:, None, None, :], logits.float() * scale,
                         NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, ckv)
    out = torch.einsum("bshr,rhk->bshk", out_lat, params["w_uv"])
    return (torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache_ckv,
            cache_kr)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"w1": Spec((d, f), ("embed", "ffn"), "fan_in"),
                "w3": Spec((d, f), ("embed", "ffn"), "fan_in"),
                "w2": Spec((f, d), ("ffn", "embed"), "fan_in")}
    return {"w1": Spec((d, f), ("embed", "ffn"), "fan_in"),
            "b1": Spec((f,), ("ffn",), "zeros"),
            "w2": Spec((f, d), ("ffn", "embed"), "fan_in"),
            "b2": Spec((d,), ("embed",), "zeros")}


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "w3" in params:
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
        return h @ params["w2"]
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="tanh")
    return h @ params["w2"] + params["b2"]


# ---------------------------------------------------------------------------
# MoE — sort-based token-choice top-k with per-group capacity
# ---------------------------------------------------------------------------

def moe_specs(cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_hidden, cfg.num_experts
    p = {
        "router": Spec((d, E), ("embed", None), "fan_in"),
        "w1": Spec((E, d, f), ("experts", "embed", "ffn"), "fan_in"),
        "w3": Spec((E, d, f), ("experts", "embed", "ffn"), "fan_in"),
        "w2": Spec((E, f, d), ("experts", "ffn", "embed"), "fan_in"),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_specs(cfg, cfg.moe_hidden * cfg.num_shared_experts)
    return p


@contextlib.contextmanager
def _ieee_f32():
    """float32 products in full precision while routing: a TF32 router
    product would pick other experts than the CPU for the same tokens."""
    matmul = torch.backends.cuda.matmul
    if not matmul.allow_tf32:
        yield
        return
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = True


# The routes of every MoE call while record_routes() is active: each entry
# the (..., S, k) expert indices of one call, detached.
_ROUTES: list | None = None


@contextlib.contextmanager
def record_routes():
    """Collect the top-k expert indices every MoE layer picks inside the
    block (a list, in call order), to compare two runs' routing."""
    global _ROUTES
    saved, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = saved


def _router_logits(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   eq: str) -> torch.Tensor:
    """The router product in ``moe_router_dtype``, TF32 off."""
    rdt = torch.float32 if cfg.moe_router_dtype == "float32" else x.dtype
    with _ieee_f32():
        return torch.einsum(eq, x.to(rdt), params["router"].to(rdt))


def _top_k(probs: torch.Tensor, k: int):
    """Top-k choices renormalised to sum to 1.  The indices are recorded
    while :func:`record_routes` is active (outside ``torch.func``
    transforms)."""
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    if _ROUTES is not None:
        _ROUTES.append(top_e.detach())
    return top_w, top_e


def _route_group(logits: torch.Tensor, k: int, E: int, C: int):
    """Per-group routing, batched over leading dims.  logits: (..., G, E).
    Returns (buf_tok (..., E*C) int64 token indices, G for an empty slot;
    buf_w (..., E*C) float32 combine weights).

    The reference's order: a float32 softmax, top-k renormalised, a stable
    sort of the (token, choice) pairs by expert, each pair's slot within
    its expert, and a scatter into E·C + 1 slots whose last slot takes the
    pairs past capacity."""
    G = logits.shape[-2]
    lead = logits.shape[:-2]
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = _top_k(probs, k)                             # (..., G, k)
    flat_e = top_e.reshape(*lead, G * k)
    flat_w = top_w.reshape(*lead, G * k)
    flat_tok = torch.arange(G, device=probs.device).repeat_interleave(k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices     # by expert
    se = torch.gather(flat_e, -1, order)
    st = flat_tok[order]
    sw = torch.gather(flat_w, -1, order)
    # position of each routed pair within its expert
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(G * k, device=probs.device) - first
    dest = torch.where(pos_in_e < C, se * C + pos_in_e,
                       torch.full_like(se, E * C))              # drop slot
    buf_tok = se.new_full((*lead, E * C + 1), G).scatter(-1, dest,
                                                         st)[..., :-1]
    buf_w = sw.new_zeros((*lead, E * C + 1)).scatter(-1, dest, sw)[..., :-1]
    return buf_tok, buf_w


def _experts(params: Params, xe: torch.Tensor, eq_in: str, eq_out: str
             ) -> torch.Tensor:
    h = torch.einsum(eq_in, xe, params["w1"])
    g = torch.einsum(eq_in, xe, params["w3"])
    return torch.einsum(eq_out, F.silu(h) * g, params["w2"])


def moe_apply_sorted(params: Params, cfg: ArchConfig, x: torch.Tensor
                     ) -> torch.Tensor:
    """Sort/gather dispatch, each sequence a routing group (the reference
    vmaps its group function over the batch): gather the routed tokens
    into (E, C) expert slots, the three expert products, and a scatter-add
    of the weighted outputs back to their tokens.  x: (B, S, d)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = max(1, int(S * k * cfg.moe_capacity_factor / E))
    logits = _router_logits(params, cfg, x, "bsd,de->bse")
    buf_tok, buf_w = _route_group(logits, k, E, C)              # (B, E*C)
    xpad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)        # (B, S+1, d)
    idx = buf_tok[..., None].expand(B, E * C, d)
    xe = torch.gather(xpad, 1, idx).reshape(B, E, C, d)          # gather
    ye = _experts(params, xe, "becd,edf->becf", "becf,efd->becd")
    ye = ye.reshape(B, E * C, d) * buf_w[..., None].to(x.dtype)
    y = x.new_zeros((B, S + 1, d)).scatter_add(1, idx, ye)
    return y[:, :-1]


def moe_apply_einsum(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     group_size: int = 2048) -> torch.Tensor:
    """GShard-style one-hot dispatch/combine einsums over token subgroups.
    The same outputs as the sorted path under ample capacity; over
    capacity both drop the later pairs of an expert in token order."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    gs = min(group_size, S)
    ng = S // gs
    C = max(1, int(gs * k * cfg.moe_capacity_factor / E))
    xg = x.reshape(B, ng, gs, d)
    probs = torch.softmax(_router_logits(params, cfg, xg, "bnsd,de->bnse"),
                          dim=-1)
    top_w, top_e = _top_k(probs, k)                             # (B,ng,gs,k)
    experts = torch.arange(E, device=x.device)
    oh = (top_e[..., None] == experts).float()                  # (B,ng,gs,k,E)
    ohf = oh.reshape(B, ng, gs * k, E)
    pos = torch.cumsum(ohf, dim=2) - ohf                        # slot in expert
    pos_sel = (pos * ohf).sum(-1)                               # (B,ng,gs*k)
    keep = (pos_sel < C).float()
    slots = torch.arange(C, device=x.device)
    slot_oh = (pos_sel.long()[..., None] == slots).float()      # (B,ng,gs*k,C)
    dispatch = torch.einsum("bnse,bnsc->bnsec", ohf * keep[..., None],
                            slot_oh)
    wf = top_w.reshape(B, ng, gs * k).float()
    combine_w = dispatch * wf[..., None, None]                  # (B,ng,gs*k,E,C)
    xrep = xg.repeat_interleave(k, dim=2)                       # (B,ng,gs*k,d)
    xe = torch.einsum("bnsec,bnsd->bnecd", dispatch.to(x.dtype), xrep)
    ye = _experts(params, xe, "bnecd,edf->bnecf", "bnecf,efd->bnecd")
    y = torch.einsum("bnsec,bnecd->bnsd", combine_w.to(x.dtype), ye)
    # sum the k duplicated choices back per token
    y = y.reshape(B, ng, gs, k, d).sum(dim=3)
    return y.reshape(B, S, d)


def moe_load_balance_loss(params: Params, cfg: ArchConfig, x: torch.Tensor
                          ) -> torch.Tensor:
    """Switch-style router auxiliary loss: E · Σ_e f_e · p_e, where f_e is
    the fraction of tokens whose top-1 choice is expert e and p_e the mean
    router probability; 1 at a uniform distribution.  Opt-in: no loss of
    the port (or of the reference) adds it."""
    E = cfg.num_experts
    probs = torch.softmax(_router_logits(params, cfg, x, "bsd,de->bse"),
                          dim=-1)                               # (B,S,E)
    top1 = probs.argmax(-1)
    f = (top1[..., None] == torch.arange(E, device=x.device)).float()
    f = f.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    return E * (f * p).sum()


def moe_apply(params: Params, cfg: ArchConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """x: (B, S, d).  Dispatch per ``cfg.moe_dispatch``: ``sorted``
    (sort/gather), ``einsum`` (GShard one-hot), or ``auto`` (einsum iff the
    dispatch/expert flop ratio (2/3)·gs·k/f < 0.5 and the length divides
    the group size); then the shared experts, if any."""
    S = x.shape[1]
    mode = cfg.moe_dispatch
    gs = 2048 if S % 2048 == 0 else (1024 if S % 1024 == 0 else 0)
    if mode == "auto":
        ratio = (2 / 3) * (gs * cfg.experts_per_token) / max(1, cfg.moe_hidden)
        mode = "einsum" if (gs and ratio < 0.5) else "sorted"
    if mode == "einsum" and gs:
        y = moe_apply_einsum(params, cfg, x, group_size=gs)
    else:
        y = moe_apply_sorted(params, cfg, x)
    shared = sub(params, "shared")
    if shared:
        y = y + mlp_apply(shared, x)
    return y


# ---------------------------------------------------------------------------
# Mamba2 — SSD (state-space duality) chunked scan [arXiv:2405.21060]
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    cw = cfg.ssm_conv
    return {
        "w_x": Spec((d, H, P), ("embed", "ssm_head", "ssm_dim"), "fan_in"),
        "w_z": Spec((d, H, P), ("embed", "ssm_head", "ssm_dim"), "fan_in"),
        "w_B": Spec((d, G, N), ("embed", None, "ssm_state"), "fan_in"),
        "w_C": Spec((d, G, N), ("embed", None, "ssm_state"), "fan_in"),
        "w_dt": Spec((d, H), ("embed", "ssm_head"), "fan_in"),
        "dt_bias": Spec((H,), ("ssm_head",), "zeros"),
        "A_log": Spec((H,), ("ssm_head",), "zeros"),
        "D": Spec((H,), ("ssm_head",), "ones"),
        "conv_x": Spec((cw, H, P), (None, "ssm_head", "ssm_dim"), "fan_in"),
        "conv_B": Spec((cw, G, N), (None, None, "ssm_state"), "fan_in"),
        "conv_C": Spec((cw, G, N), (None, None, "ssm_state"), "fan_in"),
        "norm": {"scale": Spec((H, P), ("ssm_head", "ssm_dim"), "ones")},
        "w_out": Spec((H, P, d), ("ssm_head", "ssm_dim", "embed"), "fan_in"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  x: (B, L, *ch); w: (cw, *ch)."""
    cw, L = w.shape[0], x.shape[1]
    pad = torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + L] * w[i] for i in range(cw))
    return F.silu(out)


def _gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    x = x * F.silu(z)
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def mamba2_apply(params: Params, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, L, d)."""
    xin = torch.einsum("bld,dhp->blhp", x, params["w_x"])
    z = torch.einsum("bld,dhp->blhp", x, params["w_z"])
    Bm = torch.einsum("bld,dgn->blgn", x, params["w_B"])
    Cm = torch.einsum("bld,dgn->blgn", x, params["w_C"])
    xin = _causal_conv(xin, params["conv_x"])
    Bm = _causal_conv(Bm, params["conv_B"])
    Cm = _causal_conv(Cm, params["conv_C"])
    dt = F.softplus(torch.einsum("bld,dh->blh", x, params["w_dt"])
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    chunk = min(cfg.ssm_chunk, x.shape[1])
    if x.device.type == "cuda":
        y, _ = ssd_ops.ssd_scan(xin, dt, A, Bm, Cm, chunk=chunk)
    else:
        y, _ = ssd_scan(xin, dt.float(), A, Bm, Cm, chunk)
    y = y + xin * params["D"][None, None, :, None]
    y = _gated_rmsnorm(params["norm/scale"], y, z)
    return torch.einsum("blhp,hpd->bld", y, params["w_out"])


def mamba2_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B,1,d);
    conv_state: (B, cw-1, H*P + 2*G*N) channel history in the order
    ``[x | B | C]``; ssm_state: (B, H, P, N).  Returns (out (B,1,d),
    conv_state, ssm_state); both states are updated in place (the
    reference returns updated copies): the history shifts by one and the
    state is overwritten."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    cw = cfg.ssm_conv
    xin = torch.einsum("bld,dhp->blhp", x, params["w_x"])[:, 0]  # (B,H,P)
    z = torch.einsum("bld,dhp->blhp", x, params["w_z"])[:, 0]
    Bm = torch.einsum("bld,dgn->blgn", x, params["w_B"])[:, 0]
    Cm = torch.einsum("bld,dgn->blgn", x, params["w_C"])[:, 0]
    Bsz = x.shape[0]
    ch = torch.cat([xin.reshape(Bsz, -1), Bm.reshape(Bsz, -1),
                    Cm.reshape(Bsz, -1)], dim=-1)              # (B, ch)
    hist = torch.cat([conv_state, ch[:, None, :]], dim=1)      # (B,cw,ch)
    wall = torch.cat([params["conv_x"].reshape(cw, -1),
                      params["conv_B"].reshape(cw, -1),
                      params["conv_C"].reshape(cw, -1)], dim=-1)  # (cw, ch)
    conved = F.silu(torch.einsum("bcw,cw->bw", hist, wall))
    xin = conved[:, : H * P].reshape(Bsz, H, P)
    Bm = conved[:, H * P: H * P + G * N].reshape(Bsz, G, N)
    Cm = conved[:, H * P + G * N:].reshape(Bsz, G, N)
    dt = F.softplus(torch.einsum("bld,dh->blh", x, params["w_dt"])[:, 0]
                    + params["dt_bias"])                        # (B,H)
    A = -torch.exp(params["A_log"].float())
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1)                       # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A)[..., None, None]                  # (B,H,1,1)
    upd = dt[..., None, None] * torch.einsum("bhn,bhp->bhpn", Bh, xin)
    new = (ssm_state * decay.to(ssm_state.dtype)
           + upd.to(ssm_state.dtype))
    conv_state.copy_(hist[:, 1:])
    ssm_state.copy_(new)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state.to(x.dtype), Ch)
    y = y + xin * params["D"][None, :, None]
    y = _gated_rmsnorm(params["norm/scale"], y, z)
    out = torch.einsum("bhp,hpd->bd", y, params["w_out"])[:, None, :]
    return out, conv_state, ssm_state
