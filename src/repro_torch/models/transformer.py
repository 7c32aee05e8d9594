"""Model assembly for the dense decoder, Mamba2, MoE, hybrid (jamba),
encoder-decoder (whisper) and vision (llama-3.2-vision) families — port of
``repro/models/transformer.py``.

A model is a list of **segments**; each segment repeats a **period** (a
short list of blocks) ``n`` times, with the period's parameters stacked on
a leading layer axis.  The reference scans the stack with ``lax.scan``; the
port loops over it in Python.  For a dense LM the plan is one segment of L
``attn + mlp`` blocks, for Mamba2 one segment of L ``mamba`` blocks, for
mixtral one of L ``attn + moe`` blocks, for deepseek ``first_dense_layers``
``mla + mlp`` blocks then the rest ``mla + moe``; for jamba one segment of
L / ``attn_every`` periods of one ``attn + mlp`` block and ``attn_every -
1`` ``mamba`` blocks, each with a ``moe`` FFN where ``i % moe_every ==
moe_offset`` (i its place in the period) and ``mlp`` elsewhere; for
llama-vision one segment of L / k periods of (k - 1) ``attn + mlp`` blocks
and one gated ``cross + mlp`` block; for whisper an encoder segment of
``attn_nc + mlp`` blocks and a decoder segment of (``attn``, ``cross +
mlp``) pairs.  The parameters are the flat dict of the reference's tree
(``segments/0/0/attn/wq`` has shape (L, d, H, hd),
``segments/0/0/mamba/w_x`` (L, d, H, P),
``encoder/segments/0/0/attn/wq``, ``segments/0/1/gate`` (L,)), and so is a
decode cache (``0/0/k`` beside ``0/1/conv`` and ``0/1/ssm`` in a jamba
period).

Two properties of the reference are kept as they are: the cross block of
both families carries llama's tanh gate, initialised to zero, so a fresh
whisper decoder ignores its encoder; and the frames and patches its
callers stub are zeros (``launch/steps.py::modality_extras``).

The reference wraps each layer in ``jax.checkpoint`` (``cfg.remat``).
``torch.func`` transforms reject ``torch.utils.checkpoint``, so the port
runs without it: remat changes memory, not numbers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.init import Spec, flatten_tree, materialize, stack_specs

Params = dict[str, torch.Tensor]

__all__ = ["BlockDesc", "Segment", "Model", "block_specs", "block_apply",
           "block_cache_specs", "block_decode", "segment_plan",
           "segment_specs", "segment_apply", "segment_cache_specs",
           "segment_decode", "decoder_cross_plan", "encoder_plan",
           "build_model"]


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str          # attn | attn_nc (non-causal) | mla | mamba | cross
    ffn: str            # dense | moe | none


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int
    period: tuple[BlockDesc, ...]


# ---------------------------------------------------------------------------
# Block specs / apply / decode
# ---------------------------------------------------------------------------

def _check_block(desc: BlockDesc) -> None:
    if desc.mixer not in ("attn", "attn_nc", "mla", "mamba", "cross") or \
            desc.ffn not in ("dense", "moe", "none"):
        raise ValueError(f"block {desc} is not a block of the port's "
                         f"families")


def block_specs(cfg: ArchConfig, desc: BlockDesc) -> dict:
    _check_block(desc)
    p: dict[str, Any] = {"norm1": L.norm_specs(cfg)}
    if desc.mixer == "mamba":
        p["mamba"] = L.mamba2_specs(cfg)
    elif desc.mixer == "mla":
        p["mla"] = L.mla_specs(cfg)
    elif desc.mixer == "cross":
        p["cross"] = L.attention_specs(cfg, cross=True)
        p["gate"] = Spec((), (), "zeros")       # llama-3.2 gated cross-attn
    else:
        p["attn"] = L.attention_specs(cfg)
    if desc.ffn != "none":
        p["norm2"] = L.norm_specs(cfg)
        p["ffn"] = (L.moe_specs(cfg) if desc.ffn == "moe"
                    else L.mlp_specs(cfg))
    return p


def _ffn(desc: BlockDesc, cfg: ArchConfig, p: Params, x: torch.Tensor
         ) -> torch.Tensor:
    h = L.norm_apply(L.sub(p, "norm2"), x)
    ffn = L.sub(p, "ffn")
    return x + (L.moe_apply(ffn, cfg, h) if desc.ffn == "moe"
                else L.mlp_apply(ffn, h))


def block_apply(cfg: ArchConfig, desc: BlockDesc, p: Params,
                x: torch.Tensor, positions: torch.Tensor,
                aux: dict[str, torch.Tensor]) -> torch.Tensor:
    """One block.  ``aux["enc"]`` (B, T, d) is what a cross block attends
    to: the encoder's states (whisper) or the projected patches (vision)."""
    h = L.norm_apply(L.sub(p, "norm1"), x)
    if desc.mixer == "mamba":
        x = x + L.mamba2_apply(L.sub(p, "mamba"), cfg, h)
    elif desc.mixer == "mla":
        x = x + L.mla_apply(L.sub(p, "mla"), cfg, h, positions)
    elif desc.mixer == "cross":
        y = L.attention_apply(L.sub(p, "cross"), cfg, h, positions,
                              causal=False, kv_x=aux["enc"])
        x = x + torch.tanh(p["gate"]) * y
    else:
        x = x + L.attention_apply(L.sub(p, "attn"), cfg, h, positions,
                                  causal=desc.mixer == "attn")
    if desc.ffn != "none":
        x = _ffn(desc, cfg, p, x)
    return x


def block_cache_specs(cfg: ArchConfig, desc: BlockDesc, batch: int,
                      cache_len: int) -> dict:
    """Spec tree of this block's decode state: the KV cache of an
    attention block, the latent cache of an MLA block (c_kv and the rope
    key), the conv history and the SSM state of a Mamba2 block (O(1) in the
    sequence), the encoder's fixed K/V of a cross block."""
    _check_block(desc)
    if desc.mixer == "cross":
        T = cfg.num_patches or cfg.encoder_frames
        kv = Spec((batch, T, cfg.num_kv_heads, cfg.head_dim),
                  ("batch", None, "kv_heads", "head_dim"), "zeros")
        return {"ck": kv, "cv": kv}
    if desc.mixer == "mla":
        return {"ckv": Spec((batch, cache_len, cfg.kv_lora_rank),
                            ("batch", "seq", "kv_lora"), "zeros"),
                "kr": Spec((batch, cache_len, cfg.qk_rope_dim),
                           ("batch", "seq", None), "zeros")}
    if desc.mixer == "mamba":
        H, P, N, G = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_groups)
        ch = H * P + 2 * G * N
        return {"conv": Spec((batch, cfg.ssm_conv - 1, ch),
                             ("batch", None, None), "zeros"),
                "ssm": Spec((batch, H, P, N),
                            ("batch", "ssm_head", "ssm_dim", "ssm_state"),
                            "zeros")}
    C = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    kv = Spec((batch, C, cfg.num_kv_heads, cfg.head_dim),
              ("batch", "seq", "kv_heads", "head_dim"), "zeros")
    return {"k": kv, "v": kv}


def block_decode(cfg: ArchConfig, desc: BlockDesc, p: Params, cache: Params,
                 x: torch.Tensor, pos: torch.Tensor
                 ) -> tuple[torch.Tensor, Params]:
    h = L.norm_apply(L.sub(p, "norm1"), x)
    if desc.mixer == "mamba":
        y, conv, ssm = L.mamba2_decode(L.sub(p, "mamba"), cfg, h,
                                       cache["conv"], cache["ssm"])
        x, cache = x + y, {"conv": conv, "ssm": ssm}
    elif desc.mixer == "mla":
        y, ckv, kr = L.mla_decode(L.sub(p, "mla"), cfg, h, pos,
                                  cache["ckv"], cache["kr"])
        x, cache = x + y, {"ckv": ckv, "kr": kr}
    elif desc.mixer == "cross":
        y = L.cross_attention_decode(L.sub(p, "cross"), cfg, h,
                                     cache["ck"], cache["cv"])
        x = x + torch.tanh(p["gate"]) * y
    else:
        y, ck, cv = L.attention_decode(L.sub(p, "attn"), cfg, h, pos,
                                       cache["k"], cache["v"])
        x, cache = x + y, {"k": ck, "v": cv}
    if desc.ffn != "none":
        x = _ffn(desc, cfg, p, x)
    return x, cache


# ---------------------------------------------------------------------------
# Segment plans
# ---------------------------------------------------------------------------

def segment_plan(cfg: ArchConfig) -> list[Segment]:
    t = cfg.arch_type
    if t == "ssm":
        return [Segment(cfg.num_layers, (BlockDesc("mamba", "none"),))]
    if t == "hybrid":
        per = [BlockDesc("attn", "dense")]
        for i in range(1, cfg.attn_every):
            moe = cfg.num_experts and i % cfg.moe_every == cfg.moe_offset
            per.append(BlockDesc("mamba", "moe" if moe else "dense"))
        return [Segment(cfg.num_layers // cfg.attn_every, tuple(per))]
    if t == "vlm":
        k = cfg.cross_attn_every
        per = tuple([BlockDesc("attn", "dense")] * (k - 1)
                    + [BlockDesc("cross", "dense")])
        return [Segment(cfg.num_layers // k, per)]
    if t == "moe" and cfg.use_mla:  # deepseek
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment(cfg.first_dense_layers,
                                (BlockDesc("mla", "dense"),)))
        segs.append(Segment(cfg.num_layers - cfg.first_dense_layers,
                            (BlockDesc("mla", "moe"),)))
        return segs
    if t == "moe":
        return [Segment(cfg.num_layers, (BlockDesc("attn", "moe"),))]
    if t not in ("dense", "audio"):
        raise ValueError(
            f"{cfg.name}: arch_type {t!r} is not a family of the port; its "
            f"LM families are dense, moe, ssm, hybrid, vlm and audio")
    # dense / audio decoder
    return [Segment(cfg.num_layers, (BlockDesc("attn", "dense"),))]


def decoder_cross_plan(cfg: ArchConfig) -> list[Segment]:
    """Whisper decoder: self-attn + cross-attn + mlp per layer."""
    return [Segment(cfg.num_layers,
                    (BlockDesc("attn", "none"), BlockDesc("cross", "dense")))]


def encoder_plan(cfg: ArchConfig) -> list[Segment]:
    return [Segment(cfg.encoder_layers, (BlockDesc("attn_nc", "dense"),))]


# ---------------------------------------------------------------------------
# Segment-level specs / apply / decode (a loop over the stacked layer axis)
# ---------------------------------------------------------------------------

def segment_specs(cfg: ArchConfig, seg: Segment) -> tuple:
    return tuple(stack_specs(block_specs(cfg, d), seg.n) for d in seg.period)


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params.items()}


def segment_apply(cfg: ArchConfig, seg: Segment, params: Params,
                  x: torch.Tensor, positions: torch.Tensor, aux: dict
                  ) -> torch.Tensor:
    """``params``: this segment's flat dict (keys ``{period index}/...``),
    every leaf stacked on a leading axis of size ``seg.n``."""
    blocks = [L.sub(params, str(j)) for j in range(len(seg.period))]
    for i in range(seg.n):
        for desc, p in zip(seg.period, blocks):
            x = block_apply(cfg, desc, _layer(p, i), x, positions, aux)
    return x


def segment_cache_specs(cfg: ArchConfig, seg: Segment, batch: int,
                        cache_len: int) -> tuple:
    return tuple(stack_specs(block_cache_specs(cfg, d, batch, cache_len),
                             seg.n) for d in seg.period)


def segment_decode(cfg: ArchConfig, seg: Segment, params: Params,
                   cache: Params, x: torch.Tensor, pos: torch.Tensor
                   ) -> tuple[torch.Tensor, Params]:
    """One token through the segment; ``cache`` (flat, keys
    ``{period index}/k``...) is updated in place and returned."""
    blocks = [L.sub(params, str(j)) for j in range(len(seg.period))]
    caches = [L.sub(cache, str(j)) for j in range(len(seg.period))]
    for i in range(seg.n):
        for desc, p, c in zip(seg.period, blocks, caches):
            x, _ = block_decode(cfg, desc, _layer(p, i), _layer(c, i), x,
                                pos)
    return x, cache


# ---------------------------------------------------------------------------
# Full models
# ---------------------------------------------------------------------------

class Model:
    """Bundles specs + pure functions for one architecture."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.plan = segment_plan(cfg)
        self.is_encdec = cfg.arch_type == "audio"
        if self.is_encdec:
            self.plan = decoder_cross_plan(cfg)
            self.enc_plan = encoder_plan(cfg)

    # -- specs ---------------------------------------------------------------
    def specs(self) -> dict[str, Spec]:
        """Flat dict of the reference's Spec tree."""
        cfg = self.cfg
        V, d = cfg.padded_vocab, cfg.d_model
        p: dict[str, Any] = {
            "embed": Spec((V, d), ("vocab", "embed"), "embed", 0.02),
            "final_norm": L.norm_specs(cfg),
            "head": Spec((d, V), ("embed", "vocab"), "fan_in"),
            "segments": [segment_specs(cfg, s) for s in self.plan],
        }
        if self.is_encdec:
            p["encoder"] = {
                "segments": [segment_specs(cfg, s) for s in self.enc_plan],
                "final_norm": L.norm_specs(cfg),
            }
        if cfg.arch_type == "vlm":
            # stub projector: patch embeddings (already d_model) -> d_model
            p["vision_proj"] = Spec((d, d), ("embed", None), "fan_in")
        return flatten_tree(p)

    def init(self, gen: torch.Generator, dtype: torch.dtype = torch.float32,
             device=None) -> Params:
        return materialize(self.specs(), gen, dtype, device)

    # -- encoder (whisper stub frontend: frames are precomputed embeddings) --
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Encoder states (B, F, d) of frames (B, F, d)."""
        cfg = self.cfg
        F = frames.shape[1]
        x = frames + _positions(F, cfg.d_model, frames.dtype, frames.device)
        positions = torch.arange(F, device=x.device)[None]
        enc = L.sub(params, "encoder")
        for si, seg in enumerate(self.enc_plan):
            x = segment_apply(cfg, seg, L.sub(enc, f"segments/{si}"), x,
                              positions, {})
        return L.norm_apply(L.sub(enc, "final_norm"), x)

    def _aux(self, params: Params, batch: dict) -> dict:
        if self.is_encdec:
            return {"enc": self.encode(params, batch["encoder_frames"])}
        if self.cfg.arch_type == "vlm":
            return {"enc": batch["image_patches"] @ params["vision_proj"]}
        return {}

    # -- forward -------------------------------------------------------------
    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        S = tokens.shape[-1]
        x = params["embed"][tokens]
        if not self.cfg.use_rope:  # absolute positions (whisper decoder)
            x = x + _positions(S, self.cfg.d_model, x.dtype, x.device)
        positions = torch.arange(S, device=x.device)[None]
        aux = self._aux(params, batch)
        for si, seg in enumerate(self.plan):
            x = segment_apply(self.cfg, seg, L.sub(params, f"segments/{si}"),
                              x, positions, aux)
        x = L.norm_apply(L.sub(params, "final_norm"), x)
        return x @ params["head"]

    def loss_fn(self, params: Params, batch: dict) -> torch.Tensor:
        logits = self.forward(params, batch).float()
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (logz - gold).mean()

    # -- decode --------------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int) -> dict[str, Spec]:
        return flatten_tree([segment_cache_specs(self.cfg, s, batch,
                                                 cache_len)
                             for s in self.plan])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None,
                   params: Params | None = None,
                   enc: torch.Tensor | None = None) -> Params:
        """Zero caches, flat dict keyed ``{segment}/{period index}/k``...;
        given ``params`` and the encoder states ``enc`` (B, T, d), the cross
        blocks' K/V are filled from them."""
        device = resolve_device(device)
        cache = {k: torch.zeros(s.shape, dtype=dtype, device=device)
                 for k, s in self.cache_specs(batch, cache_len).items()}
        if enc is not None and params is not None:
            self._fill_cross(params, cache, enc, dtype)
        return cache

    def _fill_cross(self, params: Params, cache: Params, enc: torch.Tensor,
                    dtype: torch.dtype) -> None:
        for si, seg in enumerate(self.plan):
            for pi, desc in enumerate(seg.period):
                if desc.mixer != "cross":
                    continue
                p = L.sub(params, f"segments/{si}/{pi}/cross")
                for i in range(seg.n):
                    k, v = L.cross_kv(_layer(p, i), enc)
                    cache[f"{si}/{pi}/ck"][i] = k.to(dtype)
                    cache[f"{si}/{pi}/cv"][i] = v.to(dtype)

    def decode_step(self, params: Params, cache: Params, token: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
        """One decode step.  token: (B,1) int, pos: (B,) int.  Returns
        (logits (B,1,V), cache); the cache is updated in place."""
        x = params["embed"][token]
        if not self.cfg.use_rope:
            pe = _sinusoid_at(pos, self.cfg.d_model).to(x.dtype)
            x = x + pe[:, None, :]
        for si, seg in enumerate(self.plan):
            x, _ = segment_decode(self.cfg, seg,
                                  L.sub(params, f"segments/{si}"),
                                  L.sub(cache, str(si)), x, pos)
        x = L.norm_apply(L.sub(params, "final_norm"), x)
        return x @ params["head"], cache


@functools.lru_cache(maxsize=16)
def _positions(S: int, d: int, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    """The (S, d) sinusoidal table in ``dtype`` on ``device``, made once."""
    return torch.from_numpy(L.sinusoidal_positions(S, d)).to(device, dtype)


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(B, d) float32 sinusoidal positions of ``pos`` (B,), computed on the
    device from ``exp`` of an arange, as the reference's decode computes
    them (its forward's numpy table differs from it by rounding)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device)
                    * (-np.log(10000.0) / d))
    ang = pos[:, None].float() * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        pos.shape[0], d)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
