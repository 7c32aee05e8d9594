"""The port's own copy of the configuration its paths read.

:class:`ArchConfig` carries the fields of the JAX package's
``configs/base.py::ArchConfig`` that the sine MLP, the meta-trainer and the
dense decoder family (attention, MLP, norms) use, with the same names and
defaults.  :data:`SINE_MLP` and :data:`QWEN2_1_5B` are
``configs/sine_mlp.py`` and ``configs/qwen2_1_5b.py`` copied.  Later slices
add the fields and configurations their models read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

VOCAB_PAD = 256


def _pad(v: int, m: int = VOCAB_PAD) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | mlp (the port's families)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    source: str = ""                # citation

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    use_rope: bool = True
    attn_q_chunk: int | None = 512   # flash-style query chunking (None = full)

    # --- mlp ------------------------------------------------------------------
    mlp_act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm

    # --- meta-learning (Dif-MAML) -------------------------------------------
    meta_mode: str = "maml"         # maml | fomaml | reptile
    meta_tasks: int = 2             # tasks per agent per step
    inner_lr: float = 1e-2
    inner_steps: int = 1
    topology: str = "ring"
    combine: str = "dense"
    outer_optimizer: str = "adam"
    outer_lr: float = 1e-3
    hvp_subsample: float = 1.0
    remat: bool = True
    remat_span: int = 1     # layers per checkpoint region (memory knob)

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"

    # -------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return _pad(self.vocab_size)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (the reference's
        ``reduced`` for the fields the port carries)."""
        kw: dict[str, Any] = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            remat=False,
        )
        if self.sliding_window:
            kw.update(sliding_window=64)
        return dataclasses.replace(self, **kw)


# The paper's own regression model (§4.1, App. D.1): an MLP with 2 hidden
# layers of 40 ReLU units, MSE loss, 10-shot sine-wave tasks, α=0.01,
# Adam μ=0.001 (SGD variant μ=0.005), K=6 agents on the Fig. 2a graph.
SINE_MLP = ArchConfig(
    name="sine-mlp",
    arch_type="mlp",
    num_layers=2,          # hidden layers
    d_model=40,            # hidden width
    num_heads=1, num_kv_heads=1, head_dim=1,
    d_ff=0,
    vocab_size=1,          # regression: 1-d input / 1-d output
    inner_lr=0.01,
    inner_steps=1,
    meta_tasks=5,
    topology="paper",
    outer_optimizer="adam",
    outer_lr=1e-3,
    meta_mode="maml",
    remat=False,
    dtype="float32",
    source="Dif-MAML §4.1 / Finn et al. 2017",
)

# qwen2-1.5b [arXiv:2407.10671]: dense GQA decoder with QKV bias.  28
# layers, d_model=1536, 12 heads (GQA kv=2, head_dim=128), d_ff=8960,
# vocab=151936.
QWEN2_1_5B = ArchConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    meta_mode="maml",
    outer_optimizer="adam",
    source="arXiv:2407.10671",
)

_CONFIGS = {"sine_mlp": SINE_MLP, "qwen2_1_5b": QWEN2_1_5B}

# The JAX package's other configurations and the port slice that brings
# each family.
_LATER = {
    "mamba2_130m": "the SSD-scan slice (mamba2-130m)",
    "jamba_1_5_large_398b": "a hybrid Mamba/MoE slice",
    "mixtral_8x22b": "an MoE slice",
    "deepseek_v2_lite_16b": "an MLA/MoE slice",
    "llama_3_2_vision_90b": "a vision (cross-attention) slice",
    "whisper_large_v3": "an encoder-decoder (audio) slice",
    "omniglot_cnn": "the few-shot CNN slice",
    "qwen2_7b": "a later dense-decoder configuration",
    "qwen2_7b_swa": "a later dense-decoder configuration",
    "codeqwen1_5_7b": "a later dense-decoder configuration",
    "command_r_35b": "a later dense-decoder configuration",
}


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key in _LATER:
        raise ValueError(f"config {name!r} is not ported yet: it comes with "
                         f"{_LATER[key]}; the port has {sorted(_CONFIGS)}")
    if key not in _CONFIGS:
        raise ValueError(f"unknown config {name!r}; the port has "
                         f"{sorted(_CONFIGS)}")
    return _CONFIGS[key]
