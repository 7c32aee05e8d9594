"""The port's own copy of the configuration its paths read.

:class:`ArchConfig` carries the fields of the JAX package's
``configs/base.py::ArchConfig`` that the sine MLP, the meta-trainer, the
dense decoder family (attention, MLP, norms), the Mamba2 family (the
``ssm_*`` fields), the MoE family (the MLA and ``moe_*`` fields) and the
encoder-decoder and vision families (``encoder_*``, ``cross_attn_every``,
``num_patches``, ``inner_freeze``) and the hybrid family (``attn_every``,
``moe_every``, ``moe_offset``) use, with the same names and defaults.
Each of the JAX package's ``configs/<name>.py`` is copied here as the
constant of that name in capitals (:data:`SINE_MLP`, :data:`QWEN2_7B`,
:data:`JAMBA_1_5_LARGE_398B`, ...), without the mesh fields
``attn_shard`` and ``placement``; :data:`ASSIGNED`, :data:`PAPER_OWN` and
:func:`list_archs` are the reference's lists of them.

:data:`INPUT_SHAPES`, :func:`register_input_shape` and
:func:`resolve_input_shape` are the reference's input-shape registry, with
its override and builtin-protection rules.
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


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524_288, 1, "decode"),
}

# The shapes that ship with the package: a run-local registration never
# displaces these.
_BUILTIN_SHAPES = frozenset(INPUT_SHAPES)


def register_input_shape(shape: InputShape, *,
                         override: bool = False) -> InputShape:
    """Register a run-local :class:`InputShape` under ``shape.name``.
    Re-registering an existing name raises unless ``override=True`` (the
    same value again is a no-op); a built-in shape is never displaced."""
    existing = INPUT_SHAPES.get(shape.name)
    if existing == shape:
        return shape
    if existing is not None:
        if shape.name in _BUILTIN_SHAPES:
            raise ValueError(
                f"input shape {shape.name!r} is built in ({existing}) and "
                f"cannot be overridden; register under a different name")
        if not override:
            raise ValueError(
                f"input shape {shape.name!r} is already registered as "
                f"{existing}; pass override=True to replace it")
    INPUT_SHAPES[shape.name] = shape
    return shape


def resolve_input_shape(shape: InputShape | str) -> InputShape:
    """A registered shape by name, or an :class:`InputShape` unchanged."""
    if isinstance(shape, InputShape):
        return shape
    try:
        return INPUT_SHAPES[shape]
    except KeyError:
        raise KeyError(
            f"unknown input shape {shape!r}: registered shapes are "
            f"{sorted(INPUT_SHAPES)} (register_input_shape adds run-local "
            f"ones)") from None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio | mlp | cnn
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
    # MLA (DeepSeek)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- mlp / moe ------------------------------------------------------------
    mlp_act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int | None = None     # per-expert hidden (defaults to d_ff)
    moe_every: int = 1              # MoE FFN on layers where (l % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense_layers: int = 0     # leading dense layers before MoE (deepseek)
    moe_capacity_factor: float = 1.25
    moe_router_dtype: str = "float32"
    moe_dispatch: str = "sorted"    # sorted | einsum | auto (layers.moe_apply)

    # --- ssm / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    attn_every: int = 0             # hybrid: 1 attention layer per `attn_every` layers

    # --- multimodal / enc-dec -------------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 0         # audio stub frontend sequence length
    cross_attn_every: int = 0       # vlm: every n-th layer is cross-attention
    num_patches: int = 0            # vlm stub frontend patches

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
    inner_freeze: str = ""          # param subtree frozen in the inner loop
                                    # (ANIL-style, e.g. "encoder")
    remat: bool = True
    remat_span: int = 1     # layers per checkpoint region (memory knob)

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    outer_dtype: str = ""    # params/grads storage for the outer loop; ""
                             # inherits dtype (Adam moments stay float32)
    combine_dtype: str = ""  # combine wire format; "" resolves through
                             # core.diffusion.resolve_combine_dtype

    # -------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return _pad(self.vocab_size)

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

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
        if self.num_experts:
            kw.update(num_experts=min(self.num_experts, 4),
                      num_shared_experts=min(self.num_shared_experts, 1),
                      experts_per_token=min(self.experts_per_token, 2),
                      moe_d_ff=min(self.moe_hidden, 128),
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                      v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=32, ssm_head_dim=16, ssm_chunk=32)
        if self.attn_every:
            kw.update(num_layers=self.attn_every)  # one full hybrid period
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_frames=16)
        if self.cross_attn_every:
            kw.update(num_layers=2 * self.cross_attn_every,
                      num_patches=min(self.num_patches or 16, 16))
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

# The paper's own classification model (§4.2, App. D.3): the Finn et al.
# 2017 conv net (per Vinyals et al. 2016), max-pooling variant for Omniglot.
# Offline surrogate: synthetic few-shot episodes (data/fewshot.py) on 14×14
# images, 2 conv blocks + linear head; 5-way 1-shot, α=0.4, meta-batch 16.
OMNIGLOT_CNN = ArchConfig(
    name="omniglot-cnn",
    arch_type="cnn",
    num_layers=2,          # conv blocks
    d_model=32,            # conv channels
    num_heads=1, num_kv_heads=1, head_dim=1,
    d_ff=0,
    vocab_size=5,          # n_way classes
    inner_lr=0.4,
    inner_steps=1,
    meta_tasks=4,
    topology="paper",
    outer_optimizer="adam",
    outer_lr=1e-3,
    meta_mode="maml",
    remat=False,
    dtype="float32",
    source="Dif-MAML §4.2 / Finn et al. 2017",
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

# mamba2-130m [arXiv:2405.21060]: attention-free SSD (state-space duality).
# 24 layers, d_model=768 (d_inner=1536, 24 SSD heads of head_dim 64),
# ssm_state=128, vocab=50280.  No attention, no FFN: each block is a single
# Mamba2 mixer.  num_heads/num_kv_heads/head_dim/d_ff are unused
# placeholders.
MAMBA2_130M = ArchConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,      # unused (attention-free)
    num_kv_heads=12,   # unused
    head_dim=64,       # unused
    d_ff=0,            # no FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    meta_mode="maml",
    outer_optimizer="adam",
    source="arXiv:2405.21060",
)

# deepseek-v2-lite-16b [arXiv:2405.04434]: MoE with Multi-head Latent
# Attention.  27 layers, d_model=2048, 16 heads, MLA kv_lora_rank=512 (+64
# rope dims), MoE: 64 routed experts top-6 + 2 shared, per-expert hidden
# 1408, vocab=102400.  The first layer has a dense FFN (hidden 10944).
# Outer optimizer: momentum (the reference's: fp32 Adam state for 16B does
# not fit beside the MAML adapted copy).
DEEPSEEK_V2_LITE_16B = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,            # q/k nope dim (MLA overrides per-component dims)
    d_ff=10944,              # dense FFN (layer 0)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    meta_mode="fomaml",
    outer_optimizer="momentum",
    source="arXiv:2405.04434",
)

# mixtral-8x22b [arXiv:2401.04088]: sparse MoE with sliding-window
# attention.  56 layers, d_model=6144, 48 heads (GQA kv=8, head_dim=128),
# 8 experts top-2 with per-expert hidden 16384, vocab=32768, window 4096.
MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1_000_000.0,
    meta_mode="fomaml",
    outer_optimizer="sgd",
    source="arXiv:2401.04088",
)

# whisper-large-v3 [arXiv:2212.04356]: encoder-decoder audio transformer.
# 32 encoder + 32 decoder layers, d_model=1280, 20 heads (MHA, head_dim 64),
# d_ff=5120, vocab=51866.  The mel-spectrogram and conv frontend are
# stubbed: the encoder reads (B, 1500, 1280) precomputed frame embeddings
# (30 s at 50 Hz).  LayerNorm, GELU and absolute sinusoidal positions (no
# RoPE).
WHISPER_LARGE_V3 = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,
    encoder_layers=32,
    encoder_frames=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    mlp_act="gelu",
    use_rope=False,
    qkv_bias=True,
    meta_mode="maml",
    outer_optimizer="adam",
    source="arXiv:2212.04356",
)

# llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision, scaled per the
# 90B card]: a decoder with interleaved tanh-gated cross-attention image
# layers.  100 layers = 20 periods of (4 self-attention + 1 gated
# cross-attention), d_model=8192, 64 heads (GQA kv=8), d_ff=28672,
# vocab=128256.  The ViT encoder and projector are stubbed: the decoder
# reads (B, 576, 8192) patch embeddings through ``vision_proj``.
LLAMA_3_2_VISION_90B = ArchConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_patches=576,
    rope_theta=500_000.0,
    meta_mode="fomaml",
    outer_optimizer="sgd",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

# qwen2-7b [arXiv:2407.10671]: dense GQA decoder with QKV bias.  28
# layers, d_model=3584, 28 heads (GQA kv=4, head_dim=128), d_ff=18944,
# vocab=152064.
QWEN2_7B = ArchConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    meta_mode="maml",
    outer_optimizer="adam",
    source="arXiv:2407.10671",
)

# qwen2-7b-swa: qwen2-7b with an 8k sliding window (the reference's
# beyond-paper variant, which bounds the decode KV cache at the window).
QWEN2_7B_SWA = dataclasses.replace(
    QWEN2_7B,
    name="qwen2-7b-swa",
    sliding_window=8192,
    source="arXiv:2407.10671 (+SWA long-context variant)",
)

# codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: qwen1.5-architecture dense MHA.
# 32 layers, d_model=4096, 32 heads (kv=32), d_ff=13440, vocab=92416, QKV
# bias, RoPE theta 1M.
CODEQWEN1_5_7B = ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    meta_mode="maml",
    outer_optimizer="adam",
    source="hf:Qwen/CodeQwen1.5-7B",
)

# command-r-35b [hf:CohereForAI/c4ai-command-r-v01]: dense GQA, no bias.
# 40 layers, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22528,
# vocab=256000, LayerNorm, SiLU-gated MLP, the sequential pre-norm block.
# Outer optimizer: SGD (35B fp32 Adam state would not fit beside the MAML
# adapted copy).
COMMAND_R_35B = ArchConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    rope_theta=8_000_000.0,
    meta_mode="maml",
    outer_optimizer="sgd",
    source="hf:CohereForAI/c4ai-command-r-v01",
)

# jamba-1.5-large-398b [arXiv:2403.19887]: hybrid Mamba+attention MoE.  72
# layers in 9 periods of 8 (1 attention : 7 Mamba), MoE (16 experts, top-2)
# on every other layer, d_model=8192, 64 heads (GQA kv=8), d_ff=24576,
# vocab=65536.  The Mamba mixers use the Mamba2/SSD formulation (state 128,
# head_dim 64).
JAMBA_1_5_LARGE_398B = ArchConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    use_rope=True,
    meta_mode="fomaml",
    outer_optimizer="sgd",
    source="arXiv:2403.19887",
)

_CONFIGS = {"sine_mlp": SINE_MLP, "omniglot_cnn": OMNIGLOT_CNN,
            "qwen2_1_5b": QWEN2_1_5B, "mamba2_130m": MAMBA2_130M,
            "deepseek_v2_lite_16b": DEEPSEEK_V2_LITE_16B,
            "mixtral_8x22b": MIXTRAL_8X22B,
            "whisper_large_v3": WHISPER_LARGE_V3,
            "llama_3_2_vision_90b": LLAMA_3_2_VISION_90B,
            "qwen2_7b": QWEN2_7B, "qwen2_7b_swa": QWEN2_7B_SWA,
            "codeqwen1_5_7b": CODEQWEN1_5_7B,
            "command_r_35b": COMMAND_R_35B,
            "jamba_1_5_large_398b": JAMBA_1_5_LARGE_398B}

# The reference's ``configs/base.py`` lists: the assigned LM configurations
# and the paper's own two models.
ASSIGNED = [
    "whisper_large_v3", "deepseek_v2_lite_16b", "qwen2_1_5b", "command_r_35b",
    "mixtral_8x22b", "jamba_1_5_large_398b", "mamba2_130m",
    "llama_3_2_vision_90b", "codeqwen1_5_7b", "qwen2_7b",
]
PAPER_OWN = ["sine_mlp", "omniglot_cnn"]


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _CONFIGS:
        raise ValueError(f"unknown config {name!r}; the port has "
                         f"{sorted(_CONFIGS)}")
    return _CONFIGS[key]


def list_archs(include_paper: bool = False) -> list[str]:
    return ASSIGNED + (PAPER_OWN if include_paper else [])
