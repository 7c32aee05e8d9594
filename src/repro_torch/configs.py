"""The port's own copy of the configuration the sine path reads.

:class:`ArchConfig` carries the fields of the JAX package's
``configs/base.py::ArchConfig`` that the sine MLP and the meta-trainer use,
with the same names and defaults; :data:`SINE_MLP` is ``configs/sine_mlp.py``
copied.  Later slices add the fields their models read.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # mlp (this slice)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    source: str = ""                # citation

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

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"


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

_CONFIGS = {"sine_mlp": SINE_MLP}


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _CONFIGS:
        raise ValueError(f"unknown config {name!r}; the port has "
                         f"{sorted(_CONFIGS)}")
    return _CONFIGS[key]
