"""The paper's sine-regression MLP (port of ``repro/models/simple.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.init import Spec, materialize


class SineMLP:
    """2 hidden layers × `width` ReLU units (paper App. D.1), functional:
    a param dict in, a loss out."""

    def __init__(self, cfg: ArchConfig):
        self.width = cfg.d_model
        self.depth = cfg.num_layers

    def specs(self) -> dict[str, Spec]:
        w = self.width
        dims = [1] + [w] * self.depth + [1]
        # Finn et al. 2017 use ~N(0, 0.01) weights; larger inits make the
        # α=0.01 inner step unstable on the raw x ∈ [-5, 5] inputs.
        specs = {}
        for i in range(len(dims) - 1):
            specs[f"l{i}/w"] = Spec((dims[i], dims[i + 1]), ("embed", "ffn"),
                                    "normal", 0.5)
            specs[f"l{i}/b"] = Spec((dims[i + 1],), ("ffn",), "zeros")
        # the reference's leaf order (sorted key paths), so reductions over
        # the leaves (the global-norm clip) sum in the same order
        return dict(sorted(specs.items()))

    def init(self, gen: torch.Generator, dtype=torch.float32, device=None):
        return materialize(self.specs(), gen, dtype, device)

    def forward(self, params: dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        n = self.depth + 1
        for i in range(n):
            x = x @ params[f"l{i}/w"] + params[f"l{i}/b"]
            if i < n - 1:
                x = torch.relu(x)
        return x

    def loss_fn(self, params: dict[str, torch.Tensor], batch) -> torch.Tensor:
        x, y = batch
        return torch.mean((self.forward(params, x) - y) ** 2)
