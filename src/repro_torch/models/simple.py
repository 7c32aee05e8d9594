"""The paper's own models: the sine-regression MLP and the few-shot conv
net (port of ``repro/models/simple.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


class FewShotCNN:
    """Conv blocks (3×3, stride 1, SAME padding, ReLU, 2×2 max-pool) and a
    linear head over flattened ``(hw·hw,)`` synthetic images
    (:mod:`repro_torch.data.fewshot`), functional like :class:`SineMLP`.

    The param dict keeps the reference's keys and layouts: conv weights
    ``conv{i}/w`` are HWIO ``(3, 3, cin, ch)`` and ``forward`` permutes them
    to torch's OIHW, so weights cross between the packages
    (``convert.from_jax_params``, checkpoints) unchanged.  The head reads
    the last feature map flattened in NHWC order, (h, w, c), as the
    reference does.  Pooling drops an odd last row and column (14 → 7 → 3),
    as the reference's VALID ``reduce_window`` does.
    """

    def __init__(self, cfg: ArchConfig, image_hw: int = 14):
        self.ch = cfg.d_model
        self.blocks = cfg.num_layers
        self.n_way = cfg.vocab_size
        self.hw = image_hw

    def specs(self) -> dict[str, Spec]:
        p = {}
        cin, hw = 1, self.hw
        for i in range(self.blocks):
            p[f"conv{i}/w"] = Spec((3, 3, cin, self.ch),
                                   (None, None, None, "ffn"), "fan_in", 0.5)
            p[f"conv{i}/b"] = Spec((self.ch,), ("ffn",), "zeros")
            cin, hw = self.ch, hw // 2
        p["head/w"] = Spec((hw * hw * self.ch, self.n_way), ("embed", None),
                           "fan_in", 0.3)
        p["head/b"] = Spec((self.n_way,), (None,), "zeros")
        return dict(sorted(p.items()))      # the reference's leaf order

    def init(self, gen: torch.Generator, dtype=torch.float32, device=None):
        return materialize(self.specs(), gen, dtype, device)

    def forward(self, params: dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = x.reshape(B, 1, self.hw, self.hw)
        for i in range(self.blocks):
            w = params[f"conv{i}/w"].permute(3, 2, 0, 1)      # HWIO → OIHW
            h = F.conv2d(h, w, padding=1) + params[f"conv{i}/b"][:, None,
                                                                  None]
            h = F.max_pool2d(torch.relu(h), 2)
        h = h.permute(0, 2, 3, 1).reshape(B, -1)               # NHWC order
        return h @ params["head/w"] + params["head/b"]

    def loss_fn(self, params: dict[str, torch.Tensor], batch) -> torch.Tensor:
        x, y = batch
        logits = self.forward(params, x)
        gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
        return torch.mean(torch.logsumexp(logits, -1) - gold)

    def accuracy(self, params: dict[str, torch.Tensor],
                 batch) -> torch.Tensor:
        x, y = batch
        return torch.mean((self.forward(params, x).argmax(-1) == y)
                          .to(torch.float32))
