"""Minimal optimizer library over flat param dicts (port of
``repro/optim/optimizers.py``).

``Optimizer`` is a pair of pure functions:

    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = {k: p + updates[k] for k, p in params.items()}

All states are dicts of tensors shaped like the parameters, so parameters
with a leading agent axis get per-agent optimizer moments for free (the
paper's agents each run a local Adam; only launch models are combined).

The per-leaf scalar math (moment recursions, update directions, the clip
scale) is factored into standalone functions so the tree-level ``update``
here and both plain versions of the fused kernel
(:mod:`repro_torch.kernels.dif_combine.ref`) evaluate the *same
expressions*; the CUDA kernel evaluates them in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Declarative form of an optimizer's per-leaf update: which scalar
    recursion (``kind``) with which hyperparameters.  The fused outer-update
    kernel (:func:`repro_torch.core.fused.make_fused_outer`) consumes this
    to reproduce ``opt.update`` in-kernel; an optimizer without one (custom
    ``Optimizer`` instances) disqualifies the fused path."""

    kind: str                     # 'sgd' | 'momentum' | 'adam'
    lr: float
    b1: float = 0.9               # adam
    b2: float = 0.999             # adam
    eps: float = 1e-8             # adam
    weight_decay: float = 0.0     # adam(W): decoupled decay
    beta: float = 0.9             # momentum

    @property
    def n_moments(self) -> int:
        """Moment buffers per parameter (adam: mu+nu; momentum: v)."""
        return {"sgd": 0, "momentum": 1, "adam": 2}[self.kind]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], object]
    update: Callable[[Params, object, Params], tuple[dict, object]]
    fused: FusedSpec | None = None


def tree_map(fn, *trees: Params) -> dict[str, torch.Tensor]:
    """``fn`` over the matching leaves of flat dicts (the first one's keys)."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


# ---------------------------------------------------------------------------
# Shared per-leaf scalar math — the single source both the tree-level
# ``update`` functions below and the fused kernel's plain version evaluate
# ---------------------------------------------------------------------------

def adam_mu(mu, g32, b1: float):
    """First-moment (mean) recursion on an fp32 gradient leaf."""
    return b1 * mu + (1 - b1) * g32


def adam_nu(nu, g32, b2: float):
    """Second-moment (uncentered variance) recursion on an fp32 leaf."""
    return b2 * nu + (1 - b2) * torch.square(g32)


def adam_direction(mu, nu, bc1, bc2, *, lr: float, eps: float,
                   weight_decay: float = 0.0, p32=None):
    """Bias-corrected Adam(W) update direction (fp32)."""
    u = -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    if weight_decay:
        u = u - lr * weight_decay * p32
    return u


def momentum_velocity(v, g, beta: float):
    """Heavy-ball velocity recursion (in the velocity's own dtype)."""
    return beta * v + g


def momentum_direction(v, *, lr: float):
    return -lr * v


def sgd_direction(g, *, lr: float):
    return -lr * g


def global_norm_scale(grads: Params, max_norm: float) -> torch.Tensor:
    """The scalar :func:`clip_by_global_norm` multiplies every leaf by:
    ``min(1, max_norm / (‖g‖₂ + 1e-12))`` with the norm in fp32.
    ``max_norm=0.0`` is a valid total clip (scale 0)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


# ---------------------------------------------------------------------------
# SGD / momentum
# ---------------------------------------------------------------------------

def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: sgd_direction(g, lr=lr), grads), state

    return Optimizer(init, update, fused=FusedSpec("sgd", lr))


class MomentumState(NamedTuple):
    velocity: dict


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return MomentumState(tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        v = tree_map(lambda v, g: momentum_velocity(v, g, beta),
                     state.velocity, grads)
        return (tree_map(lambda v: momentum_direction(v, lr=lr), v),
                MomentumState(v))

    return Optimizer(init, update, fused=FusedSpec("momentum", lr, beta=beta))


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the params' device
    mu: dict
    nu: dict


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        device = next(iter(params.values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         tree_map(zeros, params), tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        t = step.float()
        mu = tree_map(lambda m, g: adam_mu(m, g.float(), b1), state.mu, grads)
        nu = tree_map(lambda v, g: adam_nu(v, g.float(), b2), state.nu, grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def u(m, v, p):
            upd = adam_direction(m, v, bc1, bc2, lr=lr, eps=eps,
                                 weight_decay=weight_decay, p32=p.float())
            return upd.to(p.dtype)

        return tree_map(u, mu, nu, params), AdamState(step, mu, nu)

    return Optimizer(init, update,
                     fused=FusedSpec("adam", lr, b1=b1, b2=b2, eps=eps,
                                     weight_decay=weight_decay))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


# ---------------------------------------------------------------------------
# Gradient transformations
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads: Params, max_norm: float) -> dict:
    scale = global_norm_scale(grads, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    table = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}
    return table[name](lr, **kw)
