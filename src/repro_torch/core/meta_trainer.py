"""Decentralized meta-trainer: InnerAlgo × DiffusionStrategy × CommSchedule
(port of ``repro/core/meta_trainer.py``).

State layout: every parameter leaf carries a leading agent axis of size K.
One trainer step assembles three independently pluggable factors:

  1. **InnerAlgo** (:mod:`repro_torch.core.maml`): per-agent, per-task inner
     adaptation + meta-gradient, ``torch.func.vmap`` over agents and over
     tasks — ``maml | fomaml | reptile | maml_naive``.
  2. **DiffusionStrategy** (:mod:`repro_torch.core.update`): how the
     per-agent outer update composes with the combine —
     ``atc | cta | consensus | none | centralized``.
  3. **CommSchedule** × **TopologySchedule**: *when* agents communicate
     and *over which graph* at each step.

The step counter of :class:`TrainState` is a host-side int, so the
CommSchedule gate is a Python branch: a skipped step launches no combine
(the fused backend still runs its one kernel, with gate 0, because the
moments must advance).  Configuration is nested: :class:`TopologyConfig`
and :class:`UpdateConfig` inside :class:`MetaConfig`.  The reference's
deprecated flat aliases (``mode``, ``combine``, ...) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import diffusion, maml, topology, update
from repro_torch.device import resolve_device
from repro_torch.optim import (Optimizer, clip_by_global_norm,
                               get_optimizer)

Params = diffusion.Params
LossFn = Callable[[Params, Any], torch.Tensor]

__all__ = ["TopologyConfig", "UpdateConfig", "MetaConfig", "TrainState",
           "init_state", "make_meta_step", "make_eval_fn", "topology_for",
           "schedule_for", "combination_matrix_for", "strategy_for_combine"]


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Who mixes with whom: the graph family, the weight rule, and the
    per-step schedule (:data:`repro_torch.core.topology.SCHEDULES`)."""

    graph: str = "paper"              # ring | grid | torus | full | star | erdos | paper
    rule: str = "metropolis"          # metropolis | uniform
    schedule: str = "static"          # static | link_failure | gossip | round_robin
    link_failure_p: float = 0.2       # per-edge i.i.d. drop prob (link_failure)
    period: int = 64                  # pre-sampled steps for random schedules
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    """How and when the outer update composes with communication."""

    strategy: str = "atc"             # update.update_strategies() name
    inner: str = "maml"               # update.inner_algos() name
    backend: str = "dense"            # 'auto' | diffusion.combine_backends() name
    combine_every: int = 1            # CommSchedule cadence


@dataclasses.dataclass(frozen=True)
class MetaConfig:
    num_agents: int = 6
    tasks_per_agent: int = 4          # |S_k|
    inner_lr: float = 0.01            # α
    inner_steps: int = 1
    outer_optimizer: str = "adam"
    outer_lr: float = 1e-3            # μ
    grad_clip: float | None = None
    hvp_subsample: float = 1.0        # curvature-term batch fraction
    topology_config: TopologyConfig = dataclasses.field(
        default_factory=TopologyConfig)
    update_config: UpdateConfig = dataclasses.field(
        default_factory=UpdateConfig)


def strategy_for_combine(combine: str, default: str = "atc") -> str:
    """The strategy a bare combine name implies: 'none' and 'centralized'
    name strategies, every real backend plain ATC (``--combine``)."""
    return {"none": "none", "centralized": "centralized"}.get(combine,
                                                              default)


class TrainState(NamedTuple):
    step: int            # host-side step counter
    params: Params       # leading agent axis K on every leaf
    opt_state: Any       # per-agent moments (same leading axis)


def topology_for(cfg: MetaConfig) -> topology.Topology:
    """The validated :class:`~repro_torch.core.topology.Topology`."""
    tc = cfg.topology_config
    return topology.build_topology(tc.graph, cfg.num_agents, tc.rule)


def schedule_for(cfg: MetaConfig) -> topology.TopologySchedule:
    """The per-step combination-matrix schedule the trainer runs on."""
    tc = cfg.topology_config
    kw = {}
    if tc.schedule == "link_failure":
        kw = dict(p=tc.link_failure_p, period=tc.period, seed=tc.seed)
    elif tc.schedule == "gossip":
        kw = dict(period=tc.period, seed=tc.seed)
    return topology.make_schedule(tc.schedule, topology_for(cfg), **kw)


def combination_matrix_for(cfg: MetaConfig) -> np.ndarray:
    """The static ``(K, K)`` matrix (the schedule-independent legacy
    surface)."""
    if cfg.num_agents == 1:
        return np.ones((1, 1))
    return topology_for(cfg).matrix


def init_state(
    gen: torch.Generator,
    init_fn: Callable[..., Params],
    cfg: MetaConfig,
    optimizer: Optimizer | None = None,
    identical_init: bool = False,
    device=None,
) -> TrainState:
    """Stack K launch models (paper: "Initialize the launch models
    {w_{k,0}}"): one draw broadcast to every agent with
    ``identical_init``, else K consecutive draws from ``gen``.
    ``init_fn(gen, device=...)`` returns one model's param dict."""
    device = resolve_device(device)
    opt = optimizer or get_optimizer(cfg.outer_optimizer, cfg.outer_lr)
    K = cfg.num_agents
    if identical_init:
        p0 = init_fn(gen, device=device)
        params = {k: x.unsqueeze(0).expand((K,) + x.shape).clone()
                  for k, x in p0.items()}
    else:
        draws = [init_fn(gen, device=device) for _ in range(K)]
        params = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    return TrainState(0, params, opt.init(params))


def make_meta_step(
    loss_fn: LossFn,
    cfg: MetaConfig,
    optimizer: Optimizer | None = None,
    A: np.ndarray | None = None,
    combine_fn: diffusion.CombineFn | None = None,
    freeze_mask: dict[str, bool] | None = None,
    device=None,
):
    """Returns ``step(state, support, query) -> (state, metrics)``:
    the InnerAlgo × DiffusionStrategy × CommSchedule assembly.

    ``support``/``query``: pytrees of tensors on ``device`` with leading
    axes ``(K, tasks_per_agent, task_batch, ...)``.  ``A`` may be one
    ``(K, K)`` matrix or a stacked ``(S, K, K)`` schedule; when omitted it
    is derived from ``cfg.topology_config``.  ``combine_fn`` overrides the
    combine (signature ``combine(phi, step)``).  The metrics stay on the
    device: reading them is the caller's choice.
    """
    device = resolve_device(device)
    opt = optimizer or get_optimizer(cfg.outer_optimizer, cfg.outer_lr)
    uc = cfg.update_config
    strategy_name = uc.strategy if cfg.num_agents > 1 else "none"
    strategy = update.get_strategy(strategy_name)
    algo = update.get_inner_algo(uc.inner)
    comm = update.CommSchedule(uc.combine_every)
    fused_outer = None
    if uc.backend == "fused":
        # one-pass combine-then-update: clip scale, moments, launch-model
        # mix all happen inside one kernel launch per dtype group
        from repro_torch.core.fused import make_fused_outer
        if A is None and strategy.needs_combine_fn:
            A = schedule_for(cfg).stacked()
        fused_outer = make_fused_outer(
            opt, strategy_name, comm, A, grad_clip=cfg.grad_clip,
            num_agents=cfg.num_agents, device=device)
    if (combine_fn is None and strategy.needs_combine_fn
            and (fused_outer is None or strategy.pre_combine)):
        if A is None:
            A = schedule_for(cfg).stacked()
        backend = diffusion.resolve_schedule_backend(uc.backend, A)
        combine_fn = diffusion.make_combine(backend, A=A, device=device)

    def per_agent(params_k, support_k, query_k):
        return maml.multi_task_meta_grad(
            loss_fn, params_k, support_k, query_k,
            alpha=cfg.inner_lr, steps=cfg.inner_steps, mode=algo.mode,
            hvp_subsample=cfg.hvp_subsample, freeze_mask=freeze_mask)

    agents_grad = torch.func.vmap(per_agent)
    # the gate only matters when the strategy actually communicates
    gated = strategy.communicates and not comm.always

    def step(state: TrainState, support: Any, query: Any):
        idx = state.step
        comm_now = not gated or comm.is_comm_step(idx)
        base = state.params
        if strategy.pre_combine and comm_now:
            base = combine_fn(base, idx)
        losses, grads = agents_grad(base, support, query)
        if fused_outer is not None:
            # no skip: skipped comm steps must still advance the moments,
            # and the kernel's gate blends the mix to identity
            params, opt_state = fused_outer(base, grads, state.opt_state,
                                            idx)
        else:
            if cfg.grad_clip is not None:   # 0.0 is a valid (total) clip
                grads = torch.func.vmap(
                    lambda g: clip_by_global_norm(g, cfg.grad_clip))(grads)
            updates, opt_state = opt.update(grads, state.opt_state, base)
            if strategy.pre_combine or comm_now:
                params = strategy.apply(base, updates, combine_fn, idx)
            else:
                params = update.local_update(base, updates)
        metrics = {
            "loss": losses.mean(),
            "per_agent_loss": losses,
            "disagreement": diffusion.disagreement(params),
        }
        return TrainState(idx + 1, params, opt_state), metrics

    return step


def make_eval_fn(loss_fn: LossFn, inner_lr: float, inner_steps: int = 1):
    """``evaluate(params, support, query) -> (tasks, steps+1)``: adapt one
    launch model on each eval task's support set and report the query loss
    after *each* inner step (index 0 = zero-shot) —
    :meth:`repro_torch.eval.harness.EvalHarness.curves`."""
    from repro_torch.eval.harness import EvalHarness
    return EvalHarness(loss_fn, inner_lr=inner_lr,
                       inner_steps=inner_steps).curves
