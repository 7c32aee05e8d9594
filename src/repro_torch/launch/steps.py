"""Step builders shared by the port's entry points (port of
``repro/launch/steps.py``): the batch geometry, input specs, the Dif-MAML
train step with its :class:`TrainBundle`, the superstep, and the decode
step.

The reference builds each step for a mesh and assigns every tensor a
sharding; the port runs on one card, so there is no mesh, K is the
caller's, and the reference's ``agent_count``, ``input_axes`` and
``lint_metadata`` (mesh and compiled-program analysis) and the
``sparse``/``mesh_sparse`` combine backends (ROADMAP Queue 1, item 11) are
not ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import ArchConfig, InputShape, resolve_input_shape
from repro_torch.core import diffusion, update
from repro_torch.core.meta_trainer import (MetaConfig, TopologyConfig,
                                           TrainState, UpdateConfig,
                                           init_state, make_meta_step,
                                           schedule_for,
                                           strategy_for_combine)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.optim import get_optimizer

__all__ = ["DTYPES", "SUPERSTEP_METRICS", "ServeBundle", "TrainBundle",
           "batch_geometry", "build_serve", "build_train", "cut_depth",
           "input_specs",
           "make_superstep", "meta_config_for", "modality_extras",
           "split_meta_batch"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Combine backends the reference runs over a device mesh; the port has none.
_MESH_BACKENDS = ("sparse", "mesh_sparse")


# ---------------------------------------------------------------------------
# Agent / batch geometry
# ---------------------------------------------------------------------------

def batch_geometry(cfg: ArchConfig, shape: InputShape, K: int
                   ) -> tuple[int, int]:
    """(tasks_per_agent, task_batch): B = K · T · tb · 2 (support+query).

    T starts at ``cfg.meta_tasks`` and falls back toward 1 until it divides
    the per-agent half-batch; the global batch must factor exactly."""
    B = shape.global_batch
    if K < 1 or B < 2 * K or B % (2 * K):
        raise ValueError(
            f"global_batch={B} cannot be split across K={K} agents: the "
            f"meta step folds the batch as B = K·T·tb·2 (support+query), "
            f"so global_batch must be a multiple of 2·K = {2 * max(K, 1)} "
            f"(minimum {2 * max(K, 1)})")
    half = B // K // 2
    T = cfg.meta_tasks
    while half % T:
        T -= 1
    if T != cfg.meta_tasks:
        warnings.warn(
            f"meta_tasks={cfg.meta_tasks} does not divide the per-agent "
            f"half-batch {half} (global_batch={B}, K={K}); falling back to "
            f"T={T} tasks per agent — the eq. 4 multi-task average degrades "
            f"(T=1 erases it entirely). Pick a global_batch divisible by "
            f"2·K·meta_tasks to keep the requested T.",
            RuntimeWarning, stacklevel=2)
    return T, half // T


def cut_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """``cfg`` cut to ``layers`` layers at full width (the entry points'
    ``--layers``): the encoder-decoder family cuts its encoder and its
    decoder each to ``layers``; the vision family takes a multiple of
    ``cross_attn_every`` and the hybrid family a multiple of
    ``attn_every`` (whole periods), and each raises otherwise."""
    if cfg.arch_type == "vlm" and layers % cfg.cross_attn_every:
        raise ValueError(
            f"{cfg.name}: --layers {layers} is not a multiple of "
            f"cross_attn_every={cfg.cross_attn_every} (a period of "
            f"{cfg.cross_attn_every - 1} self-attention blocks and one "
            f"cross-attention block)")
    if cfg.arch_type == "hybrid" and (layers < cfg.attn_every
                                      or layers % cfg.attn_every):
        raise ValueError(
            f"{cfg.name}: --layers {layers} is not a multiple of "
            f"attn_every={cfg.attn_every} (a period of one attention block "
            f"and {cfg.attn_every - 1} Mamba blocks)")
    kw = dict(num_layers=layers)
    if cfg.arch_type == "audio":
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def modality_extras(cfg: ArchConfig, lead: tuple[int, ...],
                    dtype: torch.dtype, device=None) -> dict:
    """Zero-stub modality inputs (audio frames / vision patches) the
    model's loss expects beyond tokens/labels, with the given leading axes,
    in ``dtype`` on ``device`` (None: the CUDA card) — the one place the
    modality-input contract is spelled; the train pipeline (``lead=(B,)``
    or ``(C, B)``), the eval harness (``lead=(n_tasks, tb)``) and serving
    build their stubs here."""
    shapes = {}
    if cfg.arch_type == "audio":
        shapes["encoder_frames"] = (cfg.encoder_frames, cfg.d_model)
    if cfg.arch_type == "vlm":
        shapes["image_patches"] = (cfg.num_patches, cfg.d_model)
    if not shapes:
        return {}
    device = resolve_device(device)
    return {k: torch.zeros(tuple(lead) + s, dtype=dtype, device=device)
            for k, s in shapes.items()}


def split_meta_batch(cfg: ArchConfig, batch: dict, K: int, T: int, tb: int
                     ) -> tuple[dict, dict]:
    """(B, ...) tensors → support/query dicts with leading (K, T, tb, ...)
    (views, no copy)."""
    def leaf(x):
        return x.reshape((K, T, 2 * tb) + tuple(x.shape[1:]))

    folded = {k: leaf(v) for k, v in batch.items()}
    support = {k: v[:, :, :tb] for k, v in folded.items()}
    query = {k: v[:, :, tb:] for k, v in folded.items()}
    return support, query


def input_specs(cfg: ArchConfig, shape_name: str | InputShape
                ) -> dict[str, Any]:
    """Meta tensors (shape and dtype, no memory) for every model input of
    one (arch × input shape): train/prefill {tokens, labels [,
    encoder_frames | image_patches]}; decode {token, pos, cache}."""
    shape = resolve_input_shape(shape_name)
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        return {"tokens": meta((B, S), torch.int32),
                "labels": meta((B, S), torch.int32),
                **modality_extras(cfg, (B,), DTYPES[cfg.dtype], "meta")}
    model = build_model(cfg)
    return {"token": meta((B, 1), torch.int32),
            "pos": meta((B,), torch.int32),
            "cache": {k: meta(s.shape, DTYPES[cfg.dtype])
                      for k, s in model.cache_specs(B, S).items()}}


# ---------------------------------------------------------------------------
# Train step (Dif-MAML meta-iteration)
# ---------------------------------------------------------------------------

def meta_config_for(cfg: ArchConfig, K: int, T: int, *,
                    strategy: str | None = None,
                    schedule: str = "static",
                    link_failure_p: float = 0.2,
                    schedule_seed: int = 0) -> MetaConfig:
    """The nested MetaConfig from the arch's meta fields plus the run's
    strategy/schedule choices (``--strategy``/``--topology-schedule``)."""
    if K == 1:
        strategy, backend = "none", "none"
    else:
        strategy, backend = strategy or "atc", cfg.combine
    return MetaConfig(
        num_agents=K,
        tasks_per_agent=T,
        inner_lr=cfg.inner_lr,
        inner_steps=cfg.inner_steps,
        outer_optimizer=cfg.outer_optimizer,
        outer_lr=cfg.outer_lr,
        hvp_subsample=cfg.hvp_subsample,
        update_config=UpdateConfig(strategy=strategy, inner=cfg.meta_mode,
                                   backend=backend),
        topology_config=TopologyConfig(graph=cfg.topology,
                                       schedule=schedule,
                                       link_failure_p=link_failure_p,
                                       seed=schedule_seed),
    )


@dataclasses.dataclass
class TrainBundle:
    cfg: ArchConfig
    K: int
    T: int
    tb: int
    step_fn: Callable             # (state, batch) -> (state, metrics)
    init_state: Callable          # (seed) -> TrainState on the device
    device: torch.device
    loss_fn: Callable = None      # (params, batch) -> scalar (one agent)
    mcfg: MetaConfig = None       # the assembled MetaConfig
    schedule: Any = None          # TopologySchedule (None when K == 1)
    outer_dtype: str = ""         # resolved params/grads storage dtype
    combine_dtype: str = ""       # resolved combine wire format
    combine_backend: str = ""     # resolved combine backend ('auto' applied)

    def make_eval_harness(self, inner_steps: int | None = None):
        """The in-training recurring-vs-unseen eval engine, bound to this
        bundle's model loss and inner learning rate."""
        from repro_torch.eval.harness import EvalHarness
        return EvalHarness(
            self.loss_fn, inner_lr=self.cfg.inner_lr,
            inner_steps=self.cfg.inner_steps if inner_steps is None
            else inner_steps)

    def eval_prepare(self):
        """``prepare`` hook for :meth:`EvalHarness.evaluate`: appends the
        per-task modality stubs (``modality_extras``) on the task-leading
        eval layout."""
        cfg, dt = self.cfg, DTYPES[self.cfg.dtype]

        def add(d):
            extras = modality_extras(cfg, tuple(d["tokens"].shape[:2]), dt,
                                     d["tokens"].device)
            return {**d, **extras} if extras else d

        return lambda sq: (add(sq[0]), add(sq[1]))

    def make_pipeline(self, source, *, depth: int = 2, start_step: int = 0,
                      stack: int | None = None):
        """A :class:`~repro_torch.data.pipeline.MetaBatchPipeline` over a
        task source bound to this bundle's (K, T, tb), yielding global
        batches ``{tokens, labels}`` (B, S) on the bundle's device, with
        the modality stubs (``modality_extras``) the model's loss expects,
        the layout ``step_fn`` folds back with :func:`split_meta_batch`.
        ``stack=C`` yields C consecutive meta-batches stacked on a leading
        dispatch axis (C, B, S) for :func:`make_superstep` (grouped, never
        reordered; C=1 keeps the (1, B, S) axis); ``stack=None`` the
        per-step (B, S) layout."""
        from repro_torch.data.pipeline import MetaBatchPipeline
        src_tb = getattr(source, "task_batch", self.tb)
        if (source.K, source.tasks_per_agent, src_tb) != (self.K, self.T,
                                                          self.tb):
            raise ValueError(
                f"source geometry (K={source.K}, T={source.tasks_per_agent}, "
                f"tb={src_tb}) does not match the bundle's (K={self.K}, "
                f"T={self.T}, tb={self.tb})")
        B = self.K * self.T * self.tb * 2
        lead = (B,) if stack is None else (stack, B)
        extras = modality_extras(self.cfg, lead, DTYPES[self.cfg.dtype],
                                 self.device)
        if stack is None:
            prepare = lambda ep: ep.as_flat_batch()
        else:
            if stack < 1:
                raise ValueError(f"stack must be >= 1, got {stack}")

            def prepare(eps):
                eps = eps if isinstance(eps, list) else [eps]
                flat = [ep.as_flat_batch() for ep in eps]
                return {k: np.stack([b[k] for b in flat]) for k in flat[0]}

        return MetaBatchPipeline(source, self.device, depth=depth,
                                 start_step=start_step, prepare=prepare,
                                 stack=1 if stack is None else stack,
                                 extras=extras)


def build_train(cfg: ArchConfig, shape_name: str | InputShape = "train_4k",
                K: int = 1, combine_override: str | None = None, *,
                strategy: str | None = None,
                schedule: str = "static",
                link_failure_p: float = 0.2,
                schedule_seed: int = 0, device=None) -> TrainBundle:
    """The Dif-MAML train step of ``cfg`` for K agents on one device (None:
    the CUDA card).  Params and grads are stored in ``cfg.outer_dtype`` (or
    ``cfg.dtype``), Adam moments in float32."""
    device = resolve_device(device)
    shape = resolve_input_shape(shape_name)
    if shape.kind not in ("train", "prefill"):
        raise ValueError(f"build_train needs a train shape, got "
                         f"{shape.kind!r}")
    outer_dtype = cfg.outer_dtype or cfg.dtype
    out_dt = DTYPES[outer_dtype]
    wire_dtype = diffusion.resolve_combine_dtype(outer_dtype,
                                                 cfg.combine_dtype or None)
    model = build_model(cfg)
    T, tb = batch_geometry(cfg, shape, K)
    mcfg = meta_config_for(cfg, K, T, strategy=strategy, schedule=schedule,
                           link_failure_p=link_failure_p,
                           schedule_seed=schedule_seed)
    if combine_override:
        # a bare 'none'/'centralized' override selects that *strategy*
        # unless one was requested explicitly
        uc = mcfg.update_config
        strat = (uc.strategy if strategy
                 else strategy_for_combine(combine_override,
                                           default=uc.strategy))
        mcfg = dataclasses.replace(mcfg, update_config=dataclasses.replace(
            uc, strategy=strat, backend=combine_override))
    backend = mcfg.update_config.backend
    if backend in _MESH_BACKENDS:
        raise ValueError(
            f"combine backend {backend!r} is not ported: it exchanges agent "
            f"shards over a device mesh, and the port runs on one card "
            f"(ROADMAP Queue 1, item 11); use dense, pallas, fused or auto")
    opt = get_optimizer(cfg.outer_optimizer, cfg.outer_lr)
    sched = schedule_for(mcfg) if K > 1 else None
    A = sched.stacked() if sched is not None else np.ones((1, 1))
    backend = diffusion.resolve_schedule_backend(backend, A)
    resolved = (diffusion.select_backend(A, device) if backend == "auto"
                else backend)
    strat_obj = update.get_strategy(
        mcfg.update_config.strategy if K > 1 else "none")
    combine_fn = None
    if backend == "fused":
        pass             # make_meta_step builds the fused outer from mcfg
    elif strat_obj.needs_combine_fn and K > 1:
        combine_fn = diffusion.make_combine(backend, A=A, device=device)
    else:
        resolved = "none"
    freeze_mask = None
    if cfg.inner_freeze:
        # ANIL-style: every leaf under a key path with the named component
        # (e.g. 'encoder') is frozen in the inner loop; the outer step
        # still trains it
        freeze_mask = {k: cfg.inner_freeze in k.split("/")
                       for k in model.specs()}
    step = make_meta_step(model.loss_fn, mcfg, optimizer=opt, A=A,
                          combine_fn=combine_fn, device=device,
                          freeze_mask=freeze_mask)

    def train_step(state: TrainState, batch: dict):
        support, query = split_meta_batch(cfg, batch, K, T, tb)
        return step(state, support, query)

    def init_state_fn(seed: int = 0, draw: bool = True) -> TrainState:
        """K launch models, consecutive draws of one generator seeded with
        ``seed``, in the outer dtype; float32 moments.  ``draw=False``
        leaves the params uninitialized: the state of a run that restores
        a checkpoint into it."""
        gen = torch.Generator().manual_seed(seed)

        def init_fn(g, device):
            if draw:
                return model.init(g, out_dt, device=device)
            return {k: torch.empty(s.shape, dtype=out_dt, device=device)
                    for k, s in model.specs().items()}

        return init_state(gen, init_fn, mcfg, optimizer=opt, device=device)

    return TrainBundle(cfg, K, T, tb, train_step, init_state_fn, device,
                       loss_fn=model.loss_fn, mcfg=mcfg, schedule=sched,
                       outer_dtype=outer_dtype, combine_dtype=wire_dtype,
                       combine_backend=resolved)


# ---------------------------------------------------------------------------
# Superstep: C meta-steps per dispatch
# ---------------------------------------------------------------------------

# Scalar step metrics carried out of a superstep: one (C,) tensor per key,
# left on the device, so a C-step dispatch costs one host fetch.
SUPERSTEP_METRICS = ("loss", "disagreement")


def make_superstep(step_fn):
    """Fold ``step_fn`` into ``superstep(state, batches) -> (state,
    metrics)``.  ``batches``: one meta-batch with a leading dispatch axis of
    size C (``TrainBundle.make_pipeline(stack=C)``'s layout).  The C
    meta-steps run eagerly one after another with no host sync between
    them (the step counter is a host int); ``metrics`` maps each
    :data:`SUPERSTEP_METRICS` key to a ``(C,)`` tensor on the device.  Step
    for step what C calls of ``step_fn`` give.  (The reference scans the C
    steps inside one compiled call; a CUDA-graph capture of this loop waits
    for the device-side combine gate, ROADMAP Queue 3, item 2.)"""

    def superstep(state, batches):
        C = next(iter(batches.values())).shape[0]
        out = {k: [] for k in SUPERSTEP_METRICS}
        for c in range(C):
            state, metrics = step_fn(state, {k: v[c]
                                             for k, v in batches.items()})
            for k in SUPERSTEP_METRICS:
                out[k].append(metrics[k])
        return state, {k: torch.stack(v) for k, v in out.items()}

    return superstep


# ---------------------------------------------------------------------------
# Serve step (single-token decode against a KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeBundle:
    cfg: ArchConfig
    step_fn: Callable          # (params, cache, token, pos) -> (logits, cache)
    params_specs: Any          # flat dict of meta tensors (shape, dtype)


def build_serve(cfg: ArchConfig, shape: InputShape) -> ServeBundle:
    """The decode step of ``cfg`` and the shapes and dtypes of its params
    (meta tensors: no memory), for an engine serving ``shape``."""
    if shape.kind != "decode":
        raise ValueError(f"build_serve needs a decode shape, got "
                         f"{shape.kind!r}")
    dt = DTYPES[cfg.dtype]
    model = build_model(cfg)
    specs = {k: torch.empty(s.shape, dtype=dt, device="meta")
             for k, s in model.specs().items()}
    return ServeBundle(cfg, model.decode_step, specs)
