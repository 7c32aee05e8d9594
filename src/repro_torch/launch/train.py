"""Dif-MAML training driver (port of ``repro/launch/train.py``).

Runs the decentralized meta-training loop for the LM families on one card
(``--device cpu`` runs it on the CPU): K agents (``--agents``) on the
arch's topology, the config's ``meta_mode`` (exact MAML through the
kernels and their forward-mode tangent kernels for qwen2, mamba2 and
whisper, ``fomaml`` for the MoE configs, the vision model and jamba's
hybrid), the outer
update by the chosen combine backend (``--fused-outer``: one kernel launch
a step).  whisper's batches carry zero frames and the vision model's zero
patches (the reference's stubs); a config's ``inner_freeze`` freezes that
subtree in the inner loop.

Every run writes a JSONL run log (``--run-log``, default
``results/train_<arch>_seed<seed>.jsonl``): a ``{"kind": "config", ...}``
record, one ``{"kind": "train", ...}`` record per logged step, and — with
``--eval-every`` — one ``{"kind": "eval", ...}`` record per
:class:`~repro_torch.eval.EvalHarness` pass (recurring-vs-unseen curves,
generalization gap, disagreement at eval), with the reference's fields, so
``scripts/check_run_log.py`` reads it unchanged.  A run resumed from
``--ckpt-dir`` appends to its log.

The loop is a superstep driver: ``--steps-per-dispatch C`` runs C
meta-steps a dispatch (:func:`repro_torch.launch.steps.make_superstep`)
with the pipeline stacking C meta-batches an item and the metrics kept on
the card — one host fetch per C steps.  Log, eval and checkpoint cadences
align to dispatch boundaries; C=1 is the per-step loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --reduced --device cpu --steps 4 --seq 64 --global-batch 16 \\
      --agents 4 --eval-every 2 --eval-tasks 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import (INPUT_SHAPES, InputShape, get_config,
                                 register_input_shape)
from repro_torch.core import diffusion, topology, update
from repro_torch.data.lm_tasks import LMTaskSource
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S

__all__ = ["RunLog", "main", "make_train_source"]

# Flags of the reference that need a device mesh (ROADMAP Queue 1, item 11).
_MESH_FLAGS = ("--multi-pod", "--mesh-agents")


def make_train_source(cfg, shape, K: int, T: int, tb: int, seed: int = 0,
                      holdout_domains: int | None = None) -> LMTaskSource:
    """The trainer's task stream: per-agent heterogeneous LM domain shards
    (the paper's π_k), plus ``holdout_domains`` extra domains (default
    ``max(2, K // 2)``) held out of every shard — the unseen split the
    in-training EvalHarness measures against."""
    n_train = max(8, 4 * K)
    holdout = max(2, K // 2) if holdout_domains is None else holdout_domains
    return LMTaskSource(
        vocab_size=cfg.padded_vocab, seq_len=shape.seq_len,
        K=K, tasks_per_agent=T, task_batch=tb,
        n_domains=n_train + holdout, holdout_domains=holdout, seed=seed)


class RunLog:
    """JSONL writer, one flushed record per line.  ``resume=True`` appends
    (a checkpoint-resumed run continues its log); otherwise the file
    restarts with the run."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a" if resume else "w")

    def write(self, **record) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="run seed: launch-model init, the task source, and "
                         "checkpoint naming (ckpt-dir/seed<N>/)")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (CPU)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers, widths kept "
                         "(a depth cut, for a model whose full depth does "
                         "not fit one card; an encoder-decoder cuts "
                         "encoder and decoder each to N, a vision model "
                         "takes a multiple of its cross_attn_every, a "
                         "hybrid one of its attn_every)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--agents", type=int, default=4,
                    help="K, the number of agents (one card, no mesh)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="save every n steps and at the end; 0 saves no "
                         "checkpoint (a run that only resumes from "
                         "--ckpt-dir)")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the recurring-vs-unseen EvalHarness every n "
                         "steps (0 = off); results go to the run log")
    ap.add_argument("--eval-tasks", type=int, default=8,
                    help="eval tasks drawn per split per harness pass")
    ap.add_argument("--eval-inner-steps", type=int, default=3,
                    help="adaptation steps measured by the eval harness")
    ap.add_argument("--run-log", default=None,
                    help="JSONL run log path (default results/"
                         "train_<arch>_seed<seed>.jsonl)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported (needs a device mesh)")
    ap.add_argument("--mesh-agents", type=int, default=None,
                    help="not ported (needs a device mesh)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="meta-batch pipeline depth (0 = sample "
                         "synchronously on the step loop)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="meta-steps per dispatch: one host metric fetch "
                         "per C steps; log/eval/ckpt cadences align to "
                         "dispatch boundaries")
    ap.add_argument("--combine", default=None,
                    help="combine backend override: 'auto' or any "
                         "diffusion.combine_backends() name")
    ap.add_argument("--strategy", default=None,
                    choices=sorted(update.update_strategies()),
                    help="outer-update composition (default atc)")
    ap.add_argument("--topology-schedule", default="static",
                    choices=sorted(topology.SCHEDULES),
                    help="per-step communication-graph schedule")
    ap.add_argument("--link-failure-p", type=float, default=0.2,
                    help="i.i.d. per-edge drop probability for "
                         "--topology-schedule link_failure")
    ap.add_argument("--fused-outer", action="store_true",
                    help="the one-pass combine-then-update outer step "
                         "(shorthand for --combine fused)")
    ap.add_argument("--outer-dtype", default=None, choices=sorted(S.DTYPES),
                    help="params/grads storage dtype of the outer loop "
                         "(Adam moments stay fp32); defaults to the arch's "
                         "dtype")
    ap.add_argument("--combine-dtype", default=None,
                    choices=sorted(diffusion.WIRE_DTYPES),
                    help="combine wire format (recorded; the port's "
                         "backends run on one card)")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the CUDA card; 'cpu' "
                         "to run on the CPU)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the trainer; returns ``{"state", "log_path", "losses"}`` (the
    final TrainState, the run log's path and the logged losses by step)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.multi_pod or args.mesh_agents:
        ap.error(f"{' and '.join(_MESH_FLAGS)} are not ported: the port "
                 f"runs on one card with no device mesh (ROADMAP Queue 1, "
                 f"item 11); give K with --agents")
    if args.fused_outer:
        if args.combine not in (None, "fused"):
            ap.error(f"--fused-outer conflicts with --combine "
                     f"{args.combine}: the fused outer step IS the combine "
                     f"backend")
        args.combine = "fused"
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.outer_dtype or args.combine_dtype:
        cfg = dataclasses.replace(
            cfg, outer_dtype=args.outer_dtype or cfg.outer_dtype,
            combine_dtype=args.combine_dtype or cfg.combine_dtype)
    if args.layers:
        cfg = S.cut_depth(cfg, args.layers)
    if args.reduced:
        cfg = cfg.reduced()
        shape = InputShape("custom", args.seq, args.global_batch, "train")
        # registered (not assigned) so an in-process rerun with another
        # geometry replaces the entry loudly
        register_input_shape(shape, override=True)
        shape_name = shape.name
    else:
        shape_name = args.shape
        shape = INPUT_SHAPES[shape_name]

    ckpt_dir = (os.path.join(args.ckpt_dir, f"seed{args.seed}")
                if args.ckpt_dir else None)
    resuming = ckpt_dir is not None and latest_step(ckpt_dir) is not None
    log_path = args.run_log or os.path.join(
        "results", f"train_{cfg.name}_seed{args.seed}.jsonl")
    run_log = RunLog(log_path, resume=resuming)

    bundle = S.build_train(cfg, shape_name, args.agents,
                           combine_override=args.combine,
                           strategy=args.strategy,
                           schedule=args.topology_schedule,
                           link_failure_p=args.link_failure_p,
                           schedule_seed=args.seed, device=device)
    ucfg = bundle.mcfg.update_config
    sched = bundle.schedule
    print(f"[train] {cfg.name}: K={bundle.K} agents, "
          f"T={bundle.T} tasks × {bundle.tb} examples, "
          f"mode={ucfg.inner}, seed={args.seed}, device={device}")
    if sched is not None:
        print(f"[train] outer update: strategy={ucfg.strategy} over "
              f"'{sched.topology.name}' ({sched.kind} schedule, "
              f"period {sched.period}, "
              f"mean λ₂={sched.mean_mixing_rate:.3f}), "
              f"combine_every={ucfg.combine_every}, "
              f"backend={bundle.combine_backend}")
    # a resumed run's state is the checkpoint's: nothing to draw
    state = bundle.init_state(seed=args.seed, draw=not resuming)
    if resuming:
        state = restore_checkpoint(ckpt_dir, state)
        print(f"[train] restored step {int(state.step)}")
    C = max(1, args.steps_per_dispatch)
    superstep_fn = S.make_superstep(bundle.step_fn)
    source = make_train_source(cfg, shape, bundle.K, bundle.T, bundle.tb,
                               seed=args.seed)
    print(f"[train] task source: {source.n_train_domains} domains "
          f"(+{source.holdout_domains} held out), "
          f"{source.heterogeneity} over K={bundle.K} agents, "
          f"prefetch depth {args.prefetch}")
    harness = prepare = None
    if args.eval_every:
        harness = bundle.make_eval_harness(args.eval_inner_steps)
        prepare = bundle.eval_prepare()
        print(f"[train] eval hook: recurring-vs-unseen, "
              f"{args.eval_tasks} tasks × {args.eval_inner_steps} "
              f"adaptation steps every {args.eval_every} steps "
              f"-> {log_path}")
    run_log.write(kind="config", arch=cfg.name, seed=args.seed,
                  mesh_axes={}, device=str(device),
                  num_layers=cfg.num_layers,
                  encoder_layers=cfg.encoder_layers,
                  K=bundle.K, T=bundle.T, tb=bundle.tb,
                  mode=ucfg.inner, strategy=ucfg.strategy,
                  combine_backend=ucfg.backend,
                  fused_outer=ucfg.backend == "fused",
                  outer_dtype=bundle.outer_dtype,
                  combine_dtype=bundle.combine_dtype,
                  topology_schedule=args.topology_schedule,
                  link_failure_p=(args.link_failure_p
                                  if args.topology_schedule
                                  == "link_failure" else None),
                  steps=args.steps, steps_per_dispatch=C,
                  n_domains=source.n_domains,
                  holdout_domains=source.holdout_domains)
    t0 = time.time()
    train_wall = 0.0       # train compute only: excludes eval/ckpt/log
    done = 0
    losses = {}
    save, saved = bool(ckpt_dir and args.ckpt_every), None
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    with bundle.make_pipeline(source, depth=args.prefetch,
                              start_step=int(state.step), stack=C) as pipe:
        while done < args.steps:
            n = min(C, args.steps - done)
            batch = next(pipe)
            if n < C:      # the final partial dispatch
                batch = {k: v[:n] for k, v in batch.items()}
            td = time.perf_counter()
            state, metrics = superstep_fn(state, batch)
            # ONE host fetch a dispatch: the (n,) metric rows together
            m = torch.stack([metrics[k].float() for k in
                             S.SUPERSTEP_METRICS]).cpu()
            sync()
            dispatch_s = time.perf_counter() - td
            train_wall += dispatch_s
            base, done = done, done + n
            last_step = int(state.step)
            for j in range(n):
                if (base + j) % args.log_every == 0:
                    step_no = last_step - n + j + 1
                    loss, dis = float(m[0, j]), float(m[1, j])
                    losses[step_no] = loss
                    print(f"step {step_no:5d} "
                          f"loss {loss:.4f} "
                          f"disagreement {dis:.3e} "
                          f"({time.time() - t0:.1f}s)")
                    run_log.write(kind="train", step=step_no,
                                  loss=loss, disagreement=dis,
                                  time_s=round(time.time() - t0, 3),
                                  step_time_s=round(dispatch_s / n, 6),
                                  train_time_s=round(train_wall, 3))
            if harness is not None and (
                    base // args.eval_every < done // args.eval_every
                    or done >= args.steps):
                report = harness.evaluate(state, source, args.eval_tasks,
                                          prepare=prepare)
                rec = report.to_record()
                run_log.write(kind="eval", **rec)
                rc = rec["splits"]["recurring"]["centroid_curve"]
                uc = rec["splits"]["unseen"]["centroid_curve"]
                print(f"[eval] step {int(state.step)} "
                      f"recurring {rc[0]:.3f}->{rc[-1]:.3f} "
                      f"unseen {uc[0]:.3f}->{uc[-1]:.3f} "
                      f"gap {rec['generalization_gap']:.4f}")
            if save and (base // args.ckpt_every
                         < done // args.ckpt_every):
                save_checkpoint(ckpt_dir, int(state.step), state)
                saved = int(state.step)
    # the end of the run, unless its last dispatch just saved this step
    if save and saved != int(state.step):
        save_checkpoint(ckpt_dir, int(state.step), state)
    run_log.close()
    print(f"[train] done (run log: {log_path})")
    return {"state": state, "log_path": log_path, "losses": losses}


if __name__ == "__main__":
    main()
