"""End to end: decentralized meta-training of a ~100M-parameter LM —
the port's counterpart of ``examples/decentralized_lm.py``.

Each agent holds a disjoint shard of synthetic text *domains*
(``LMTaskSource`` — heterogeneous π_k, with one domain held out for the
unseen-task eval); one Dif-MAML iteration adapts to sampled domains (inner
step), takes the exact second-order meta-gradient on held-out batches
(outer), and diffuses launch models over a ring.  Episodes are generated on
a background thread (``bundle.make_pipeline``) while the card runs the
step.  The run ends with the recurring-vs-unseen eval report.

The reference takes K from its host mesh (4 devices); the port runs on one
card with no mesh, so K is ``--agents`` (default 4).  On the card, the
model's attention runs the float32 flash-attention kernels, and exact MAML
their forward-mode tangent kernels.  The flags are the reference example's,
plus ``--agents``, ``--combine`` / ``--fused-outer`` (the outer-update
backend, as in ``launch/train.py``) and ``--device`` (default: the CUDA
card; ``cpu`` runs the kernels' plain versions).

Default geometry (80.8M params: 12L × d512 × ffn2048 × 32k vocab):
  PYTHONPATH=src python -m repro_torch.launch.decentralized_lm --steps 300
CPU smoke (seconds):
  PYTHONPATH=src python -m repro_torch.launch.decentralized_lm --tiny \\
      --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ArchConfig, InputShape
from repro_torch.core import topology, update
from repro_torch.data import LMTaskSource
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import build_model, count_params

__all__ = ["lm_100m", "make_source", "parse_args", "run", "main"]


def lm_100m(tiny: bool) -> ArchConfig:
    """The example's config: lm-100m (12 layers, d_model 512, 8 query and
    4 KV heads of 64, d_ff 2048, vocab 32768, float32, exact MAML on a
    ring), or its 2-layer, d_model 64 ``tiny`` cut."""
    if tiny:
        return ArchConfig(
            name="lm-tiny", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512, meta_mode="maml", topology="ring",
            outer_optimizer="adam", dtype="float32", remat=False,
            attn_q_chunk=None)
    return ArchConfig(
        name="lm-100m", arch_type="dense", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, meta_mode="maml", topology="ring",
        outer_optimizer="adam", dtype="float32", remat=False,
        attn_q_chunk=256)


def make_source(cfg: ArchConfig, seq: int, bundle) -> LMTaskSource:
    """The example's task stream: 8 domains an agent, one held out."""
    return LMTaskSource(
        vocab_size=cfg.padded_vocab, seq_len=seq, K=bundle.K,
        tasks_per_agent=bundle.T, task_batch=bundle.tb,
        n_domains=8 * max(1, bundle.K), holdout_domains=1, seed=0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--strategy", default=None,
                    choices=sorted(update.update_strategies()),
                    help="outer-update strategy (default atc)")
    ap.add_argument("--schedule", default="static",
                    choices=sorted(topology.SCHEDULES),
                    help="per-step topology schedule")
    ap.add_argument("--link-failure-p", type=float, default=0.2,
                    help="per-edge drop probability for --schedule "
                         "link_failure")
    ap.add_argument("--agents", type=int, default=4,
                    help="K, the number of agents (one card, no mesh)")
    ap.add_argument("--combine", default=None,
                    help="combine backend override: 'auto' or any "
                         "diffusion.combine_backends() name")
    ap.add_argument("--fused-outer", action="store_true",
                    help="the one-pass combine-then-update outer step "
                         "(shorthand for --combine fused)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fused_outer:
        if args.combine not in (None, "fused"):
            ap.error(f"--fused-outer conflicts with --combine "
                     f"{args.combine}")
        args.combine = "fused"
    return args


def run(args: argparse.Namespace, state=None) -> dict:
    """Meta-train ``args.steps`` steps from ``state`` (default: the
    bundle's init from seed 0), then evaluate.  Returns ``loss`` and
    ``disagreement`` per step (host tensors), ``s_per_step`` (steps after
    the first, host clock to a synchronized card), the final ``state``, the
    eval ``report``, ``n_params`` and the ``bundle``."""
    device = resolve_device(args.device)
    cfg = lm_100m(args.tiny)
    seq = args.seq or (32 if args.tiny else 256)
    gb = args.global_batch or (8 if args.tiny else 32)
    shape = InputShape("lm_example", seq, gb, "train")
    bundle = S.build_train(cfg, shape, args.agents,
                           combine_override=args.combine,
                           strategy=args.strategy, schedule=args.schedule,
                           link_failure_p=args.link_failure_p,
                           device=device)
    n = count_params(build_model(cfg).specs())
    print(f"[lm] {cfg.name}: {n/1e6:.1f}M params, K={bundle.K} agents, "
          f"T={bundle.T}×{bundle.tb} tasks, seq={seq}, batch={gb}, "
          f"strategy={bundle.mcfg.update_config.strategy}, "
          f"backend={bundle.combine_backend}, device={device}"
          + (f" ({args.schedule} schedule)"
             if args.schedule != "static" else ""))
    if state is None:
        state = bundle.init_state(seed=0)
    source = make_source(cfg, seq, bundle)
    print(f"[lm] {source.heterogeneity}: {source.n_train_domains} train "
          f"domains sharded across agents, {source.holdout_domains} "
          f"held out for eval, prefetch depth {args.prefetch}")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    losses, dis = [], []
    t0, train_s = time.time(), 0.0
    with bundle.make_pipeline(source, depth=args.prefetch) as pipe:
        for i in range(args.steps):
            ts = time.perf_counter()
            state, m = bundle.step_fn(state, next(pipe))
            losses.append(m["loss"])
            dis.append(m["disagreement"])
            if i > 0:
                sync()
                train_s += time.perf_counter() - ts
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"step {int(state.step):4d} meta-loss "
                      f"{float(m['loss']):.4f} disagreement "
                      f"{float(m['disagreement']):.2e} "
                      f"({time.time() - t0:.1f}s)")
    dt = time.time() - t0
    print(f"[lm] {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} episodes/s end-to-end)")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, int(state.step), state)
        print(f"[lm] checkpoint saved to {args.ckpt_dir}")

    # post-training: the recurring-vs-unseen protocol through the same
    # EvalHarness the trainer hook and the serve path use
    harness = bundle.make_eval_harness(inner_steps=1)
    report = harness.evaluate(state, source, n_tasks=1, seed=10_001)
    for split, rep in report.splits.items():
        c = rep.centroid_curve
        print(f"[lm] {split} loss: zero-shot {c[0]:.4f} "
              f"→ one adaptation step {c[-1]:.4f}")
    print(f"[lm] generalization gap (unseen − recurring, adapted): "
          f"{report.generalization_gap:.4f}")
    return {"loss": torch.stack(losses).cpu(),
            "disagreement": torch.stack(dis).cpu(),
            "s_per_step": train_s / max(1, args.steps - 1),
            "state": state, "report": report, "n_params": n,
            "bundle": bundle}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
