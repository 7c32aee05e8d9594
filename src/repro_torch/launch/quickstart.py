"""Quickstart: Dif-MAML on the paper's sine-regression benchmark (§4.1) —
the port's counterpart of ``examples/quickstart.py``.

Six agents, each seeing a different amplitude band of the task universe,
cooperate over the paper's Fig. 2a graph and jointly meta-learn a launch
model that adapts to *any* sinusoid in one gradient step.  Episodes stream
through the ``MetaBatchPipeline`` prefetcher (pinned host memory, copied on
the training stream).

The flags are the reference example's, plus ``--backend`` (``dense``: the
plain einsum combine; ``pallas``: the ``dif_combine`` CUDA kernel;
``fused``: the ``fused_combine_update`` CUDA kernel) and ``--device``
(default: the CUDA card; ``cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 400] \\
      [--backend fused] [--strategy cta] [--schedule link_failure]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (MetaConfig, TopologyConfig, UpdateConfig,
                              diffusion, init_state, make_eval_fn,
                              make_meta_step, topology, update)
from repro_torch.core.meta_trainer import schedule_for
from repro_torch.data import MetaBatchPipeline, SineTaskSource
from repro_torch.data.episodes import to_device, host_tensors
from repro_torch.device import resolve_device
from repro_torch.models import SineMLP

BACKENDS = ("dense", "pallas", "fused")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--topology", default="paper")
    ap.add_argument("--strategy", default="atc",
                    choices=sorted(update.update_strategies()))
    ap.add_argument("--schedule", default="static",
                    choices=sorted(topology.SCHEDULES))
    ap.add_argument("--link-failure-p", type=float, default=0.2)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--backend", default="dense", choices=BACKENDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train and return ``{"loss", "disagreement"}`` per step (numpy),
    ``ms_per_step`` (steps after the first, evaluation excluded), the
    last eval ``curve`` and the final ``state``."""
    device = resolve_device(args.device)
    cfg = get_config("sine_mlp")
    model = SineMLP(cfg)
    K = args.agents
    mcfg = MetaConfig(
        num_agents=K, tasks_per_agent=5, inner_lr=cfg.inner_lr,
        outer_optimizer="adam", outer_lr=1e-3,
        update_config=UpdateConfig(strategy=args.strategy, inner="maml",
                                   backend=args.backend),
        topology_config=TopologyConfig(
            graph=args.topology if K == 6 else "ring",
            schedule=args.schedule, link_failure_p=args.link_failure_p))
    sched = schedule_for(mcfg)
    source = SineTaskSource(K=K, tasks_per_agent=5, shots=10, seed=0)
    print(f"K={K} agents, strategy={args.strategy} on "
          f"'{sched.topology.name}' graph ({sched.kind} schedule, period "
          f"{sched.period}), mean λ₂={sched.mean_mixing_rate:.3f} "
          f"(mixing rate, Thm 1); {source.heterogeneity}: "
          f"{source.n_domains} amplitude bands sharded across agents; "
          f"backend={args.backend} on {device}")

    state = init_state(torch.Generator().manual_seed(0), model.init, mcfg,
                       identical_init=True, device=device)
    step = make_meta_step(model.loss_fn, mcfg, device=device)
    evaln = make_eval_fn(model.loss_fn, inner_lr=cfg.inner_lr, inner_steps=5)
    ev = source.eval_sample(200, seed=999)      # full amplitude range
    esup, eqry = to_device(host_tensors((ev.support, ev.query)), device)

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    losses, dis = [], []
    train_s, curve = 0.0, None
    with MetaBatchPipeline(source, device, depth=args.prefetch) as pipe:
        for i in range(args.steps):
            t0 = time.perf_counter()
            support, query = next(pipe)
            state, metrics = step(state, support, query)
            losses.append(metrics["loss"])
            dis.append(metrics["disagreement"])
            if i > 0:
                sync()
                train_s += time.perf_counter() - t0
            if i % 50 == 0 or i == args.steps - 1:
                c = diffusion.centroid(state.params)
                curve = evaln(c, esup, eqry).mean(0).cpu().numpy()
                print(f"step {i:4d}  train-loss {float(metrics['loss']):.4f}"
                      f"  disagreement "
                      f"{float(metrics['disagreement']):.2e}  eval 0-shot "
                      f"{curve[0]:.3f} → 1-step {curve[1]:.3f} → 5-step "
                      f"{curve[5]:.3f}")
    return {
        "loss": torch.stack(losses).cpu().numpy(),
        "disagreement": torch.stack(dis).cpu().numpy(),
        "ms_per_step": 1e3 * train_s / max(1, args.steps - 1),
        "curve": np.asarray(curve),
        "state": state,
    }


def main(argv=None) -> dict:
    out = run(parse_args(argv))
    print(f"done: {out['ms_per_step']:.3f} ms/step; the launch model adapts "
          f"to unseen amplitudes in one step.")
    return out


if __name__ == "__main__":
    main()
