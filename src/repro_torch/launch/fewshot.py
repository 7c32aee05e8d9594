"""Few-shot classification with Dif-MAML (paper §4.2, Fig. 3) — the port's
counterpart of ``examples/fewshot_classification.py``.

Synthetic Omniglot-surrogate episodes (:mod:`repro_torch.data.fewshot`)
through ``FewShotTaskSource``: each of K=6 agents owns a disjoint shard of
the meta-train classes (heterogeneous π_k), and evaluation episodes come
from the meta-test classes nobody trained on.  Compares the paper's three
strategies — centralized, Dif-MAML (ATC) and non-cooperative — on
``omniglot_cnn`` (2 conv blocks of 32 channels, 5-way 1-shot, α=0.4, exact
MAML, Adam 1e-3, the Fig. 2a graph).

The flags are the reference example's, plus ``--backend`` (``dense``: the
plain einsum combine; ``pallas``: the ``dif_combine`` CUDA kernel;
``fused``: the ``fused_combine_update`` CUDA kernel), ``--strategies`` (a
subset of the three runs) and ``--device`` (default: the CUDA card;
``cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.fewshot [--steps 150] \\
      [--backend fused] [--strategies dif-maml] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import (MetaConfig, TopologyConfig, UpdateConfig,
                              diffusion, init_state, make_meta_step)
from repro_torch.data import FewShotTaskSource, MetaBatchPipeline
from repro_torch.data.episodes import host_tensors, to_device
from repro_torch.device import resolve_device
from repro_torch.models import FewShotCNN

__all__ = ["BACKENDS", "STRATEGIES", "make_source", "meta_config",
           "test_accuracy", "parse_args", "run", "main"]

BACKENDS = ("dense", "pallas", "fused")
# The reference example's runs: label -> DiffusionStrategy.
STRATEGIES = {"centralized": "centralized", "dif-maml": "atc",
              "non-coop": "none"}
K, TASKS = 6, 2


def make_source() -> FewShotTaskSource:
    """The example's episodes: K=6 agents × 2 tasks, 80 classes (64
    meta-train, sharded; 16 meta-test), 5-way 1-shot with 5 queries."""
    cfg = get_config("omniglot_cnn")
    return FewShotTaskSource(K=K, tasks_per_agent=TASKS, n_classes=80,
                             n_way=cfg.vocab_size, k_shot=1, n_query=5,
                             seed=0)


def meta_config(strategy: str, backend: str = "dense") -> MetaConfig:
    """The example's MetaConfig for one DiffusionStrategy name."""
    cfg = get_config("omniglot_cnn")
    return MetaConfig(num_agents=K, tasks_per_agent=TASKS,
                      inner_lr=cfg.inner_lr,
                      update_config=UpdateConfig(strategy=strategy,
                                                 inner="maml",
                                                 backend=backend),
                      topology_config=TopologyConfig(graph="paper"),
                      outer_optimizer="adam", outer_lr=1e-3)


def test_accuracy(model: FewShotCNN, params, source: FewShotTaskSource,
                  inner_lr: float, n_tasks: int = 50) -> float:
    """Mean query accuracy after one adaptation step on each of
    ``n_tasks`` meta-test episodes (eval seed 777), from ``params`` (one
    model, on the device the accuracy is measured on)."""
    device = next(iter(params.values())).device
    ep = source.eval_sample(n_tasks, seed=777)      # meta-test classes
    (sx, sy), (qx, qy) = to_device(host_tensors((ep.support, ep.query)),
                                   device)

    def adapted_acc(sx_, sy_, qx_, qy_):
        g = torch.func.grad(model.loss_fn)(params, (sx_, sy_))
        pa = {k: p - inner_lr * g[k] for k, p in params.items()}
        return model.accuracy(pa, (qx_, qy_))

    return float(torch.func.vmap(adapted_acc)(sx, sy, qx, qy).mean())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--backend", default="dense", choices=BACKENDS)
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=list(STRATEGIES),
                    help="which of the example's runs (default: all three)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train each requested strategy from one init and one episode stream.
    Returns, per label, ``loss`` and ``disagreement`` per step (tensors on
    the host), the final ``accuracy`` of the centroid, ``ms_per_step``
    (steps after the first, the accuracy excluded) and the final
    ``state``."""
    device = resolve_device(args.device)
    cfg = get_config("omniglot_cnn")
    source = make_source()
    model = FewShotCNN(cfg, image_hw=source.image_hw)
    print(f"{source.heterogeneity}: {source.n_domains} meta-train classes "
          f"sharded across K={source.K} agents, eval on "
          f"{source.n_test_domains} meta-test classes; "
          f"backend={args.backend} on {device}")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    out = {}
    for label in args.strategies:
        mcfg = meta_config(STRATEGIES[label], args.backend)
        state = init_state(torch.Generator().manual_seed(0), model.init,
                           mcfg, identical_init=True, device=device)
        step = make_meta_step(model.loss_fn, mcfg, device=device)
        losses, dis, train_s = [], [], 0.0
        with MetaBatchPipeline(source, device, depth=args.prefetch) as pipe:
            for i in range(args.steps):
                t0 = time.perf_counter()
                support, query = next(pipe)
                state, m = step(state, support, query)
                losses.append(m["loss"])
                dis.append(m["disagreement"])
                if i > 0:
                    sync()
                    train_s += time.perf_counter() - t0
        centroid = diffusion.centroid(state.params)
        acc = test_accuracy(model, centroid, source, cfg.inner_lr)
        loss = torch.stack(losses).cpu()
        print(f"{label:12s} meta-train loss {float(loss[-1]):.3f}   "
              f"5-way 1-shot test acc {acc:.3f}")
        out[label] = {"loss": loss, "disagreement": torch.stack(dis).cpu(),
                      "accuracy": acc,
                      "ms_per_step": 1e3 * train_s / max(1, args.steps - 1),
                      "state": state}
    return out


def main(argv=None) -> dict:
    out = run(parse_args(argv))
    print("ms/step: " + ", ".join(f"{label} {r['ms_per_step']:.3f}"
                                  for label, r in out.items()))
    return out


if __name__ == "__main__":
    main()
