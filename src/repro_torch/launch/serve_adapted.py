"""Adapt-then-serve, end to end — the port's counterpart of
``examples/serve_adapted.py``.

The product of Dif-MAML is a launch model that specializes fast.  This
chains the port's entry points with the reference example's reduced
arguments:

  1. meta-train a reduced config for a few steps, checkpointing the
     K-agent ``TrainState`` (``launch/train.py``);
  2. restore the checkpoint's **centroid** launch model
     (``checkpoint.restore_centroid`` — mean over the agent axis);
  3. adapt it to an unseen-domain ``eval_sample`` episode through the
     shared engine (``launch/serve.py``);
  4. serve batched decode requests from the adapted weights.

Arguments this script does not know (``--run-log``, ``--users``, ...) go to
the serve step.  ``--device`` (default: the CUDA card; ``cpu`` runs the
kernels' plain versions) goes to both steps; ``--ckpt-root`` (default: a
new temporary directory) holds the checkpoint and the training log.

  PYTHONPATH=src python -m repro_torch.launch.serve_adapted \\
      [--arch qwen2-1.5b] [--device cpu] [--run-log serve.jsonl]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main

__all__ = ["main"]


def main(argv=None) -> dict:
    """Train, then serve; returns ``{"train", "serve", "ckpt_root"}`` (the
    two entry points' results and the checkpoint directory)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--train-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-root", default=None,
                    help="checkpoint and training-log directory (default: "
                         "a new temporary directory)")
    args, rest = ap.parse_known_args(argv)
    device = str(resolve_device(args.device))

    ckpt_root = args.ckpt_root or tempfile.mkdtemp(prefix="serve_adapted_")
    print(f"== meta-train {args.train_steps} steps -> checkpoint "
          f"({ckpt_root}) ==")
    trained = train_main([
        "--arch", args.arch, "--reduced", "--steps", str(args.train_steps),
        "--seq", "16", "--global-batch", "16", "--agents", "4",
        "--seed", str(args.seed), "--ckpt-dir", ckpt_root,
        "--run-log", os.path.join(ckpt_root, "run.jsonl"),
        "--device", device])

    print("== adapt the checkpoint centroid to an unseen domain, "
          "then serve ==")
    served = serve_main([
        "--arch", args.arch, "--reduced", "--seed", str(args.seed),
        "--ckpt-dir", os.path.join(ckpt_root, f"seed{args.seed}"),
        "--batch", "4", "--prompt-len", "8", "--gen", "16",
        "--adapt-steps", "2", "--device", device] + rest)
    return {"train": trained, "serve": served, "ckpt_root": ckpt_root}


if __name__ == "__main__":
    main()
