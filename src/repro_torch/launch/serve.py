"""Serving CLI: adaptation-as-a-service over a launch model (port of
``repro/launch/serve.py``, same flags).

Restore the checkpoint centroid (``--ckpt-dir``, a checkpoint the JAX
trainer wrote) or a fresh init, adapt ``--users`` concurrent requests for
``--rounds`` rounds (round 2+ re-draws the same tasks: the recurring-user
cache path), decode from the first adapted model, and optionally write the
engine's ``kind=serve`` record to a JSONL run log that
``scripts/check_run_log.py --serve`` accepts.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 128 --gen 128 --adapt-steps 2 --users 4 \\
      --rounds 2 --seed 0 [--reduced] [--device cpu] [--run-log serve.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --prompt-len 512 --gen 512

``--arch`` is any LM config of the reference (``configs.list_archs()``)
or qwen2-7b-swa.  ``--device`` defaults to the CUDA card (and raises
without one).  A non-reduced config runs in its own dtype (bfloat16 for
every LM config), a reduced one in float32, as the reference picks.  whisper's
requests carry zero frames and the vision model's zero patches (the
reference's stubs, ``steps.modality_extras``).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import restore_centroid
from repro_torch.configs import get_config
from repro_torch.data.lm_tasks import LMTaskSource
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.serve import ServeEngine


class RunLog:
    """JSONL writer, one flushed record per line (the reference trainer's
    ``RunLog``)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")

    def write(self, **record) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def make_support_source(cfg, seq_len: int, task_batch: int,
                        seed: int = 0) -> LMTaskSource:
    """Serve-time episode stream: one live task per request, drawn from a
    small domain universe whose tail is held out — ``split='unseen'``
    reproduces the launch scenario (adapt to a domain never trained on)."""
    return LMTaskSource(
        vocab_size=cfg.padded_vocab, seq_len=seq_len, K=1,
        tasks_per_agent=1, task_batch=task_batch,
        n_domains=8, holdout_domains=2, seed=seed)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers, widths kept "
                         "(a depth cut; an encoder-decoder cuts encoder "
                         "and decoder each to N, a vision model takes a "
                         "multiple of its cross_attn_every, a hybrid one "
                         "of its attn_every)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--adapt-steps", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="drives launch-model init (no checkpoint), the "
                         "support episode draws, and sampling")
    ap.add_argument("--ckpt-dir", default=None,
                    help="training checkpoint dir (e.g. ckpts/seed0): the "
                         "launch model is the checkpoint's agent-centroid; "
                         "omit to serve from a fresh init")
    ap.add_argument("--split", default=None,
                    choices=["recurring", "unseen", "full"],
                    help="which eval split the live tasks are drawn from "
                         "(default: unseen — the launch scenario)")
    ap.add_argument("--users", type=int, default=4,
                    help="concurrent adaptation requests per round (one "
                         "vmapped inner_adapt dispatch, bucket-padded)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="request rounds; rounds after the first re-draw "
                         "the same tasks, exercising the adapted-state "
                         "cache's recurring-user fast path")
    ap.add_argument("--cache-capacity", type=int, default=64)
    ap.add_argument("--rank", type=int, default=8,
                    help="low-rank delta factorization rank (per matrix "
                         "leaf, fidelity-gated — see serve/lowrank.py)")
    ap.add_argument("--run-log", default=None,
                    help="JSONL path for the engine's kind=serve record")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    return ap.parse_args(argv)


def main(argv=None, on_round=None) -> dict:
    """Run the CLI; returns the engine, the source, the last round's
    episode and adapted states, the tokens and every metrics record.

    ``on_round(engine, rnd, episode, adapted, metrics)``, when given, is
    called after each round, while that round's adapted states are alive:
    a caller reads them there, and they are released when the next round
    starts (each holds a full copy of the weights per user)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = S.cut_depth(cfg, args.layers)
    if args.reduced:
        cfg = cfg.reduced()
    dt = S.DTYPES[cfg.dtype] if not args.reduced else torch.float32

    B, total = args.batch, args.prompt_len + args.gen
    engine = ServeEngine(
        cfg, prompt_len=args.prompt_len, gen=args.gen, batch=B,
        adapt_steps=args.adapt_steps, temperature=args.temperature,
        cache_capacity=args.cache_capacity, rank=args.rank, dtype=dt,
        device=device)

    if args.ckpt_dir:
        like = {k: v.to(dt) for k, v in engine.bundle.params_specs.items()}
        params = restore_centroid(args.ckpt_dir, like, device=device)
        print(f"[serve] launch model = checkpoint centroid ({args.ckpt_dir})")
    else:
        params = engine.model.init(torch.Generator().manual_seed(args.seed),
                                   dt, device)
        print(f"[serve] launch model = fresh init (seed {args.seed})")
    engine.load_params(params)

    # -- adapt: --users concurrent episodes per round; same tasks each
    # round (same eval seed → same domain draw), so rounds 2+ are the
    # recurring-user path and resolve from the adapted-state cache
    source = make_support_source(cfg, total, B, seed=args.seed)
    ep, adapted, rounds = None, None, []
    for rnd in range(args.rounds):
        ep = source.eval_sample(args.users, seed=args.seed, split=args.split)
        requests = engine.requests_from_episode(source, ep)
        adapted = None
        adapted, m = engine.adapt(requests)
        rounds.append(m)
        doms = np.asarray(ep.domains).tolist()
        print(f"[serve] round {rnd}: adapted {m['n']} users "
              f"(domains {doms}) in {m['seconds']:.3f}s — "
              f"{m['hits']} cache hits, {m['misses']} misses "
              f"(buckets {m['buckets']}; compress {m['compress_s']:.3f}s, "
              f"of it SVD {m['svd_s']:.3f}s)")
        if on_round is not None:
            on_round(engine, rnd, ep, adapted, m)

    # -- decode from the first user's adapted model: prompts are fresh
    # sequences of the domain it just adapted to (the episode's query half)
    prompt = np.asarray(ep.query["tokens"][0])[:, : args.prompt_len]
    tokens, dm = engine.decode(adapted[0], prompt, seed=args.seed)
    print(f"[serve] prompt: {B} seqs × {args.prompt_len} tok in "
          f"{dm['prefill_s']:.3f}s ({dm['prompt_tok_s']:.1f} tok/s prefill)")
    print(f"[serve] decode: {B} seqs × {args.gen} tok in "
          f"{dm['decode_s']:.3f}s ({dm['decode_tok_s']:.1f} tok/s)")
    print("[serve] sample:", tokens[0].tolist())

    stats = engine.cache.stats()
    print(f"[serve] cache: {stats['hits']} hits / {stats['misses']} misses "
          f"/ {stats['evictions']} evictions, {stats['residents']} "
          f"residents, {stats['compression']:.2f}x delta compression")

    if args.run_log:
        log = RunLog(args.run_log)
        log.write(**engine.log_record())
        log.close()
        print(f"[serve] run log -> {args.run_log}")
    return {"engine": engine, "source": source, "episode": ep,
            "adapted": adapted, "tokens": tokens, "rounds": rounds,
            "decode": dm}


if __name__ == "__main__":
    main()
