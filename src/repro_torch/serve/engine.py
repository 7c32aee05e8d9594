"""The serving tier: batched adaptation + cached adapted state + decode
(port of ``repro/serve/engine.py``).

``launch/serve.py`` is a thin CLI over this module.  The engine owns three
serving-cost levers:

batched adaptation
    N concurrent user episodes adapt in ONE ``torch.func.vmap`` of
    ``inner_adapt`` (``EvalHarness.adapt_states``); on the card every
    attention layer's forward and backward in it are the flash-attention
    kernels, each launch folding the N users into its batch.  Request
    counts are padded up to a small set of *buckets* (the reference's
    compile sizes; here they bound the shapes the dispatch sees).

adapted-state cache
    Recurring tasks (same ``TaskKey``: source fingerprint × domain ×
    adapt hyperparams) skip re-adaptation: the cache reconstructs
    ``w + δ`` from a host-resident low-rank delta.

decode
    A teacher-forced prefill of the prompt (P−1 single-token decode
    steps, as the reference's prefill scan) and a greedy or sampling
    decode, timed separately.  The reference scans both with ``lax.scan``
    under ``jit``; the port runs them eagerly, one Python step per token.
    Sampling (``temperature > 0``) draws from an explicit
    ``torch.Generator`` seeded per call; it cannot reproduce
    ``jax.random.categorical``'s draws, so parity holds for greedy decode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs import ArchConfig, InputShape
from repro_torch.data.episodes import Episode
from repro_torch.device import resolve_device
from repro_torch.eval.harness import EvalHarness
from repro_torch.launch import steps as S
from repro_torch.models.transformer import build_model
from repro_torch.serve.cache import AdaptedStateCache, TaskKey, task_key

Params = dict[str, torch.Tensor]

__all__ = ["AdaptRequest", "ServeEngine"]


@dataclasses.dataclass
class AdaptRequest:
    """One user's adaptation request: a support episode to adapt on, plus
    the cache coordinate (``key=None`` opts out of caching)."""
    support: dict
    key: TaskKey | None = None


def _percentiles(xs: Sequence[float]) -> dict:
    if not xs:
        return {}
    a = np.asarray(xs, dtype=np.float64)
    return {"p50_us": float(np.percentile(a, 50) * 1e6),
            "p99_us": float(np.percentile(a, 99) * 1e6),
            "mean_us": float(a.mean() * 1e6),
            "n": len(xs)}


class ServeEngine:
    """Adaptation-as-a-service over one launch model, on ``device`` (None:
    the CUDA card).

    Geometry (``batch`` decode sequences of ``prompt_len + gen`` tokens) is
    fixed per engine.  ``buckets`` are the adapt-batch sizes; a request
    batch pads up to the next bucket (and chunks above the largest).
    """

    def __init__(self, cfg: ArchConfig, *, prompt_len: int, gen: int,
                 batch: int, adapt_steps: int | None = None,
                 inner_lr: float | None = None, temperature: float = 0.0,
                 cache_capacity: int = 64, rank: int = 8, tol: float = 0.3,
                 buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
                 dtype: torch.dtype | None = None, device=None):
        if prompt_len < 1 or gen < 1:
            raise ValueError("prompt_len and gen must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prompt_len = prompt_len
        self.gen = gen
        self.batch = batch
        self.total = prompt_len + gen
        self.temperature = temperature
        self.buckets = tuple(sorted(set(buckets)))
        self.dtype = dtype if dtype is not None else S.DTYPES[cfg.dtype]
        self.inner_lr = float(cfg.inner_lr if inner_lr is None else inner_lr)
        self.adapt_steps = int(cfg.inner_steps if adapt_steps is None
                               else adapt_steps)
        self.model = build_model(cfg)
        shape = InputShape("serve_adapt", self.total, batch, "decode")
        self.bundle = S.build_serve(cfg, shape)
        self.harness = EvalHarness(self.model.loss_fn, self.inner_lr,
                                   self.adapt_steps)
        self.cache = AdaptedStateCache(capacity=cache_capacity, rank=rank,
                                       tol=tol)
        self.params: Params | None = None
        self._adapt_log: list[dict] = []
        self._decode_log: list[dict] = []

    # -- params ---------------------------------------------------------------

    def load_params(self, params: Params) -> None:
        """Install the launch model (checkpoint centroid or fresh init)
        all residents adapt from.  Swap params only together with a fresh
        cache: deltas key on the task, not on the launch model."""
        self.params = params

    def _require_params(self) -> Params:
        if self.params is None:
            raise RuntimeError(
                "no launch model loaded: call load_params() first")
        return self.params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- batched adaptation ---------------------------------------------------

    def signature(self, source: Any, domain: int) -> TaskKey:
        """Cache key for ``domain`` of ``source`` under this engine's
        adapt hyperparameters."""
        return task_key(source, domain, self.adapt_steps, self.inner_lr)

    def requests_from_episode(self, source: Any, ep: Episode
                              ) -> list[AdaptRequest]:
        """Split an ``eval_sample`` episode (task-leading leaves) into one
        keyed request per task."""
        n = len(next(iter(ep.support.values())))
        doms = np.asarray(ep.domains)
        return [AdaptRequest({k: v[i] for k, v in ep.support.items()},
                             self.signature(source, int(doms[i])))
                for i in range(n)]

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _stack(self, batches: Sequence[dict], pad_to: int) -> dict:
        rows = list(batches) + [batches[0]] * (pad_to - len(batches))
        stacked = {k: torch.stack([torch.as_tensor(np.asarray(r[k]))
                                   for r in rows]).to(self.device)
                   for k in batches[0]}
        tb = next(iter(stacked.values())).shape[1]
        stacked.update(S.modality_extras(self.cfg, (pad_to, tb), self.dtype,
                                         self.device))
        return stacked

    def adapt(self, requests: Sequence[AdaptRequest]
              ) -> tuple[list[Params], dict]:
        """Serve a batch of adaptation requests.

        Cache hits reconstruct from their stored delta; misses adapt in
        bucket-padded vmapped ``inner_adapt`` dispatches and enter the
        cache.  Returns per-request adapted params (request order) and a
        metrics record (hit/miss counts, bucket sizes, phase seconds, and
        of the miss seconds those spent compressing into the cache).
        """
        params = self._require_params()
        results: list[Params | None] = [None] * len(requests)

        t0 = time.perf_counter()
        miss_idx = []
        with torch.no_grad():
            for i, req in enumerate(requests):
                hit = (self.cache.lookup(req.key, params)
                       if req.key is not None else None)
                if hit is None:
                    miss_idx.append(i)
                else:
                    results[i] = hit
        self._sync()
        hit_s = time.perf_counter() - t0

        buckets_used, compress_s, svd_s, dispatch_s = [], 0.0, 0.0, 0.0
        t0 = time.perf_counter()
        cap = self.buckets[-1]
        for lo in range(0, len(miss_idx), cap):
            chunk = miss_idx[lo: lo + cap]
            b = self._bucket(len(chunk))
            buckets_used.append(b)
            stacked = self._stack([requests[i].support for i in chunk], b)
            t1 = time.perf_counter()
            adapted = self.harness.adapt_states(params, stacked)
            self._sync()
            dispatch_s += time.perf_counter() - t1
            for j, i in enumerate(chunk):
                one = {k: v[j] for k, v in adapted.items()}
                results[i] = one
                if requests[i].key is not None:
                    entry = self.cache.insert(requests[i].key, params, one)
                    compress_s += entry.seconds
                    svd_s += entry.svd_seconds
        miss_s = time.perf_counter() - t0

        n_miss = len(miss_idx)
        metrics = {
            "n": len(requests),
            "hits": len(requests) - n_miss,
            "misses": n_miss,
            "buckets": buckets_used,
            "hit_s": hit_s,
            "miss_s": miss_s,
            "adapt_dispatch_s": dispatch_s,
            "compress_s": compress_s,
            "svd_s": svd_s,
            "seconds": hit_s + miss_s,
        }
        self._adapt_log.append(metrics)
        return results, metrics  # type: ignore[return-value]

    def adapted_loss(self, adapted: Sequence[Params], batches: Sequence[dict]
                     ) -> np.ndarray:
        """(n,) losses, each task's adapted params on its own batch — the
        drift probe for delta-reconstructed states."""
        stacked_b = self._stack(batches, len(batches))
        with torch.no_grad():
            stacked_p = {k: torch.stack([a[k] for a in adapted])
                         for k in adapted[0]}
            losses = self.harness.task_loss(stacked_p, stacked_b)
        return losses.float().cpu().numpy()

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def decode(self, params: Params, prompt: Any, seed: int = 0
               ) -> tuple[np.ndarray, dict]:
        """Generate ``gen`` tokens per sequence from an adapted model.

        ``prompt`` is ``(batch, prompt_len)`` int tokens.  Returns
        ``(batch, prompt_len + gen)`` tokens and per-phase metrics —
        prompt (prefill) and decode are timed separately.
        """
        prompt = torch.as_tensor(np.asarray(prompt)).to(self.device,
                                                        torch.int64)
        if tuple(prompt.shape) != (self.batch, self.prompt_len):
            raise ValueError(
                f"prompt shape {tuple(prompt.shape)} != "
                f"{(self.batch, self.prompt_len)}")
        B, P, G = self.batch, self.prompt_len, self.gen
        step = self.bundle.step_fn
        cache = self.model.init_cache(B, self.total, self.dtype, self.device)
        pos = lambda t: torch.full((B,), t, dtype=torch.int64,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        self._sync()
        t0 = time.perf_counter()
        # teacher-forced prompt positions 0..P-2 (logits discarded: the
        # next input is the prompt itself)
        for t in range(P - 1):
            _, cache = step(params, cache, prompt[:, t:t + 1], pos(t))
        self._sync()
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        tok, out = prompt[:, -1], []
        # positions P-1..P+G-2: feed the current token, pick the next
        for t in range(P - 1, P - 1 + G):
            logits, cache = step(params, cache, tok[:, None], pos(t))
            logits = logits[:, 0].float()
            if self.temperature > 0:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        tokens = torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
        tokens = tokens.cpu().numpy()
        decode_s = time.perf_counter() - t0

        metrics = {
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            # prefill processes P-1 prompt tokens, decode emits G tokens
            "prompt_tok_s": B * (P - 1) / prefill_s if P > 1 else 0.0,
            "decode_tok_s": B * G / decode_s,
        }
        self._decode_log.append(metrics)
        return tokens, metrics

    # -- run log --------------------------------------------------------------

    def log_record(self) -> dict:
        """One ``kind=serve`` JSONL record: engine geometry, cache
        counters, and adapt/decode latency distributions."""
        adapt_lat = [m["seconds"] / max(m["n"], 1) for m in self._adapt_log]
        return {
            "kind": "serve",
            "arch": self.cfg.name,
            "batch": self.batch,
            "prompt_len": self.prompt_len,
            "gen": self.gen,
            "adapt_steps": self.adapt_steps,
            "inner_lr": self.inner_lr,
            "buckets": list(self.buckets),
            "device": str(self.device),
            "cache": self.cache.stats(),
            "adapt": {
                "calls": len(self._adapt_log),
                "requests": sum(m["n"] for m in self._adapt_log),
                **_percentiles(adapt_lat),
            },
            "decode": {
                "calls": len(self._decode_log),
                "prompt_tok_s": [m["prompt_tok_s"]
                                 for m in self._decode_log[-8:]],
                "decode_tok_s": [m["decode_tok_s"]
                                 for m in self._decode_log[-8:]],
            },
        }
