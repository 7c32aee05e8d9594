#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:

1. device    -- a CUDA card must be present; prints its name and power limit.
2. build     -- compiles the CUDA sources of ``kernels/dif_combine/csrc``,
                ``kernels/flash_attention/csrc`` and ``kernels/ssd_scan/csrc``
                with nvcc for sm_90a, all at once, and prints the build
                seconds and, from ``cuobjdump -sass``, the HGMMA (wgmma)
                instructions in each bf16 flash kernel: the forward, dQ and
                dK/dV kernels must have some.  Then one call of
                ``gqa_flash_attention`` at the serving shape must run one
                kernel forward and two backward (torch.profiler, before any
                other profiling: sessions after phase 5's miss kernels).
3. kernels   -- holds ``dif_combine`` and ``fused_combine_update`` against
                their plain PyTorch versions on the card: at the shapes the
                training step gives them (the sine MLP's leaves, K=6, padded
                as the step pads them) and at K=6, M=2^24 in float32 and
                bfloat16, the fused kernel across optimizer kind x mix mode
                x gate x schedule length.  Each check prints its largest
                error against the stated tolerance, the kernel's time, the
                plain version's, the least time the card could take (bound)
                and, for the combine, one PyTorch matmul's time.
4. training  -- runs ``python -m repro_torch.launch.quickstart`` (K=6 agents
                on the paper's Fig. 2a graph, ATC, exact MAML, Adam) for 300
                steps with ``--backend dense``, ``pallas`` and ``fused`` from
                one init and one episode stream, and 5 steps on the CPU as a
                reference.  Losses must be finite and fall, disagreement stay
                small, the backends agree step by step, and each kernel's
                launch counter, zeroed just before its run, show its launches.
5. profile   -- device time per step of the fused training step
                (torch.profiler), to show where a step's time goes.
6. flash     -- holds the flash-attention forward (out, lse) and backward
                (dq, dk, dv) kernels against ``attention_ref`` and its autograd
                gradient, and the backward against its plain version: in
                (B, H, S, d) with heads expanded, S in {128, 256, 1024} x d
                in {64, 128} x {causal, bidirectional, causal window 64} x
                {float32, bfloat16}, and the serving path's shape (B=16: 4
                users x 4 sequences, H=12, S=256, d=128, bfloat16, causal);
                in the model's layout with qwen2's 2 KV heads not expanded
                (``gqa_flash_attention``, what the serving path calls), B=2
                at S in {128, 1024} and the serving shape.  Each check
                prints its errors, the kernels' times, the plain versions',
                SDPA's (the library yardstick, never called by the port;
                ``enable_gqa`` in the model's layout, its backward timed by
                torch.profiler's device time, as a CUDA graph cannot
                capture it) and the bounds (K/V bytes with their own
                heads).  At both serving rows, planted faults in the
                backward's output (a dropped key tile, zeroed rows) must
                fail its check; at the model-layout one the times with a
                cold L2 (64 MB written between calls) are printed beside
                the warm ones.  This phase runs before phase 5.
7. serve     -- runs ``python -m repro_torch.launch.serve --arch qwen2-1.5b``
                at full width (28 layers, bfloat16, fresh init from seed 0;
                4 users x 4 sequences x 256 tokens, 2 adapt steps, 2 rounds,
                128 prompt + 128 generated tokens).  The flash launch
                counters, zeroed just before, must show 28 x 2 forward and
                2 x 28 x 2 backward launches (one adapt dispatch; the
                backward is a dK/dV and a dQ kernel); round 1 has 4
                misses and round 2 4 hits; every adapted leaf is finite; each
                user's support loss falls with adaptation; 256 tokens come
                out per sequence.  (Users of one domain share a cache entry,
                as in the reference: a hit returns the state of the
                domain's last adapted user, and that user's support loss
                must stay below the launch model's.)  Prints adapt,
                compress and SVD seconds, tok/s, peak device memory by
                stage, and where the adapt dispatch's peak goes (one more
                dispatch with the allocator's history recorded).
8. agreement -- the same config cut to 2 layers, one set of weights and one
                episode: the launch and adapted support and query losses on
                the card (kernels) match a CPU run of the port (plain
                versions) in the same dtype, within 2e-2 relative in
                float32 and 1e-3 in bfloat16, and adaptation lowers the
                support loss in every run.  The
                CPU's bf16 losses against its f32 ones are reported.
9. ssd       -- holds the SSD scan kernel against ``ssd_scan_ref`` (the
                per-step recurrence): tests/test_kernels.py's grid (L, chunk
                in {(128, 32), (256, 64), (256, 128)}, B=2, H=2, P=16, N=32),
                a two-halves state-continuity check, and the serving path's
                shape (B=16: 4 users x 4 sequences, L=1024, H=24, P=64,
                N=128, one B/C group, chunk 256), each in float32 and
                bfloat16.  At the serving shape, planted faults (the state
                not carried across chunks, one chunk's rows of y zeroed, the
                final state of the first chunk) must fail the check.  Each
                row prints its errors, the kernel's time, the plain
                version's, the port's chunked torch scan's and the bound;
                at the serving shape also the time of the pairing's
                backward (the chunked scan's VJP) and what it allocates at
                its peak, beside one VJP over the whole loop of chunks
                (every chunk's tiles live at once) on the same inputs.
10. mamba2 serve -- runs ``python -m repro_torch.launch.serve --arch
                mamba2-130m --prompt-len 512 --gen 512`` at full width (24
                layers, bfloat16, fresh init from seed 0; 4 users x 4
                sequences x 1024 tokens, 2 adapt steps, 2 rounds).  The
                ssd_scan launch counter, zeroed just before, must show 24 x 2
                launches (one adapt dispatch); 4 misses then 4 hits; finite
                adapted leaves; falling support losses; 1024 tokens a
                sequence.  Prints the serve phase's numbers as phase 7 does,
                the device time of one more dispatch split between the
                kernel forward and the chunked-scan backward
                (torch.profiler), and where its peak memory goes.
11. mamba2 agreement -- phase 8 for mamba2-130m cut to 2 layers at full
                width, one episode of 4 x 1024 tokens: float32 within 1e-4
                relative, bfloat16 within 1e-3.

The last two lines of standard output are the kernels' numbers and the
device, as JSON.  Without a CUDA card the script exits 1 before any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
# float32: the kernels evaluate the plain versions' expressions but sum the
# K terms of a mix in another order (a few ulps of values of order 1).
# bfloat16: outputs are rounded to bf16 after that, so one ulp (2^-7
# relative) may separate them.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
DEVICE = "cuda"
K = 6
LARGE_M = 1 << 24
STEPS = 300
# Per-step loss of two backends on the card: the same f32 math in another
# summation order (a CPU run of 300 steps differs by 2.4e-7 relative).
LOSS_RTOL = 1e-4
SOURCE = "src/repro_torch/kernels/dif_combine/csrc/dif_combine.cu"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
REPLACES = {"dif_combine": "src/repro/kernels/dif_combine/dif_combine.py:94",
            "fused_combine_update":
                "src/repro/kernels/dif_combine/dif_combine.py:174",
            "flash_attention_fwd":
                "src/repro/kernels/flash_attention/flash_attention.py:84",
            "flash_attention_bwd":
                "src/repro/kernels/flash_attention/flash_bwd.py:107",
            "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:73"}
# Flash attention against attention_ref and its autograd gradient, and the
# backward also against its plain version.  float32: the same products
# summed in another order (a blocked online softmax).  bfloat16: both round
# float32 results to bf16, two bf16 ulps apart at most (rtol), plus an atol
# of FLASH_BF16_ROW_ATOL times the largest |value| of the element's row (one
# bf16 ulp of it at most) for the float32 sums' order near zero.  A fixed
# atol would not do: late rows of dq and dk are smaller than any fixed atol
# that the early rows would need.  Against autograd the backward also
# carries the rounding of the stored output it reads (stored_output_slack).
FLASH_TOL = {torch.float32: {"fwd": dict(rtol=1e-5, atol=1e-5),
                             "bwd": dict(rtol=1e-4, atol=1e-4)},
             torch.bfloat16: {"fwd": dict(rtol=1.6e-2, atol=0.0),
                              "bwd": dict(rtol=1.6e-2, atol=0.0)}}
FLASH_BF16_ROW_ATOL = 2.0 ** -8
# The serving path's attention shape: 4 users x 4 sequences, 12 heads,
# 256 tokens, head dim 128, bfloat16, causal.
FLASH_MAIN = dict(B=16, H=12, S=256, d=128, dtype=torch.bfloat16,
                  causal=True, window=None)
# The same in the model's layout, as the serving path calls it: q (B, S, H,
# d), k/v (B, S, KV, d) with qwen2-1.5b's 2 KV heads not expanded.
FLASH_GQA_MAIN = dict(B=16, S=256, H=12, KV=2, d=128, dtype=torch.bfloat16,
                      causal=True, window=None)
FLUSH_BYTES = 64 << 20           # written between launches for a cold L2
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--batch", "4", "--prompt-len", "128",
              "--gen", "128", "--adapt-steps", "2", "--users", "4",
              "--rounds", "2", "--seed", "0"]
# Losses of the 2-layer model on the card (kernels) against a CPU run
# (plain versions) in the same dtype: float32 at 2e-2; bfloat16
# at 1e-3, some 35x the largest gap measured on an H100 (2.8e-5: P rounded
# to bf16 before P.V on the CPU and kept in f32 by the kernel, and the
# order of the sums).
AGREE_RTOL = {"card_f32_vs_cpu_f32": 2e-2, "card_bf16_vs_cpu_bf16": 1e-3}
# The SSD scan against the per-step recurrence: float32 within 1e-4 abs and
# rel on y and the state (the chunked form sums in another order over up to
# 1024 steps); bfloat16 y within two bf16 ulps (rtol) plus 2^-8 of the
# row's largest |value| (FLASH_BF16_ROW_ATOL), its float32 state as in
# float32.
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=1.6e-2, atol=0.0)}
# The serving path's scan: 4 users x 4 sequences of 1024 tokens, 24 heads of
# head dim 64, state 128, one B/C group, chunk 256.
SSD_MAIN = dict(B=16, L=1024, H=24, P=64, N=128, G=1, chunk=256)
MAMBA_SERVE_ARGS = ["--arch", "mamba2-130m", "--batch", "4",
                    "--prompt-len", "512", "--gen", "512", "--adapt-steps",
                    "2", "--users", "4", "--rounds", "2", "--seed", "0"]
# mamba2 losses on the card against the CPU in the same dtype: float32 the
# same math in another order; bfloat16 at 1e-3, as for qwen2.
MAMBA_AGREE_RTOL = {"card_f32_vs_cpu_f32": 1e-4,
                    "card_bf16_vs_cpu_bf16": 1e-3}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, reps: int = 7) -> float:
    """Median device ms of one ``fn()``: ``n`` calls captured in a CUDA
    graph (so no host overhead sits between launches), replayed ``reps``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def outside(got, want, tol: dict, slack=0.0) -> tuple[int, float]:
    """(elements of ``got`` outside ``tol`` plus a per-element ``slack``
    around ``want``, largest |got - want|)."""
    err = (got.detach().float() - want.detach().float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.detach().float().abs() + slack
    return int((err > limit).sum()), float(err.max())


def compare(got, want, dtype, what: str, tol: dict | None = None,
            slack=0.0) -> float:
    """Largest |got - want|; raises unless within ``tol`` (TOL[dtype]) plus
    a per-element ``slack``."""
    tol = TOL[dtype] if tol is None else tol
    bad, err = outside(got, want, tol, slack)
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: {bad} elements outside "
                             f"{tol} (max abs err {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# Phase 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

def combine_cost(K: int, M: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of out = A^T phi: A and phi read once, out written
    once; K multiply-adds per output element."""
    return K * K * 4 + 2 * K * M * itemsize, 2.0 * K * K * M


def fused_cost(kind: str, mode: str, K: int, M: int, itemsize: int
               ) -> tuple[float, float]:
    """(bytes, flops) of one fused update over a (K, M) group: w and g read,
    w' written, the moments read and written, the selected (K, K) row of
    the table, sel, ctl and the clip scale read."""
    mom = {"adam": 4 * 4, "momentum": 2 * itemsize, "sgd": 0}[kind]
    nbytes = K * M * (3 * itemsize + mom) + K * 4 + 4 + 12
    if mode != "local":
        nbytes += K * K * 4
    per_elem = 1 + {"adam": 15, "momentum": 3, "sgd": 1}[kind]
    per_elem += 1 if mode == "local" else 2 * K + 1
    return nbytes, float(per_elem * K * M)


def fused_inputs(gen, kind, S, K, M, dtype, m_real=None):
    """Random (table, sel, ctl, scale, w, g, *moments) on the card; columns
    from ``m_real`` on are the zero pad the training step adds."""
    dev = torch.device(DEVICE)
    table = torch.rand(S, K, K, generator=gen, device=dev)
    table = table / table.sum(1, keepdim=True)        # column-stochastic
    scale = torch.rand(K, 1, generator=gen, device=dev)
    bufs = [torch.randn(K, M, generator=gen, device=dev),
            torch.randn(K, M, generator=gen, device=dev)]
    if kind == "adam":
        bufs += [0.1 * torch.randn(K, M, generator=gen, device=dev),
                 0.01 * torch.rand(K, M, generator=gen, device=dev)]
    elif kind == "momentum":
        bufs.append(torch.randn(K, M, generator=gen, device=dev))
    mom_dt = torch.float32 if kind == "adam" else dtype
    bufs = [b.to(dtype if i < 2 else mom_dt) for i, b in enumerate(bufs)]
    if m_real is not None:
        for b in bufs:
            b[:, m_real:] = 0
    return [table, scale] + bufs


def check_fused(ops, ref, gen, kind, mode, gate, S, M, dtype, m_real=None,
                timed=False):
    table, scale, *bufs = fused_inputs(gen, kind, S, K, M, dtype, m_real)
    sel = torch.tensor([[S - 1]], dtype=torch.int32, device=DEVICE)
    ctl = torch.tensor([[gate, 1 - 0.9 ** 3, 1 - 0.999 ** 3]],
                       device=DEVICE)
    hyper = dict(mode=mode, kind=kind, lr=1e-3,
                 weight_decay=0.01 if kind == "adam" else 0.0)
    args = (table, sel, ctl, scale, *bufs)
    got = ops.fused_combine_update(*args, **hyper)
    want = ref.fused_update_ref(*args, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("w", "mu", "nu"), got, want):
        if b is None:
            continue
        what = f"fused {kind}/{mode} gate={gate} S={S} {dtype} M={M} {name}"
        err = max(err, compare(a, b, a.dtype, what))
        if m_real is not None and torch.count_nonzero(a[:, m_real:]):
            raise AssertionError(f"{what}: padded columns are not zero")
    row = dict(kind=kind, mode=mode, gate=gate, S=S, M=M,
               dtype=str(dtype).split(".")[-1], max_abs_err=err,
               tol=TOL[dtype])
    if timed:
        n = 3 if M >= LARGE_M else 50
        row["ms"] = time_ms(lambda: ops.fused_combine_update(*args, **hyper),
                            n)
        row["plain_ms"] = time_ms(
            lambda: ref.fused_update_ref(*args, **hyper), n)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *fused_cost(kind, mode, K, M, bufs[0].element_size()))
    print("check", json.dumps(row), flush=True)
    return row


def check_combine(ops, ref, A, phi, m_real=None):
    out = ops.dif_combine(A, phi)
    want = ref.dif_combine_ref(A, phi)
    torch.cuda.synchronize()
    M = phi.shape[1]
    what = f"dif_combine {phi.dtype} M={M}"
    row = dict(M=M, dtype=str(phi.dtype).split(".")[-1],
               max_abs_err=compare(out, want, phi.dtype, what),
               tol=TOL[phi.dtype])
    if m_real is not None and torch.count_nonzero(out[:, m_real:]):
        raise AssertionError(f"{what}: padded columns are not zero")
    n = 3 if M >= LARGE_M else 50
    row["ms"] = time_ms(lambda: ops.dif_combine(A, phi), n)
    row["plain_ms"] = time_ms(lambda: ref.dif_combine_ref(A, phi), n)
    # the yardstick: one PyTorch matmul of the same function (cuBLAS)
    lib = ((lambda: A.t() @ phi) if phi.dtype == torch.float32
           else (lambda: A.t().float() @ phi.float()))
    row["library_ms"] = time_ms(lib, n)
    row["bound_ms"], row["bound_by"] = bound_ms(
        *combine_cost(K, M, phi.element_size()))
    print("check", json.dumps(row), flush=True)
    return row


def kernels_phase(ops, ref, diffusion, SineMLP, SINE_MLP, paper_A):
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    A = torch.as_tensor(paper_A, dtype=torch.float32, device=DEVICE)
    # --- main-path shapes: the sine MLP's leaves with the agent axis -----
    leaves = {name: (K,) + spec.shape
              for name, spec in SineMLP(SINE_MLP).specs().items()}
    phi = {n: torch.randn(s, generator=gen, device=DEVICE)
           for n, s in leaves.items()}
    bufs, _ = diffusion.pack_pytree(phi)          # the pallas backend's pack
    m_total = sum(int(np.prod(s[1:])) for s in leaves.values())
    main_combine = [check_combine(ops, ref, A, b, m_total) for b in bufs]
    widths = {}
    for s in leaves.values():                     # the fused path's pad
        m = int(np.prod(s[1:]))
        widths.setdefault(diffusion.pad_geometry(m)[0], m)
    for m_pad, m in sorted(widths.items()):
        for kind in ops.KINDS:
            for mode in ops.MODES:
                for gate in (0.0, 1.0):
                    for S in (1, 4):
                        check_fused(ops, ref, gen, kind, mode, gate, S, m_pad,
                                    torch.float32, m_real=m)
    # one training step's launches, timed together: Adam, ATC, the static
    # paper graph (S=1), a communication step (gate 1)
    step_args = []
    for s in leaves.values():
        m = int(np.prod(s[1:]))
        m_pad = diffusion.pad_geometry(m)[0]
        table, scale, *b = fused_inputs(gen, "adam", 1, K, m_pad,
                                        torch.float32, m_real=m)
        table = A[None].contiguous()
        step_args.append((table, torch.zeros(1, 1, dtype=torch.int32,
                                             device=DEVICE),
                          torch.tensor([[1.0, 0.1, 0.001]], device=DEVICE),
                          scale, *b))
    hyper = dict(mode="atc", kind="adam", lr=1e-3)
    main_err = 0.0
    for a in step_args:
        for x, y in zip(ops.fused_combine_update(*a, **hyper),
                        ref.fused_update_ref(*a, **hyper)):
            main_err = max(main_err, compare(x, y, torch.float32,
                                             "fused main-path step"))
    fused_step = dict(
        max_abs_err=main_err,
        ms=time_ms(lambda: [ops.fused_combine_update(*a, **hyper)
                            for a in step_args], 50),
        plain_ms=time_ms(lambda: [ref.fused_update_ref(*a, **hyper)
                                  for a in step_args], 50))
    costs = [fused_cost("adam", "atc", K, a[4].shape[1], 4)
             for a in step_args]
    fused_step["bound_ms"], fused_step["bound_by"] = bound_ms(
        sum(c[0] for c in costs), sum(c[1] for c in costs))
    print("fused main-path step", json.dumps(fused_step), flush=True)

    # --- large: K=6, M=2^24 ----------------------------------------------
    large = {"dif_combine": [], "fused_combine_update": []}
    for dtype in (torch.float32, torch.bfloat16):
        phi = torch.randn(K, LARGE_M, generator=gen, device=DEVICE).to(dtype)
        large["dif_combine"].append(check_combine(ops, ref, A, phi))
        del phi
        for kind in ops.KINDS:
            for mode in ops.MODES:
                for gate in (0.0, 1.0):
                    for S in (1, 4):
                        large["fused_combine_update"].append(check_fused(
                            ops, ref, gen, kind, mode, gate, S, LARGE_M,
                            dtype, timed=True))
        torch.cuda.empty_cache()
    return main_combine, fused_step, len(step_args), large


# ---------------------------------------------------------------------------
# Phase 4: the training step through the quickstart entry point
# ---------------------------------------------------------------------------

def run_quickstart(quickstart, ops, backend, steps, device=None):
    device = device or DEVICE
    ops.reset_launch_counts()
    out = quickstart.main(["--steps", str(steps), "--backend", backend,
                           "--device", device])
    counts = dict(ops.launch_counts)
    print(f"main path backend={backend} device={device}: "
          f"{out['ms_per_step']:.3f} ms/step, launches {counts}", flush=True)
    return out, counts


def main_path_phase(quickstart, ops, n_groups, n_leaves):
    runs = {}
    for backend in ("dense", "pallas", "fused"):
        runs[backend] = run_quickstart(quickstart, ops, backend, STEPS)
    cpu, cpu_counts = run_quickstart(quickstart, ops, "dense", 5, "cpu")
    expect = {"dense": {"dif_combine": 0, "fused_combine_update": 0},
              "pallas": {"dif_combine": STEPS * n_groups,
                         "fused_combine_update": 0},
              "fused": {"dif_combine": 0,
                        "fused_combine_update": STEPS * n_leaves}}
    ref_loss = runs["dense"][0]["loss"]
    for backend, (out, counts) in runs.items():
        loss, dis = out["loss"], out["disagreement"]
        if counts != expect[backend]:
            raise AssertionError(f"{backend}: launches {counts}, expected "
                                 f"{expect[backend]}")
        if not (np.isfinite(loss).all() and np.isfinite(dis).all()):
            raise AssertionError(f"{backend}: non-finite loss/disagreement")
        first, last = float(loss[:20].mean()), float(loss[-50:].mean())
        if not last < 0.95 * first:
            raise AssertionError(f"{backend}: loss did not fall "
                                 f"({first:.4f} -> {last:.4f})")
        if not float(dis.max()) < 1e-2:
            raise AssertionError(f"{backend}: disagreement reached "
                                 f"{float(dis.max()):.3e}")
        curve = out["curve"]
        if not curve[5] < curve[0]:
            raise AssertionError(f"{backend}: adaptation does not lower the "
                                 f"eval loss ({curve})")
        rel = float(np.max(np.abs(loss / ref_loss - 1)))
        rel_cpu = float(np.max(np.abs(loss[:5] / cpu["loss"] - 1)))
        if rel > LOSS_RTOL or rel_cpu > LOSS_RTOL:
            raise AssertionError(
                f"{backend}: per-step loss differs from dense on the card by "
                f"{rel:.2e} and from the CPU by {rel_cpu:.2e} (limit "
                f"{LOSS_RTOL})")
        print("main path", json.dumps(dict(
            backend=backend, steps=STEPS, ms_per_step=out["ms_per_step"],
            loss_first20=first, loss_last50=last,
            disagreement_max=float(dis.max()),
            loss_rel_vs_dense=rel, loss_rel_vs_cpu_5steps=rel_cpu,
            eval_curve=[float(c) for c in curve], launches=counts)),
            flush=True)
    if cpu_counts != expect["dense"]:
        raise AssertionError(f"CPU reference launched kernels: {cpu_counts}")
    return {b: r[1] for b, r in runs.items()}, {
        b: r[0]["ms_per_step"] for b, r in runs.items()}


# ---------------------------------------------------------------------------
# Phase 5: where a training step's time goes
# ---------------------------------------------------------------------------

def profile_phase(backend: str, steps: int = 50):
    """Device-busy time per step of the quickstart step (same config,
    ``backend``), from torch.profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import (MetaConfig, TopologyConfig, UpdateConfig,
                                  init_state, make_meta_step)
    from repro_torch.data import MetaBatchPipeline, SineTaskSource
    from repro_torch.models import SineMLP

    cfg = get_config("sine_mlp")
    model = SineMLP(cfg)
    mcfg = MetaConfig(num_agents=K, tasks_per_agent=5, inner_lr=cfg.inner_lr,
                      outer_optimizer="adam", outer_lr=1e-3,
                      update_config=UpdateConfig(strategy="atc",
                                                 backend=backend),
                      topology_config=TopologyConfig(graph="paper"))
    state = init_state(torch.Generator().manual_seed(0), model.init, mcfg,
                       identical_init=True, device=DEVICE)
    step = make_meta_step(model.loss_fn, mcfg, device=DEVICE)
    source = SineTaskSource(K=K, tasks_per_agent=5, shots=10, seed=0)
    with MetaBatchPipeline(source, DEVICE, depth=2) as pipe:
        for _ in range(10):
            state, _ = step(state, *next(pipe))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state, *next(pipe))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        kernels.append((us, evt.count, evt.key))
    busy_us = sum(k[0] for k in kernels)
    top = sorted(kernels, reverse=True)[:6]
    row = dict(
        backend=backend, steps=steps,
        wall_ms_per_step_profiled=1e3 * wall / steps,
        device_busy_ms_per_step=(busy_us / 1e3 / steps) if busy_us
        else "not measured",
        kernel_launches_per_step=sum(k[1] for k in kernels) / steps,
        top_kernels=[dict(name=k[2][:80], ms_per_step=k[0] / 1e3 / steps,
                          launches_per_step=k[1] / steps) for k in top])
    print("profile", json.dumps(row), flush=True)
    return row


# ---------------------------------------------------------------------------
# Phase 6: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_cost(B, H, S, d, itemsize, pairs_per_head, backward, KV=None):
    """(bytes, flops) of one forward or backward: every input read once and
    every output written once, K and V (and dK, dV) with their KV heads
    (H unless given); 4 d flops per allowed (query, key) pair and query
    head in the forward (q.k and p.v), 10 d in the backward (the recomputed
    scores, dP, dV, dK and dQ).  ``pairs_per_head`` counts the pairs the
    mask allows in this run."""
    tile = B * H * S * d * itemsize
    kv_tile = B * (H if KV is None else KV) * S * d * itemsize
    rows = B * H * S * 4                                # one float32 a row
    if backward:   # q, k, v, out, dO and lse in; dq, dk, dv out
        return (4 * tile + 4 * kv_tile + rows,
                10.0 * d * pairs_per_head * B * H)
    return 2 * tile + 2 * kv_tile + rows, 4.0 * d * pairs_per_head * B * H


def library_attention(q, k, v, causal, window, fref, gqa=False):
    """One PyTorch call of the same forward on (B, H, S, d) views: SDPA,
    with the band as a boolean mask where a window is set, and
    ``enable_gqa`` where k/v have fewer heads than q."""
    import torch.nn.functional as F
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa)
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=gqa)


def row_atol(want):
    """The bf16 atol of each element: FLASH_BF16_ROW_ATOL times the largest
    |value| in its row (float32: none beyond FLASH_TOL's)."""
    if want.dtype != torch.bfloat16:
        return 0.0
    return FLASH_BF16_ROW_ATOL * want.detach().float().abs().amax(
        -1, keepdim=True)


def probs(fref, q, k, lse, causal, window):
    """P = exp(S - lse) in float32, (B, H, S, S_k)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.exp(torch.where(mask, logits, fref.NEG_INF)
                     - lse[..., None])


def stored_output_slack(fref, q, k, out, lse, do, causal, window):
    """Per-element bound on how far a backward that reads the *stored*
    output can sit from autograd through ``attention_ref``.  The backward
    kernel (as the Pallas one, and FlashAttention-2) takes D = rowsum(dO*O)
    from ``out`` in the working dtype; autograd uses the float32 output
    before its rounding.  Rounding moves each O by at most u|O| (u = 2^-8
    in bf16, 2^-24 in float32), so |dD| <= u * sum|dO*O|, which reaches dQ
    as scale * dD * sum_j P K_j and dK as scale * sum_i P_ij dD_i q_i; dV
    does not read D.  Returns (dq, dk, dv) slacks."""
    u = 2.0 ** -8 if out.dtype == torch.bfloat16 else 2.0 ** -24
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf = q.float(), k.float()
    p = probs(fref, q, k, lse, causal, window)
    dD = u * (do.float().abs() * out.float().abs()).sum(-1, keepdim=True)
    slack_dq = scale * dD * (p @ kf.abs())
    slack_dk = scale * (p.transpose(-1, -2) @ (dD * qf.abs()))
    return slack_dq, slack_dk, 0.0


def check_flash(fops, fref, gen, B, H, S, d, dtype, causal, window,
                n=10, faults=False):
    q, k, v, do = (torch.randn(B, H, S, d, generator=gen, device=DEVICE
                               ).to(dtype) for _ in range(4))
    kw = dict(causal=causal, window=window)
    out, lse4 = fops.flash_attention_fwd_lse(q, k, v, **kw)
    lse = lse4[..., 0]
    dq, dk, dv = fops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = fref.attention_ref(*leaves, **kw)
    want.backward(do)
    _, want_lse = fref.flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    what = (f"flash B={B} H={H} S={S} d={d} {str(dtype)[6:]} causal={causal}"
            f" window={window}")
    tol = FLASH_TOL[dtype]
    fwd_err = max(compare(out, want, dtype, what + " out", tol["fwd"],
                          row_atol(want)),
                  compare(lse, want_lse, torch.float32, what + " lse",
                          FLASH_TOL[torch.float32]["fwd"]))
    # the kernel against its plain version on the same inputs (both read
    # the stored output), and against autograd through attention_ref
    plain = fref.flash_bwd_ref(q, k, v, out, lse, do, **kw)
    slack = stored_output_slack(fref, q, k, out, lse, do, causal, window)
    bwd_plain_err = max(compare(g, p, dtype, f"{what} d{name} (plain)",
                                tol["bwd"], row_atol(p))
                        for g, p, name in zip((dq, dk, dv), plain, "qkv"))
    bwd_err = max(compare(g, leaf.grad, dtype, f"{what} d{name}",
                          tol["bwd"], sl + row_atol(leaf.grad))
                  for g, leaf, sl, name in zip((dq, dk, dv), leaves, slack,
                                               "qkv"))
    pairs = int(fref.band_mask(S, S, causal, window, q.device).sum())
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    row = dict(B=B, H=H, S=S, d=d, dtype=str(dtype)[6:], causal=causal,
               window=window, fwd_max_abs_err=fwd_err,
               bwd_max_abs_err=bwd_err, bwd_vs_plain_max_abs_err=bwd_plain_err,
               tol=tol)
    lib = library_attention(q, k, v, causal, window, fref)
    row["fwd_ms"] = time_ms(lambda: fops.flash_attention_fwd_lse(q, k, v,
                                                                 **kw), n)
    row["fwd_plain_ms"] = time_ms(lambda: fref.flash_fwd_ref(q, k, v, **kw),
                                  n)
    row["fwd_library_ms"] = time_ms(lib, n)
    row["bwd_ms"] = time_ms(lambda: fops.flash_attention_bwd(
        q, k, v, out, lse, do, **kw), n)
    row["bwd_plain_ms"] = time_ms(lambda: fref.flash_bwd_ref(
        q, k, v, out, lse, do, **kw), n)
    # the library's backward: one torch.autograd.grad through SDPA, timed
    # with its forward, less the forward alone
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_grad = library_attention(lq, lk, lv, causal, window, fref)
    both = time_ms(lambda: torch.autograd.grad(lib_grad(), (lq, lk, lv),
                                               do), n)
    row["bwd_library_ms"] = max(both - row["fwd_library_ms"], 0.0)
    for phase in ("fwd", "bwd"):
        row[f"{phase}_bound_ms"], row[f"{phase}_bound_by"] = bound_ms(
            *flash_cost(B, H, S, d, q.element_size(), pairs,
                        phase == "bwd"), peak)
    print("flash check", json.dumps(row), flush=True)
    if faults:
        planted_faults(fref, q, k, v, out, lse, do, (dq, dk, dv),
                       [leaf.grad for leaf in leaves], slack, causal, window,
                       tol["bwd"])
    return row


def planted_faults(fref, q, k, v, out, lse, do, grads, wants, slack, causal,
                   window, tol, tile=64, what="flash"):
    """Plant faults in the kernel's (dq, dk, dv) (head-first: q, k, v, out
    and do (B, H, S, d); dk and dv may have fewer heads) and require the
    backward's check against autograd (``wants``) to reject each; prints
    how many elements each rule flags, the check's and a fixed atol of
    1e-2's."""
    dq, dk, dv = grads
    S = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = probs(fref, q, k, lse, causal, window)
    dof = do.float()
    v = v.detach().float()
    ds = p * (dof @ v.transpose(-1, -2)
              - (dof * out.float()).sum(-1, keepdim=True)) * scale
    keys = slice(tile, 2 * tile)
    dropped = dq.float() - ds[..., keys] @ k[:, :, keys].float()
    faults = {
        f"dq without key tile {tile}:{2 * tile}": ("q", dropped.to(dq.dtype)),
        f"dq rows {S - tile}:{S} zero": ("q", zero_rows(dq, S - tile, S)),
        f"dk rows {2 * tile}:{3 * tile} zero": ("k",
                                                zero_rows(dk, 2 * tile,
                                                          3 * tile)),
        f"dv rows 0:{tile} zero": ("v", zero_rows(dv, 0, tile)),
    }
    row = {}
    for name, (which, bad) in faults.items():
        i = "qkv".index(which)
        want = wants[i]
        flagged, _ = outside(bad, want, tol, slack[i] + row_atol(want))
        fixed, _ = outside(bad, want, dict(rtol=tol["rtol"], atol=1e-2),
                           slack[i])
        if not flagged:
            raise AssertionError(f"{what}: planted fault '{name}' passes the "
                                 f"backward check")
        row[name] = dict(flagged=flagged, flagged_fixed_atol_1e2=fixed,
                         elements=want.numel())
    print(f"{what} planted faults", json.dumps(row), flush=True)


def zero_rows(x, lo, hi):
    x = x.clone()
    x[:, :, lo:hi] = 0
    return x


def device_kernels(fn) -> list[str]:
    """Names of the kernels (and copies) that one ``fn()`` runs on the
    card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            for _ in range(e.count)]


def profiled_ms(fn, n: int) -> float:
    """Device ms of one ``fn()``: the kernels (and copies) of ``n`` eager
    calls summed by torch.profiler, over ``n``.  For library work that a
    CUDA graph cannot capture."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += getattr(e, "self_cuda_time_total", 0) if t is None else t
    return us / 1e3 / n


def time_cold_ms(fn, n: int, flush: torch.Tensor) -> float:
    """ms of one ``fn()`` whose inputs are not in L2: ``flush`` (larger
    than the 50 MB L2) is written before each call, and the write's own
    time is taken off."""
    both = time_ms(lambda: (flush.fill_(1.0), fn()), n)
    return both - time_ms(lambda: flush.fill_(1.0), n)


def flash_calls_phase(fops) -> dict:
    """The kernels that one call of ``gqa_flash_attention`` runs on the
    card at the serving shape, forward and backward, from torch.profiler;
    fails unless the forward runs its one kernel and the backward its two,
    with no copy, expansion or reduction beside them.  Run before the
    training step's profile (phase 5): torch.profiler sessions after that
    one record none of these kernels."""
    g = FLASH_GQA_MAIN
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    q, do = (torch.randn(g["B"], g["S"], g["H"], g["d"], generator=gen,
                         device=DEVICE).to(g["dtype"]) for _ in "qo")
    k, v = (torch.randn(g["B"], g["S"], g["KV"], g["d"], generator=gen,
                        device=DEVICE).to(g["dtype"]) for _ in "kv")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    kw = dict(causal=g["causal"], window=g["window"])
    torch.autograd.grad(fops.gqa_flash_attention(*leaves, **kw), leaves, do)
    held = {}
    row = {"fwd": device_kernels(lambda: held.setdefault(
               "out", fops.gqa_flash_attention(*leaves, **kw))),
           "bwd": device_kernels(lambda: torch.autograd.grad(
               held["out"], leaves, do))}
    print("flash kernels per call", json.dumps(row), flush=True)
    if len(row["fwd"]) != 1 or len(row["bwd"]) != 2:
        raise AssertionError(
            f"a gqa_flash_attention forward call ran {row['fwd']} and its "
            f"backward {row['bwd']} on the card; expected the forward "
            f"kernel alone and the two backward kernels")
    return row


def check_gqa_flash(fops, fref, gen, B, S, H, KV, d, dtype, causal, window,
                    n=10, serving=False):
    """The model layout, K/V with their KV heads (what the serving path
    calls): the kernels against ``attention_ref`` on K/V expanded to H
    heads and its autograd gradient (which sums each KV head's gradient
    over its query heads), and the backward against its plain version.
    Bounds count the unexpanded K/V; the yardstick is SDPA with
    ``enable_gqa`` on the (B, H, S, d) views.  ``serving``: also the
    planted faults and the times with a cold L2."""
    dev = torch.device(DEVICE)
    q, do = (torch.randn(B, S, H, d, generator=gen, device=dev).to(dtype)
             for _ in "qo")
    k, v = (torch.randn(B, S, KV, d, generator=gen, device=dev).to(dtype)
            for _ in "kv")
    kw = dict(causal=causal, window=window)
    out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, **kw)
    dq, dk, dv = fops.gqa_flash_attention_bwd(q, k, v, out, lse, do, **kw)
    rep = H // KV

    def heads(t, expand=False):          # (B, S, n, d) -> (B, H, S, d)
        return (t.repeat_interleave(rep, 2) if expand else t).transpose(1, 2)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = fref.attention_ref(heads(leaves[0]), heads(leaves[1], True),
                              heads(leaves[2], True), **kw).transpose(1, 2)
    want.backward(do)
    _, want_lse = fref.gqa_flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    what = (f"gqa flash B={B} S={S} H={H} KV={KV} d={d} {str(dtype)[6:]} "
            f"causal={causal} window={window}")
    tol = FLASH_TOL[dtype]
    fwd_err = max(compare(out, want, dtype, what + " out", tol["fwd"],
                          row_atol(want)),
                  compare(lse, want_lse, torch.float32, what + " lse",
                          FLASH_TOL[torch.float32]["fwd"]))
    plain = fref.gqa_flash_bwd_ref(q, k, v, out, lse, do, **kw)
    bwd_plain_err = max(compare(g, p, dtype, f"{what} d{name} (plain)",
                                tol["bwd"], row_atol(p))
                        for g, p, name in zip((dq, dk, dv), plain, "qkv"))
    # the stored output's slack of each expanded head, summed over a KV
    # head's query heads for dk
    sq, sk, _ = stored_output_slack(fref, heads(q), heads(k, True),
                                    heads(out), lse, heads(do), causal,
                                    window)
    slack = (sq.transpose(1, 2),
             sk.reshape(B, KV, rep, S, d).sum(2).transpose(1, 2), 0.0)
    bwd_err = max(compare(g, leaf.grad, dtype, f"{what} d{name}",
                          tol["bwd"], sl + row_atol(leaf.grad))
                  for g, leaf, sl, name in zip((dq, dk, dv), leaves, slack,
                                               "qkv"))
    pairs = int(fref.band_mask(S, S, causal, window, dev).sum())
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    row = dict(B=B, S=S, H=H, KV=KV, d=d, dtype=str(dtype)[6:],
               causal=causal, window=window, fwd_max_abs_err=fwd_err,
               bwd_max_abs_err=bwd_err, bwd_vs_plain_max_abs_err=bwd_plain_err,
               tol=tol)
    lib = library_attention(heads(q), heads(k), heads(v), causal, window,
                            fref, gqa=True)
    fwd = lambda: fops.gqa_flash_attention_fwd_lse(q, k, v, **kw)
    bwd = lambda: fops.gqa_flash_attention_bwd(q, k, v, out, lse, do, **kw)
    row["fwd_ms"] = time_ms(fwd, n)
    row["fwd_plain_ms"] = time_ms(lambda: fref.gqa_flash_fwd_ref(q, k, v,
                                                                **kw), n)
    row["fwd_library_ms"] = time_ms(lib, n)
    row["bwd_ms"] = time_ms(bwd, n)
    row["bwd_plain_ms"] = time_ms(lambda: fref.gqa_flash_bwd_ref(
        q, k, v, out, lse, do, **kw), n)
    # the library's backward with enable_gqa syncs with the legacy stream,
    # which a CUDA graph cannot capture: its kernels' device time instead
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_grad = library_attention(heads(lq), heads(lk), heads(lv), causal,
                                 window, fref, gqa=True)
    both = profiled_ms(lambda: torch.autograd.grad(
        lib_grad(), (lq, lk, lv), heads(do)), n)
    row["bwd_library_ms"] = max(both - profiled_ms(lib, n), 0.0)
    row["bwd_library_timing"] = "torch.profiler device time"
    for phase in ("fwd", "bwd"):
        row[f"{phase}_bound_ms"], row[f"{phase}_bound_by"] = bound_ms(
            *flash_cost(B, H, S, d, q.element_size(), pairs,
                        phase == "bwd", KV=KV), peak)
    if serving:
        flush = torch.empty(FLUSH_BYTES // 4, device=dev)
        row["fwd_cold_ms"] = time_cold_ms(fwd, n, flush)
        row["bwd_cold_ms"] = time_cold_ms(bwd, n, flush)
        del flush
    print("gqa flash check", json.dumps(row), flush=True)
    if serving:
        head_first = [heads(t) for t in (dq, dk, dv)]
        planted_faults(fref, heads(q), heads(k, True), heads(v, True),
                       heads(out), lse, heads(do), head_first,
                       [heads(leaf.grad) for leaf in leaves],
                       [heads(x) if torch.is_tensor(x) else x
                        for x in slack], causal, window, tol["bwd"],
                       what="gqa flash")
    return row


def flash_phase(fops, fref):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for S in (128, 256, 1024):
        for d in (64, 128):
            for causal, window in ((True, None), (False, None), (True, 64)):
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(check_flash(fops, fref, gen, 2, 4, S, d,
                                            dtype, causal, window, n=5))
    m = FLASH_MAIN
    main = check_flash(fops, fref, gen, m["B"], m["H"], m["S"], m["d"],
                       m["dtype"], m["causal"], m["window"], n=20,
                       faults=True)
    g = FLASH_GQA_MAIN
    gqa_rows = [check_gqa_flash(fops, fref, gen, 2, S, g["H"], g["KV"],
                                g["d"], g["dtype"], g["causal"], g["window"],
                                n=5)
                for S in (128, 1024)]
    gqa = check_gqa_flash(fops, fref, gen, g["B"], g["S"], g["H"], g["KV"],
                          g["d"], g["dtype"], g["causal"], g["window"], n=20,
                          serving=True)
    torch.cuda.empty_cache()
    return main, rows, gqa, gqa_rows


# ---------------------------------------------------------------------------
# Phase 9: the SSD scan kernel against its plain version
# ---------------------------------------------------------------------------

def time_events(fn, n: int) -> float:
    """Mean ms of ``fn()`` over ``n`` eager calls between CUDA events, host
    dispatch included (for PyTorch code that launches many kernels)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def ssd_cost(B, L, H, P, N, G, chunk, itemsize) -> tuple[float, float]:
    """(bytes, flops) of one scan: x, B and C read and y written in the
    working dtype, dt read and the state written in float32, A read once;
    per (b, h, chunk) the causal half of the two intra-chunk products
    (C.B^T and M.x over the c(c+1)/2 pairs k <= q: c(c+1)N + c(c+1)P) and
    the entering-state and state-update products (4cPN)."""
    c = chunk
    nbytes = ((2 * B * L * H * P + 2 * B * L * G * N) * itemsize
              + 4 * (B * L * H + H + B * H * P * N))
    flops = ((c * (c + 1) * (N + P) + 4 * c * P * N)
             * B * H * (L // c))
    return nbytes, float(flops)


def ssd_inputs(gen, B, L, H, P, N, G, dtype):
    """tests/test_kernels.py's distributions: x (B,L,H,P), dt = softplus
    (N(0,1)) / 2 rounded to ``dtype`` and read as float32 (as the model
    hands its dt over), A = -exp(N(0,0.3^2)), B and C (B,L,G,N) N(0,0.3^2)."""
    dev = torch.device(DEVICE)
    x = torch.randn(B, L, H, P, generator=gen, device=dev)
    dt = 0.5 * torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=dev))
    Bm, Cm = (0.3 * torch.randn(B, L, G, N, generator=gen, device=dev)
              for _ in "BC")
    return (x.to(dtype), dt.to(dtype).float(), A, Bm.to(dtype),
            Cm.to(dtype))


def ssd_slack(want, dtype):
    """bf16 y: FLASH_BF16_ROW_ATOL times the row's largest |value|."""
    if dtype != torch.bfloat16:
        return 0.0
    return FLASH_BF16_ROW_ATOL * want.abs().amax(-1, keepdim=True)


def check_ssd(sops, sref, layers, gen, B, L, H, P, N, G, chunk, dtype,
              timed=False, faults=False):
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, dtype)
    y, s = sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    rep = H // G
    Bh, Ch = Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2)
    yr, sr = sref.ssd_scan_ref(x, dt, A, Bh, Ch)
    torch.cuda.synchronize()
    what = (f"ssd B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk} "
            f"{str(dtype)[6:]}")
    row = dict(B=B, L=L, H=H, P=P, N=N, G=G, chunk=chunk,
               dtype=str(dtype)[6:],
               y_max_abs_err=compare(y, yr, dtype, what + " y",
                                     SSD_TOL[dtype], ssd_slack(yr, dtype)),
               state_max_abs_err=compare(s, sr, torch.float32,
                                         what + " state",
                                         SSD_TOL[torch.float32]),
               y_max_abs=float(yr.abs().max()), tol=SSD_TOL[dtype])
    if timed:
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
            FP32_FLOP_PER_S
        row["ms"] = time_ms(lambda: sops.ssd_scan_kernel(
            x, dt, A, Bm, Cm, chunk=chunk), 20)
        row["plain_ms"] = time_ms(lambda: sref.ssd_scan_ref(
            x, dt, A, Bh, Ch), 1, reps=3)
        # the port's chunked torch scan (the CPU path's), host dispatch
        # included, and the pairing's backward (its VJP in float32); no
        # single PyTorch call computes the scan (library: none)
        row["chunked_ms"] = time_events(
            lambda: layers.ssd_scan(x, dt, A, Bm, Cm, chunk), 5)
        gy, gs = torch.randn_like(y), torch.randn_like(s)
        row["bwd_compare"] = ssd_bwd_compare(
            sops, layers, (x, dt, A, Bm, Cm, gy, gs), chunk)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound_ms(
            *ssd_cost(B, L, H, P, N, G, chunk, x.element_size()), peak)
    print("ssd check", json.dumps(row), flush=True)
    if faults:
        planted_ssd_faults(sops, (x, dt, A, Bm, Cm), chunk, y, yr, sr,
                           dtype)
    return row


def peak_gb(fn) -> float:
    """What ``fn()`` allocates on the card at its peak on top of what was
    allocated before, in GB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e9


def device_ms(fn) -> float | str:
    """Kernel time of one ``fn()`` on the card, from torch.profiler (the
    host's dispatch left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(evt, "is_user_annotation", False)
                or evt.key == "ssd_scan_chunked_bwd"):
            t = getattr(evt, "self_device_time_total", None)
            us += getattr(evt, "self_cuda_time_total", 0) if t is None else t
    return us / 1e3 if us else "not measured"


def ssd_bwd_compare(sops, layers, inputs, chunk) -> dict:
    """The pairing's backward (the chunked scan's VJP chunk by chunk, one
    chunk's (B, c, c, H) tiles live at a time) against one
    ``torch.func.vjp`` over the whole loop of chunks (every chunk's tiles
    live at once), on the same inputs in one process: time with the host's
    dispatch, kernel time, peak allocation, and the largest gradient
    difference."""
    x, dt, A, Bm, Cm, gy, gs = inputs

    def by_chunk():
        return sops._chunked_vjp(x, dt, A, Bm, Cm, gy, gs, chunk)

    def whole_loop():
        _, vjp_fn = torch.func.vjp(
            lambda *a: layers.ssd_scan(*(t.float() for t in a), chunk),
            x, dt, A, Bm, Cm)
        return vjp_fn((gy.float(), gs.float()))

    row = {name: dict(ms=time_events(fn, 3), device_ms=device_ms(fn),
                      peak_gb=peak_gb(fn))
           for name, fn in (("by_chunk", by_chunk),
                            ("whole_loop", whole_loop))}
    row["max_abs_grad_diff"] = max(
        float((a.float() - b.float()).abs().max())
        for a, b in zip(by_chunk(), whole_loop()))
    return row


def planted_ssd_faults(sops, inputs, chunk, y, yr, sr, dtype):
    """Plant faults in the kernel's outputs and require the check against
    the per-step recurrence to reject each."""
    x, dt, A, Bm, Cm = inputs
    L = x.shape[1]

    def part(lo, hi):
        return sops.ssd_scan_kernel(
            *(t[:, lo:hi].contiguous() for t in (x, dt)), A,
            *(t[:, lo:hi].contiguous() for t in (Bm, Cm)), chunk=chunk)

    zeroed = y.clone()
    zeroed[:, chunk:2 * chunk] = 0
    faults = {
        "state not carried across chunks":
            ("y", torch.cat([part(i, i + chunk)[0]
                             for i in range(0, L, chunk)], 1)),
        f"y rows {chunk}:{2 * chunk} zero": ("y", zeroed),
        "final state of the first chunk": ("state", part(0, chunk)[1]),
    }
    row = {}
    for name, (which, bad) in faults.items():
        if which == "y":
            flagged, _ = outside(bad, yr, SSD_TOL[dtype], ssd_slack(yr, dtype))
        else:
            flagged, _ = outside(bad, sr, SSD_TOL[torch.float32])
        if not flagged:
            raise AssertionError(f"planted fault '{name}' passes the SSD "
                                 f"check ({str(dtype)[6:]})")
        row[name] = dict(flagged=flagged, elements=bad.numel())
    print("ssd planted faults", str(dtype)[6:], json.dumps(row), flush=True)


def ssd_continuity(sops, layers, gen):
    """Two halves: the kernel over the first, the chunked scan (float32)
    from the kernel's state over the second, equal the kernel over the
    whole sequence."""
    B, L, H, P, N, chunk = 2, 512, 4, 64, 128, 128
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, 1, torch.float32)
    y, s = sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    h = L // 2
    first = [t[:, :h].contiguous() for t in (x, dt, Bm, Cm)]
    second = [t[:, h:].contiguous() for t in (x, dt, Bm, Cm)]
    y1, s1 = sops.ssd_scan_kernel(*first[:2], A, *first[2:], chunk=chunk)
    y2, s2 = layers.ssd_scan(*second[:2], A, *second[2:], chunk,
                             init_state=s1)
    torch.cuda.synchronize()
    tol = SSD_TOL[torch.float32]
    row = dict(B=B, L=L, H=H, P=P, N=N, chunk=chunk,
               y_max_abs_err=compare(torch.cat([y1, y2], 1), y,
                                     torch.float32, "ssd two halves y", tol),
               state_max_abs_err=compare(s2, s, torch.float32,
                                         "ssd two halves state", tol))
    print("ssd continuity", json.dumps(row), flush=True)
    return row


def ssd_phase(sops, sref, layers):
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = []
    for L, chunk in ((128, 32), (256, 64), (256, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_ssd(sops, sref, layers, gen, 2, L, 2, 16, 32,
                                  2, chunk, dtype))
    continuity = ssd_continuity(sops, layers, gen)
    m = SSD_MAIN
    main = {str(dtype)[6:]: check_ssd(
        sops, sref, layers, gen, m["B"], m["L"], m["H"], m["P"], m["N"],
        m["G"], m["chunk"], dtype, timed=True, faults=True)
        for dtype in (torch.bfloat16, torch.float32)}
    torch.cuda.empty_cache()
    return main, rows, continuity


def ssd_summary(main, rows, continuity, serve_row) -> dict:
    """The kernels-line entry of the SSD scan: numbers at the serving
    path's shape in bfloat16, launches from the mamba2 serve run."""
    b, m = main["bfloat16"], SSD_MAIN
    return {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
            "replaces": REPLACES["ssd_scan"],
            "launches": serve_row["launches"]["ssd_scan"],
            "max_abs_err": b["y_max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "chunked_ms": b["chunked_ms"],
            "bwd_compare": b["bwd_compare"],
            "shape": f"(B={m['B']}, L={m['L']}, H={m['H']}, P={m['P']}, "
                     f"N={m['N']}, G={m['G']}, chunk={m['chunk']}) bfloat16; "
                     f"launches: kernels launched in the mamba2 serve run's "
                     f"adapt dispatch; library: none (no single PyTorch "
                     f"call); chunked_ms: the port's chunked torch scan",
            "float32": main["float32"], "continuity": continuity,
            "sweep_checks": len(rows),
            "sweep_worst_y_err": max(r["y_max_abs_err"] for r in rows)}


# ---------------------------------------------------------------------------
# Phase 7: the serving path at full width
# ---------------------------------------------------------------------------

def serve_phase(args, counters, expect, replay=("memory",)):
    """Serve through the CLI entry point with ``args``.  ``counters`` maps
    each kernel to its ops module (``launch_counts``); ``expect(layers,
    steps)`` gives every kernel's launches in the one adapt dispatch (0 for
    kernels the model does not run).  ``replay``: for each entry, one more
    dispatch, with the allocator's history recorded ("memory") or under
    torch.profiler ("profile")."""
    from repro_torch.launch import serve

    seen = {"peaks": [], "losses": {}, "check_launches": {}}
    modules = list(dict.fromkeys(counters.values()))

    def counts():
        return {k: n for m in modules for k, n in m.launch_counts.items()}

    def on_round(eng, rnd, ep, adapted, m):
        """Read a round's states while they are alive: finite leaves and
        each user's support loss.  The serving path's peak memory is read
        on entry and the peak is reset on exit, and the kernel launches of
        these reads are kept apart, so neither counts them."""
        seen["peaks"].append(torch.cuda.max_memory_allocated())
        before_reads = counts()
        for i, a in enumerate(adapted):
            bad = [k for k, v in a.items() if not torch.isfinite(v).all()]
            if bad:
                raise AssertionError(f"serve: user {i} has non-finite "
                                     f"adapted leaves {bad[:4]} (round "
                                     f"{rnd})")
        supports = [{k: v[i] for k, v in ep.support.items()}
                    for i in range(len(adapted))]
        if rnd == 0:
            with torch.no_grad():
                before = torch.func.vmap(eng.model.loss_fn,
                                         in_dims=(None, 0))(
                    eng.params, eng._stack(supports, len(supports)))
            seen["before"] = before.float().cpu().numpy()
            seen["supports"] = supports
        seen["losses"][rnd] = eng.adapted_loss(adapted, supports)
        for k, n in counts().items():
            seen["check_launches"][k] = (seen["check_launches"].get(k, 0)
                                         + n - before_reads[k])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(args, on_round=on_round)
    wall = time.perf_counter() - t0
    launches = {k: n - seen["check_launches"].get(k, 0)
                for k, n in counts().items()}
    seen["peaks"].append(torch.cuda.max_memory_allocated())
    eng, ep = out["engine"], out["episode"]
    layers, steps = eng.cfg.num_layers, eng.adapt_steps
    want = {k: 0 for k in launches}
    want.update(expect(layers, steps))
    if launches != want:
        raise AssertionError(f"serve {eng.cfg.name}: launches {launches}, "
                             f"expected {want} (one adapt dispatch of "
                             f"{steps} steps through {layers} layers)")
    rounds = out["rounds"]
    users = len(out["adapted"])
    if [(r["misses"], r["hits"]) for r in rounds] != [(users, 0),
                                                      (0, users)]:
        raise AssertionError(f"serve: rounds {rounds}, expected {users} "
                             f"misses then {users} hits")
    before, after, after_hit = (seen["before"], seen["losses"][0],
                                seen["losses"][1])
    # each user's own adaptation (the miss round) lowers its support loss
    if not (np.isfinite(after).all() and (after < before).all()):
        raise AssertionError(f"serve: support loss did not fall with "
                             f"adaptation: {before} -> {after}")
    # users of one domain share a cache entry (the reference's semantics):
    # a hit returns the state of the domain's last adapted user, which must
    # keep that user's gain
    owners = {int(dom): i for i, dom in enumerate(ep.domains)}
    lost = [i for i in owners.values() if not after_hit[i] < before[i]]
    if lost:
        raise AssertionError(f"serve: cached states of users {lost} lost "
                             f"their adaptation: {before} -> {after_hit}")
    total = eng.prompt_len + eng.gen
    if out["tokens"].shape != (eng.batch, total):
        raise AssertionError(f"serve: tokens {out['tokens'].shape}, "
                             f"expected {(eng.batch, total)}")
    stats = eng.cache.stats()
    del out["adapted"]
    replays = {"memory": dispatch_memory, "profile": dispatch_profile}
    extra = {f"dispatch_{kind}": replays[kind](eng, seen["supports"])
             for kind in replay}
    row = dict(
        arch=eng.cfg.name, layers=layers, dtype=str(eng.dtype)[6:],
        params=int(sum(v.numel() for v in eng.params.values())),
        users=users, seqs_per_user=eng.batch, tokens_per_seq=total,
        adapt_steps=steps, launches=launches,
        adapt_s_miss_round=rounds[0]["seconds"],
        adapt_dispatch_s=rounds[0]["adapt_dispatch_s"],
        compress_s=rounds[0]["compress_s"], svd_s=rounds[0]["svd_s"],
        adapt_s_hit_round=rounds[1]["seconds"],
        prompt_tok_s=out["decode"]["prompt_tok_s"],
        decode_tok_s=out["decode"]["decode_tok_s"],
        prefill_s=out["decode"]["prefill_s"],
        decode_s=out["decode"]["decode_s"],
        domains=[int(x) for x in ep.domains],
        support_loss_before=before.tolist(),
        support_loss_after=after.tolist(),
        support_loss_after_hit=after_hit.tolist(),
        cache=stats, max_memory_allocated_gb=max(seen["peaks"]) / 1e9,
        peak_gb_by_stage=dict(zip(("miss round", "hit round", "decode"),
                                  (x / 1e9 for x in seen["peaks"]))),
        wall_s=wall, **extra)
    print("serve", json.dumps(row), flush=True)
    del out, eng
    torch.cuda.empty_cache()
    return row


def dispatch_profile(eng, supports) -> dict:
    """Device time of one more adapt dispatch of the same users, from
    torch.profiler: all kernels, the SSD scan kernel's forward launches, and
    the chunked-scan backward (its ``record_function`` range, with every
    kernel launched inside it)."""
    from torch.profiler import ProfilerActivity, profile

    stacked = eng._stack(supports, eng._bucket(len(supports)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adapted = eng.harness.adapt_states(eng.params, stacked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del adapted, stacked
    busy = fwd = bwd = 0.0
    fwd_n = bwd_n = 0
    kernels = []
    for evt in prof.key_averages():
        # the range's span on the device timeline is no kernel time
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.key == "ssd_scan_chunked_bwd")
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                not annotation:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            busy += us
            kernels.append((us, evt.count, evt.key))
            if "ssd_scan_kernel" in evt.key:
                fwd, fwd_n = fwd + us, fwd_n + evt.count
        elif evt.key == "ssd_scan_chunked_bwd" and \
                evt.device_type == torch.autograd.DeviceType.CPU:
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = getattr(evt, "cuda_time_total", 0)
            bwd, bwd_n = bwd + us, bwd_n + evt.count
    if not busy:
        return dict(wall_s=wall, device_ms="not measured")
    return dict(wall_s=wall, device_ms=busy / 1e3,
                ssd_kernel_fwd_ms=fwd / 1e3, ssd_kernel_launches=fwd_n,
                chunked_bwd_ms=bwd / 1e3, chunked_bwd_calls=bwd_n,
                ssd_fwd_share=fwd / busy, chunked_bwd_share=bwd / busy,
                device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
                launches=sum(k[1] for k in kernels),
                top_kernels=[dict(name=k[2][:80], ms=k[0] / 1e3,
                                  launches=k[1])
                             for k in sorted(kernels, reverse=True)[:8]])


def dispatch_memory(eng, supports, top=20) -> dict:
    """Where the adapt dispatch's peak device memory goes: one more dispatch
    of the same users on the same launch model, with the allocator's
    history recorded; the blocks live at its peak, summed by the innermost
    ``repro_torch`` line that allocated them."""
    stacked = eng._stack(supports, eng._bucket(len(supports)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=1 << 20)
    try:
        adapted = eng.harness.adapt_states(eng.params, stacked)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del adapted, stacked
    trace = snap["device_traces"][torch.cuda.current_device()]
    at_peak, peak_at = live_at_peak(trace)
    sites: dict[str, int] = {}
    for e in at_peak:
        # blocks the autograd engine allocates (the backward) carry no
        # Python frame: those are told apart by their size
        site = next((f"{f['filename'].split('src/')[-1]}:{f['line']} "
                     f"{f['name']}" for f in e.get("frames", ())
                     if "repro_torch" in f["filename"]),
                    f"(no repro frame) blocks of {e['size'] / 2**20:.2f} "
                    f"MiB")
        sites[site] = sites.get(site, 0) + e["size"]
    ranked = sorted(sites.items(), key=lambda kv: -kv[1])
    return dict(
        peak_gb=peak / 1e9, before_gb=base / 1e9,
        traced_at_peak_gb=sum(e["size"] for e in at_peak) / 1e9,
        events=len(trace), peak_at_event=peak_at,
        top_sites_gb={k: v / 1e9 for k, v in ranked[:top]},
        other_sites_gb=sum(v for _, v in ranked[top:]) / 1e9)


def live_at_peak(trace) -> tuple[list, int]:
    """The ``alloc`` entries of an allocator trace that are live when the
    sum of live traced blocks is largest (blocks allocated before the
    trace started are not in it), and the index of that event."""
    def replay(stop=None):
        live, total, best = {}, 0, (0, -1)
        for i, e in enumerate(trace):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                total += e["size"]
                if total > best[0]:
                    best = (total, i)
            elif e["action"] == "free_requested" and e["addr"] in live:
                total -= live.pop(e["addr"])["size"]
            if i == stop:
                break
        return live, best
    _, (_, peak_at) = replay()
    live, _ = replay(peak_at)
    return list(live.values()), peak_at


# ---------------------------------------------------------------------------
# Phase 8: the card against the CPU on a 2-layer cut of the same config
# ---------------------------------------------------------------------------

def agreement_phase(cfg=None, rtol=None, seq=256, task_batch=2):
    """The card against the CPU on one set of weights and one episode of
    ``task_batch`` sequences of ``seq`` tokens.  ``cfg``: qwen2-1.5b at full
    width cut to 2 layers unless given; ``rtol``: AGREE_RTOL unless given.

    Each card run (kernels) is held against the CPU run (plain versions) in
    its own dtype, on the launch, adapted-support and adapted-query losses.
    The CPU's bf16 run against its f32 run is reported, not gated: bf16
    weights cannot hold most of an inner SGD step of lr 1e-2, so the bf16
    adapted support loss sits above the f32 one on either device."""
    from repro_torch.configs import get_config
    from repro_torch.eval.harness import EvalHarness
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    if cfg is None:
        cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    rtol = AGREE_RTOL if rtol is None else rtol
    model = build_model(cfg)
    harness = EvalHarness(model.loss_fn, cfg.inner_lr, 2)
    weights = model.init(torch.Generator().manual_seed(1), torch.float32,
                         "cpu")
    ep = serve.make_support_source(cfg, seq, task_batch,
                                   seed=0).eval_sample(1, seed=0)
    runs = {"card_f32": (DEVICE, torch.float32),
            "card_bf16": (DEVICE, torch.bfloat16),
            "cpu_f32": ("cpu", torch.float32),
            "cpu_bf16": ("cpu", torch.bfloat16)}
    losses = {}
    for run, (device, dtype) in runs.items():
        t0 = time.perf_counter()
        params = {k: v.to(device, dtype) for k, v in weights.items()}
        sup, qry = ({k: torch.from_numpy(v).to(device)
                     for k, v in part.items()}
                    for part in (ep.support, ep.query))
        adapted = harness.adapt_states(params, sup)
        with torch.no_grad():
            launch = torch.func.vmap(model.loss_fn, in_dims=(None, 0))(
                params, sup)
            losses[run] = dict(
                support_launch=float(launch[0]),
                support_adapted=float(harness.task_loss(adapted, sup)[0]),
                query_adapted=float(harness.task_loss(adapted, qry)[0]),
                seconds=time.perf_counter() - t0)
        del params, adapted
    pairs = {"card_f32": "cpu_f32", "card_bf16": "cpu_bf16",
             "cpu_bf16": "cpu_f32"}
    rel = {f"{run}_vs_{ref}": {
        name: abs(v - losses[ref][name]) / abs(losses[ref][name])
        for name, v in losses[run].items() if name != "seconds"}
        for run, ref in pairs.items()}
    for pair, limit in rtol.items():
        for name, r in rel[pair].items():
            run, ref = pair.split("_vs_")
            if not (math.isfinite(losses[run][name]) and r <= limit):
                raise AssertionError(
                    f"agreement: {name} {run} {losses[run][name]} vs {ref} "
                    f"{losses[ref][name]} (rel {r:.3e} > {limit})")
    for run in runs:
        if not losses[run]["support_adapted"] < losses[run][
                "support_launch"]:
            raise AssertionError(f"agreement: {run} adaptation did not "
                                 f"lower the support loss: {losses[run]}")
    row = dict(arch=cfg.name, layers=cfg.num_layers, seq=seq,
               task_batch=task_batch, losses=losses, rel=rel, rtol=rtol)
    print("agreement", json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return row


def flash_summary(name, main, serve_row, rows, gqa, gqa_rows,
                  calls) -> dict:
    """The kernels-line entry of one flash kernel: numbers of the call the
    serving path makes (the model's layout, KV heads not expanded), the
    expanded (B, H, S, d) call's beside them, launches from the serve
    run."""
    p = "fwd" if name.endswith("fwd") else "bwd"
    g = FLASH_GQA_MAIN
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": REPLACES[name],
            "launches": serve_row["launches"][name],
            **{key: gqa[f"{p}_{key}"] for key in keys},
            "cold_l2_ms": gqa[f"{p}_cold_ms"],
            "kernels_per_call": calls[p],
            "shape": f"(B={g['B']}, S={g['S']}, H={g['H']}, KV={g['KV']}, "
                     f"d={g['d']}) bfloat16 causal, K/V heads not expanded; "
                     f"launches: kernels launched in the serve run's adapt "
                     f"dispatch"
                     + ("" if p == "fwd" else
                        " (two a call: dQ, then dK/dV; ms is both)"),
            "expanded": {"shape": "(B*H=16*12, S=256, d=128) bfloat16 "
                                  "causal, heads expanded",
                         **{key: main[f"{p}_{key}"] for key in keys}},
            "sweep_checks": len(rows) + len(gqa_rows),
            "sweep_worst_err": max(r[f"{p}_max_abs_err"]
                                   for r in rows + gqa_rows)}


def hgmma_phase(path: str) -> dict:
    """What the bf16 flash kernels compiled to: HGMMA (wgmma) instructions
    in each of them, from ``cuobjdump -sass`` of the built library; fails
    unless the forward, dQ and dK/dV kernels all have some."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"hop\d+([a-z_]+)I((?:Li\d+E)+)", m.group(1))
            fn = None
            if k:
                args = re.findall(r"Li(\d+)E", k.group(2))
                fn = f"{k.group(1)}<{','.join(args)}>"
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    print("sass HGMMA instructions per bf16 kernel:", json.dumps(counts),
          flush=True)
    for kind in ("fwd_kernel", "dq_kernel", "dkv_kernel"):
        if not any(v for k, v in counts.items() if k.startswith(kind)):
            raise AssertionError(f"no HGMMA in the bf16 {kind}: {counts}")
    return counts


def build_phase(libraries) -> None:
    """Compile every CUDA source at once (one nvcc each) and load them."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(lib.build)
                   for name, lib in libraries.items()}
        infos = {name: f.result() for name, f in futures.items()}
    for name, info in infos.items():
        print(f"build {name}: {info['seconds']:.2f} s "
              f"(compiled={info['compiled']}) -> {info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import SINE_MLP, get_config
    from repro_torch.core import diffusion, topology
    from repro_torch.kernels.dif_combine import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.launch import quickstart
    from repro_torch.models import SineMLP
    from repro_torch.models import layers

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build_phase({"dif_combine": ops, "flash_attention": fops,
                 "ssd_scan": sops})
    hgmma = hgmma_phase(fops.build()["path"])
    flash_calls = flash_calls_phase(fops)

    paper_A = topology.build_topology("paper", K, "metropolis").matrix
    main_combine, fused_step, n_leaves, large = kernels_phase(
        ops, ref, diffusion, SineMLP, SINE_MLP, paper_A)
    launches, ms_per_step = main_path_phase(quickstart, ops,
                                            len(main_combine), n_leaves)
    # phase 6 before phase 5: after phase 5's profile of the training step,
    # torch.profiler sessions miss some kernel launches
    flash_main, flash_rows, flash_gqa, flash_gqa_rows = flash_phase(fops,
                                                                    fref)
    profile = profile_phase("fused")
    counters = {"flash_attention_fwd": fops, "flash_attention_bwd": fops,
                "ssd_scan": sops}
    # per layer and step: one flash forward launch, and the backward's two
    # (dK/dV and dQ); one SSD scan launch (its backward is the chunked
    # scan's VJP, no kernel)
    serve_row = serve_phase(SERVE_ARGS, counters, lambda n, k: {
        "flash_attention_fwd": n * k, "flash_attention_bwd": 2 * n * k})
    agreement = agreement_phase()
    ssd_main, ssd_rows, continuity = ssd_phase(sops, sref, layers)
    mamba_row = serve_phase(MAMBA_SERVE_ARGS, counters,
                            lambda n, k: {"ssd_scan": n * k},
                            replay=("profile", "memory"))
    mamba_agreement = agreement_phase(
        dataclasses.replace(get_config("mamba2-130m"), num_layers=2),
        MAMBA_AGREE_RTOL, seq=1024, task_batch=4)

    mc = main_combine[0]
    summary = {"kernels": [
        {"name": "dif_combine", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["dif_combine"],
         "launches": launches["pallas"]["dif_combine"],
         "max_abs_err": mc["max_abs_err"], "ms": mc["ms"],
         "plain_ms": mc["plain_ms"], "bound_ms": mc["bound_ms"],
         "bound_by": mc["bound_by"], "library_ms": mc["library_ms"],
         "shape": f"(6, {mc['M']}) float32, one launch per step",
         "large": large["dif_combine"]},
        {"name": "fused_combine_update", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_combine_update"],
         "launches": launches["fused"]["fused_combine_update"],
         "max_abs_err": fused_step["max_abs_err"], "ms": fused_step["ms"],
         "plain_ms": fused_step["plain_ms"],
         "bound_ms": fused_step["bound_ms"],
         "bound_by": fused_step["bound_by"], "library_ms": None,
         "shape": f"{n_leaves} launches per step (one per sine leaf, "
                  f"K=6, adam/atc, float32)",
         "large": [r for r in large["fused_combine_update"]
                   if r["kind"] == "adam" and r["mode"] == "atc"
                   and r["gate"] == 1.0 and r["S"] == 1]},
        *(flash_summary(name, flash_main, serve_row, flash_rows, flash_gqa,
                        flash_gqa_rows, flash_calls)
          for name in ("flash_attention_fwd", "flash_attention_bwd")),
        ssd_summary(ssd_main, ssd_rows, continuity, mamba_row),
    ], "ms_per_step": ms_per_step, "profile": profile, "serve": serve_row,
        "agreement": agreement, "mamba2_serve": mamba_row,
        "mamba2_agreement": mamba_agreement, "flash_hgmma": hgmma,
        "flash_kernels_per_call": flash_calls,
        "seconds": time.perf_counter() - t_start}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
