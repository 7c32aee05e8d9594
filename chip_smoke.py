#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:

1. device    -- a CUDA card must be present; prints its name and power limit.
2. build     -- compiles the CUDA sources of ``kernels/dif_combine/csrc``,
                ``kernels/flash_attention/csrc`` and ``kernels/ssd_scan/csrc``
                (the scan and its backward, two sources) with nvcc for
                sm_90a, all at once, and prints the build
                seconds and, from ``cuobjdump -sass``, the tensor-core
                instructions in each Hopper kernel: HGMMA (wgmma) in the
                bf16 flash forward, dQ and dK/dV kernels, the SSD
                chunk-state and chunk-output kernels and T3's tangent
                chunk-state and chunk-output kernels, HMMA (mma.sync on
                TF32) in the float32 flash forward, dQ and dK/dV kernels and
                T2's two float32 kernels, HMMA (mma.sync on bf16) in the
                SSD backward's and its tangent's state and chunk kernels;
                each must have some.  Then one
                call of ``gqa_flash_attention`` at the serving shape must
                run one kernel forward and two backward, at lm-100m's shape
                one float32 forward its one kernel, one float32 backward its
                two and one float32 T2 its two, one bf16 SSD scan call the
                SSD's three kernels, one bf16 ``ssd_scan_tangent`` call
                T3's three, and one bf16 ``ssd_scan_bwd`` and one
                ``ssd_scan_bwd_tangent`` call their five each, and nothing
                else: no head expansion, copy or
                elementwise kernel beside them (torch.profiler, before any
                other profiling: sessions after phase 5's miss kernels).
3. kernels   -- holds ``dif_combine`` and ``fused_combine_update`` against
                their plain PyTorch versions on the card: over the leaves
                the training step gives them (the sine MLP's 6 leaves, K=6,
                in one launch; the fused kernel across optimizer kind x mix
                mode x schedule length x step, its row and gate derived from
                the step), over the 12 leaves of one qwen2-1.5b decoder layer
                (46.8M parameters an agent) in float32 and bfloat16, and
                through the single-buffer interface at K=6, M=2^24 in both
                dtypes across kind x mode x gate x schedule length.  Each
                check prints its largest error against the stated
                tolerance, its launches, the kernel's time, the plain
                version's, the least time the card could take (bound) and,
                for the single-buffer combine, one PyTorch matmul's time.
                Then one fused outer update is captured in a CUDA graph
                with the step as a device tensor the graph advances and
                replayed for 12 steps (combine_every=2, a 3-row link-failure
                schedule) against eager calls, and copies of the source
                without stores, without the mix and with 1, 3 or 4 ring
                stages are timed at M=2^24 (``kernels/dif_combine/
                ablate.py``).
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
                at S in {128, 1024} in both dtypes, the serving shape, and
                the serving shape in float32 (the 3xTF32 forward and
                backward; their second bound, three TF32 products at 495
                TFLOP/s, printed beside the float32 rate's), and float32
                rows that reach the kernels' other cases untimed: d = 30
                and 32 (element by element where d % 4 != 0), ragged S,
                GQA ratios 1, 2 and 6, and views whose rows are not
                16-byte aligned.  Each check
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
                at full width cut to 8 of its 28 layers (``--layers 8``;
                bfloat16, fresh init from seed 0; 4 users x 4 sequences x
                256 tokens, 2 adapt steps, 2 rounds, 128 prompt + 128
                generated tokens).  The flash launch counters, zeroed just
                before, must show 8 x 2 forward and 2 x 8 x 2 backward
                launches (one adapt dispatch; the
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
                CPU's bf16 losses against its f32 ones are reported.  The
                float32 flash backward is then held at this phase's shape
                (2 x 256, 12 / 2 heads of 128) against autograd and its
                plain version, beside SDPA and both its bounds.
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
                backward (the backward's kernels) and what it allocates at
                its peak, beside the chunked scan's VJP they replaced and
                one VJP over the whole loop of chunks (every chunk's tiles
                live at once) on the same inputs.
                Each of the bf16 route's three kernels (chunk states, state
                passing, chunk outputs) is held against its plain version
                on the grid, a ragged row (chunk 48, P=8, N=16, two groups)
                and the serving shape, where each is timed beside its bound;
                the two-halves check runs in both dtypes; the call's time is
                printed beside its bound, this design's bound and the time
                of the CUDA-core kernel it replaced.  Then the scan's
                backward (``ssd_scan_bwd``, five launches of
                ``csrc/ssd_bwd.cu``) against its three plain passes
                composed, within SSD_BWD_TOL: the grid, a ragged row (chunk
                48, A per sequence), full-width heads, one chunk of 100
                rows and seg falling past 88, in both dtypes, and the
                mamba2 training shape (both dtypes) and serving shape
                (bf16), timed beside the plain version, the chunked VJP it
                replaced and the bound (and each wrapper), with planted
                faults (the state cotangent not carried, dA without a
                chunk's term, dB not summed over a group's heads) that must
                fail; every row's second call must give the same bits.
10. mamba2 serve -- runs ``python -m repro_torch.launch.serve --arch
                mamba2-130m --layers 12 --prompt-len 512 --gen 512`` at
                full width cut to 12 of its 24 layers (bfloat16, fresh init
                from seed 0; 4 users x 4 sequences x 1024 tokens, 2 adapt
                steps, 2 rounds).  The ssd_scan and ssd_scan_bwd call
                counters and each of their kernels' launch counters, zeroed
                just before, must show 12 x 2 (one adapt dispatch); 4
                misses then 4 hits; finite adapted leaves; falling support
                losses; 1024 tokens a sequence.  Prints the serve phase's
                numbers as phase 7 does, the device time of one more
                dispatch split between the forward kernels and the
                backward's kernels by name (torch.profiler), and where its
                peak memory goes.
11. mamba2 agreement -- phase 8 for mamba2-130m cut to 2 layers at full
                width, one episode of 4 x 1024 tokens: float32 within 1e-4
                relative, bfloat16 within 1e-3.
12. tangents -- holds the forward-mode tangent kernels against
                ``torch.func.jvp`` of their plain versions: T1 (flash
                forward tangent) and T2 (flash backward tangent, two
                launches) over phase 6's sweep (B=2, H=4, S in {128, 256,
                1024} x d in {64, 128} x three masks x two dtypes) and the
                qwen2 model layout at the training shape (B=16, S=256,
                H=12, KV=2, d=128, causal), and float32 rows as phase 6's
                (d = 30 and 32, ragged S, GQA ratios 1, 2 and 6, unaligned
                views); T3 (the SSD scan's tangent)
                over phase 9's grid, a ragged row with two groups and A per
                sequence, the mamba2 training shape (8 sequences of 512, A
                per sequence) and the serving shape, with planted faults
                (the tangent state not carried, a chunk's rows zeroed, C'
                dropped) that must fail; bf16 and f32.  Then each of T3's
                three bf16 kernels (tangent chunk states, state passing,
                chunk outputs) against its plain version on the grid, a
                ragged row, one chunk and the training and serving shapes,
                timed at the last two beside its bound and this design's.
                Prints each timed kernel's ms, the plain version's ms and
                the bound, and T3's call beside the CUDA-core kernel it
                replaced.  Then the backward's tangent
                (``ssd_scan_bwd_tangent``, the backward's five kernels on
                dual numbers) over phase 9's backward rows, the same way.
                Runs before phase 5, as phase 6.
13. mamba2 training -- this slice's main path: ``launch.train.main`` in
                this process on mamba2-130m at full width cut to 8 of its
                24 layers (``--layers 8``; bf16, fresh init from seed 0), K=4 agents on the ring,
                exact MAML, ``--fused-outer``, a registered 512-token shape
                with global batch 16 (2 tasks x 1 sequence an agent), 4
                steps in dispatches of 2, eval every 2 steps (4 tasks, 1
                adaptation step), a checkpoint every 2; the launch counters
                are zeroed just before and read just after, and the SSD
                kernels, T3, the scan's backward and its tangent
                (``ssd_scan_bwd``, ``ssd_scan_bwd_tangent``, each of their
                five kernels) and the fused update must have launched; the
                losses are finite, the disagreement falls, the run log
                passes ``scripts/check_run_log.py --expect-fused``.  Then a
                second run from the step-2 checkpoint alone must reach the
                uninterrupted step-4 loss within 1e-3, and one meta-step of
                the final state is profiled (device time split, idle share,
                peak memory, T3 and the backward's tangent launched; the
                SSD backward and its tangent reported by kernel name).
14. qwen2 training -- the same for qwen2-1.5b at full width cut to 2
                layers, ``--combine pallas``, 256 tokens, 2 steps: the
                flash kernels, T1, T2 and ``dif_combine`` must launch.
15. training agreement -- one ``maml`` and one ``fomaml`` meta-gradient of
                each 2-layer cut (one agent, one task of one sequence) on
                the card and on the CPU in the same dtype: the loss within
                phase 8's / 11's limits, the meta-gradient within 1e-3
                (f32) / 5e-2 (bf16) of the CPU's norm, its curvature part
                (maml - fomaml) within 1e-2 / 0.3 and at least half the
                CPU's norm (over all leaves, and per leaf for leaves whose
                CPU norm is at least 1% of the largest).
16. few-shot -- the paper's classification experiment (Fig. 3) through
                ``launch.fewshot.main`` at the full omniglot-cnn config (2
                conv blocks of 32 channels, 11,013 parameters in 6 leaves,
                K=6 on the Fig. 2a graph, 5-way 1-shot, exact MAML, Adam),
                after holding ``dif_combine`` and ``fused_combine_update``
                against their plain versions over the CNN's leaves: 150
                steps of centralized, dif-maml (ATC) and non-coop on
                ``dense``, and of dif-maml on ``pallas`` and ``fused``, each
                run's launch counters zeroed just before and read just
                after (one launch a step), and 5 steps of each strategy on
                the CPU.  Losses finite and falling; pallas and fused within
                1e-4 of dense step by step; each of the card's first 5
                steps within 1e-4 of the CPU's step from the same state
                (loss; params within Adam's largest move, 2 lr), the drift
                of the two devices' own 5-step trajectories printed; each
                test accuracy above 0.5 (chance 0.2), printed beside the
                reference's CPU accuracies.
17. lm-100m -- ``launch.decentralized_lm.main`` at lm-100m's full width
                (12 layers, d_model 512, 8/4 heads of 64, vocab 32768,
                float32, exact MAML, K=4 on the ring, seq 256, global batch
                32, 4 steps), the counters zeroed just before and read just
                after: finite losses, falling disagreement, the float32
                flash kernels and T1/T2 launched in the run and in one
                profiled meta-step (device split, idle share, peak memory);
                the eval report; the float32 flash kernels and T1/T2 at the
                path's attention shape (B=16, S=256, H=8, KV=4, d=64)
                against their plain versions, timed beside their bounds
                (the float32 forward and backward beside SDPA's, their
                three bounds and the CUDA-core kernels they replaced, with
                planted faults and cold-L2 times; T2 beside its three
                bounds and the CUDA-core kernels it replaced, with planted
                faults); the profiled meta-step's forward, T1+T2 and
                backward device times.
18. adapt-then-serve -- ``launch.serve_adapted.main`` with the reference
                example's reduced arguments (reduced qwen2-1.5b trained 2
                steps into a checkpoint under ``build/``, its centroid
                adapted to unseen domains and decoded): the flash kernels
                launched, the serve log accepted by
                ``scripts/check_run_log.py --serve``.
Phases 16-18 run after phase 14, before phase 15.

The last two lines of standard output are the kernels' numbers and the
device, as JSON.  Without a CUDA card the script exits 1 before any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
# The qwen2-1.5b training cut peaks within 9 GB of the card's 80 GB; with
# fixed-size segments the cache can fragment past that (13.5 GB reserved
# and unused when its profiled meta-step ran out of memory), so segments
# grow in place instead.  Set before torch starts its allocator.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12         # H100 SXM, TF32 tensor cores, dense
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
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu"
REPLACES = {"dif_combine": "src/repro/kernels/dif_combine/dif_combine.py:94",
            "fused_combine_update":
                "src/repro/kernels/dif_combine/dif_combine.py:174",
            "flash_attention_fwd":
                "src/repro/kernels/flash_attention/flash_attention.py:84",
            "flash_attention_bwd":
                "src/repro/kernels/flash_attention/flash_bwd.py:107",
            "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:73"}
# The bf16 SSD scan's three kernels (launch-count keys, and the names
# torch.profiler reports them by); each replaces part of the same TPU
# kernel.
SSD_PASSES = {"ssd_chunk_state": "chunk_state_kernel",
              "ssd_state_pass": "state_pass_kernel",
              "ssd_chunk_scan": "chunk_scan_kernel"}
# The SSD scan's forward kernels as torch.profiler names them: the bf16
# passes and the float32 kernel.
SSD_FORWARD_KERNELS = (*SSD_PASSES.values(), "ssd_scan_kernel")
# T3's three bf16 kernels (launch-count keys, and their profiler names): the
# forward's passes with the tangent plane beside each.
T3_PASSES = {"ssd_tangent_state": "tangent_state_kernel",
             "ssd_tangent_pass": "tangent_pass_kernel",
             "ssd_tangent_scan": "tangent_scan_kernel"}
# The scan backward's five kernels (launch-count keys, and the names
# torch.profiler reports them by), and its tangent's.
SSD_BWD_KERNELS = {f"ssd_bwd_{k}": f"sbw::{k}_kernel"
                   for k in ("state", "pass", "chunk", "finish", "reduce")}
SSD_BWD_TANGENT_KERNELS = {
    k.replace("ssd_bwd_", "ssd_bwd_tangent_"): v.replace("sbw::",
                                                         "sbw::tangent_")
    for k, v in SSD_BWD_KERNELS.items()}
# The backward and its tangent against their plain versions (the same
# float32 math), as (rtol, share of the largest |value|): float32 results
# within 1e-4 of the largest |value| (sums in another order); the bf16
# route's dx, dB and dC (rounded to bf16) one bf16 rounding plus 2^-8 of
# the largest |value|, its ddt and dA (float32, hi/lo products keeping 16
# bits of each float32 operand) as float32.  Where seg falls past 88 within
# a chunk, dA within STEEP_DA_REL: it sums the chunk's rows of a
# difference of row and column sums that nearly cancel, and two float32
# orders of it differed by 1.8e-4 of its largest |value| on an H100.
SSD_BWD_TOL = {torch.float32: (0.0, 1e-4),
               torch.bfloat16: (1.6e-2, 2.0 ** -8)}
STEEP_DA_REL = 1e-3
# What the CUDA-core kernel that the bf16 route replaced took for one bf16
# scan at the serving shape on an H100 (PERF.md, row 5 of the kernel
# table), printed beside this run's time.
SSD_SIMT_MS = 2.284
# What the kernels this design replaced took on an H100 (PERF.md, section
# 6): the float32 flash backward on the CUDA cores at lm-100m's attention
# shape (16, 256, 8, 4, 64), both launches, and T3 on the CUDA cores at the
# mamba2 training shape in bf16; printed beside this run's times.
FLASH_F32_BWD_SIMT_MS = 0.404
T3_SIMT_MS = 2.252
# The same for the float32 flash forward (heads expanded by the wrapper)
# and T2 in float32, both at lm-100m's attention shape (PERF.md, section 6).
FLASH_F32_FWD_SIMT_MS = 0.154
T2_F32_SIMT_MS = 0.859
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
# float32 rows of phases 6 and 12 beyond their sweeps, in the model's layout
# (B, S, H, KV, d, causal, window, unaligned): d = 32; ragged S with GQA
# ratios 1, 2 and 6; d = 30 (element by element); rows not 16-byte aligned.
F32_EXTRA = [(2, 200, 4, 4, 32, True, None, False),
             (2, 130, 8, 4, 64, True, 48, False),
             (1, 300, 12, 2, 128, False, None, False),
             (2, 100, 6, 1, 30, True, None, False),
             (1, 160, 4, 2, 64, True, None, True)]
# qwen2-1.5b serves at full width cut to 8 of its 28 layers, to keep the
# script well inside its time limit (PERF.md §4: on an H100 the whole
# script took 886 s with 28 layers, 784 s with 8).
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--layers", "8", "--batch", "4",
              "--prompt-len", "128",
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
# mamba2-130m trains at full width cut to MAMBA_TRAIN_LAYERS of its 24
# layers, and serves cut to MAMBA_SERVE_LAYERS, to keep the script inside its
# time limit with the example twins (phases 16-18) added: on an H100 whose
# host ran the mamba2 step at 4.5-6.4 s, the whole script took 1030 s with
# both at 24 layers (PERF.md, section 6).
MAMBA_TRAIN_LAYERS = 8
MAMBA_SERVE_LAYERS = 12
MAMBA_SERVE_ARGS = ["--arch", "mamba2-130m", "--layers",
                    str(MAMBA_SERVE_LAYERS), "--batch", "4",
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
    around ``want``, largest |got - want|, 0 for no elements: one chunk
    has no entering states)."""
    err = (got.detach().float() - want.detach().float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.detach().float().abs() + slack
    return int((err > limit).sum()), float(err.max()) if err.numel() else 0.0


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


def fused_inputs(gen, kind, S, K, M, dtype):
    """Random (table, scale, w, g, *moments) on the card."""
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
    return [table, scale] + bufs


def counted(ops, name, fn, what=None):
    """``fn()`` and the launches of kernel ``name`` it made; with ``what``,
    raises unless that is one."""
    before = ops.launch_counts[name]
    out = fn()
    launches = ops.launch_counts[name] - before
    if what is not None and launches != 1:
        raise AssertionError(f"{what}: {launches} launches, expected 1")
    return out, launches


def check_fused(ops, ref, gen, kind, mode, gate, S, M, dtype, timed=False):
    """The single-buffer interface (the TPU kernel's) over one (K, M)."""
    table, scale, *bufs = fused_inputs(gen, kind, S, K, M, dtype)
    sel = torch.tensor([[S - 1]], dtype=torch.int32, device=DEVICE)
    ctl = torch.tensor([[gate, 1 - 0.9 ** 3, 1 - 0.999 ** 3]],
                       device=DEVICE)
    hyper = dict(mode=mode, kind=kind, lr=1e-3,
                 weight_decay=0.01 if kind == "adam" else 0.0)
    args = (table, sel, ctl, scale, *bufs)
    got, launches = counted(ops, "fused_combine_update",
                            lambda: ops.fused_combine_update(*args, **hyper),
                            f"fused {kind}/{mode} {dtype} M={M}")
    want = ref.fused_update_ref(*args, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("w", "mu", "nu"), got, want):
        if b is None:
            continue
        what = f"fused {kind}/{mode} gate={gate} S={S} {dtype} M={M} {name}"
        err = max(err, compare(a, b, a.dtype, what))
    row = dict(kind=kind, mode=mode, gate=gate, S=S, M=M,
               dtype=str(dtype).split(".")[-1], launches=launches,
               max_abs_err=err, tol=TOL[dtype])
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


def check_combine(ops, ref, A, phi):
    """The single-buffer interface (the TPU kernel's) over one (K, M)."""
    out, launches = counted(ops, "dif_combine",
                            lambda: ops.dif_combine(A, phi),
                            f"dif_combine {phi.dtype} M={phi.shape[1]}")
    want = ref.dif_combine_ref(A, phi)
    torch.cuda.synchronize()
    M = phi.shape[1]
    what = f"dif_combine {phi.dtype} M={M}"
    row = dict(M=M, dtype=str(phi.dtype).split(".")[-1], launches=launches,
               max_abs_err=compare(out, want, phi.dtype, what),
               tol=TOL[phi.dtype])
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


def columns(leaves) -> int:
    """Elements per agent over a leaf dict."""
    return sum(x.numel() // x.shape[0] for x in leaves.values())


def check_combine_leaves(ops, ref, A, leaves, what):
    """The grouped combine over a leaf dict of one dtype against its plain
    version: one launch, every leaf within TOL; time, plain time, bound."""
    got, launches = counted(ops, "dif_combine",
                            lambda: ops.dif_combine_leaves(A, leaves), what)
    want = ref.dif_combine_leaves_ref(A, leaves)
    torch.cuda.synchronize()
    dtype = next(iter(leaves.values())).dtype
    err = max(compare(got[k], want[k], dtype, f"{what} {k}") for k in leaves)
    n = 3 if columns(leaves) * K >= LARGE_M else 50
    row = dict(what=what, leaves=len(leaves), columns=columns(leaves),
               dtype=str(dtype).split(".")[-1], launches=launches,
               max_abs_err=err, tol=TOL[dtype],
               ms=time_ms(lambda: ops.dif_combine_leaves(A, leaves), n),
               plain_ms=time_ms(
                   lambda: ref.dif_combine_leaves_ref(A, leaves), n))
    row["bound_ms"], row["bound_by"] = bound_ms(
        *combine_cost(K, columns(leaves), dtype.itemsize))
    print("check", json.dumps(row), flush=True)
    return row


def leaf_inputs(gen, kind, shapes, dtype):
    """Random params, grads and moments over leaves of ``shapes`` (each
    with the agent axis K first) on the card."""
    dev = torch.device(DEVICE)
    rand = lambda s, f=torch.randn: f(s, generator=gen, device=dev)
    params = {k: rand(s).to(dtype) for k, s in shapes.items()}
    grads = {k: rand(s).to(dtype) for k, s in shapes.items()}
    mu = nu = None
    if kind == "adam":
        mu = {k: 0.1 * rand(s) for k, s in shapes.items()}
        nu = {k: 0.01 * rand(s, torch.rand) for k, s in shapes.items()}
    elif kind == "momentum":
        mu = {k: rand(s).to(dtype) for k, s in shapes.items()}
    return params, grads, mu, nu


def check_fused_leaves(ops, ref, gen, table, shapes, dtype, what, *, kind,
                       mode, step, every=1, timed=False):
    """The grouped fused update over leaves of ``shapes`` in one dtype
    against its plain version: the row, gate and bias corrections derived
    from ``step`` (a host int, as the trainer passes it), one launch; with
    ``timed``, its time, the plain version's and the bound."""
    params, grads, mu, nu = leaf_inputs(gen, kind, shapes, dtype)
    scale = torch.rand(K, 1, generator=gen, device=DEVICE)
    count = torch.tensor(2, dtype=torch.int32, device=DEVICE)
    hyper = dict(mode=mode, kind=kind, lr=1e-3, step=step, every=every,
                 count=count if kind == "adam" else None,
                 weight_decay=0.01 if kind == "adam" else 0.0)
    args = (table, scale, params, grads, mu, nu)
    got, launches = counted(
        ops, "fused_combine_update",
        lambda: ops.fused_combine_update_leaves(*args, **hyper), what)
    want = ref.fused_update_leaves_ref(*args, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for tree, g, w in zip(("w", "mu", "nu"), got, want):
        if w is None:
            continue
        for k in w:
            err = max(err, compare(g[k], w[k], g[k].dtype,
                                   f"{what} {kind}/{mode} step={step} "
                                   f"{tree}[{k}]"))
    row = dict(what=what, kind=kind, mode=mode, step=step, every=every,
               S=table.shape[0], leaves=len(shapes),
               columns=columns(params), dtype=str(dtype).split(".")[-1],
               launches=launches, max_abs_err=err, tol=TOL[dtype])
    if timed:
        n = 3 if columns(params) * K >= LARGE_M else 50
        row["ms"] = time_ms(
            lambda: ops.fused_combine_update_leaves(*args, **hyper), n)
        row["plain_ms"] = time_ms(
            lambda: ref.fused_update_leaves_ref(*args, **hyper), n)
        row["bound_ms"], row["bound_by"] = bound_ms(*fused_cost(
            kind, mode, K, columns(params), dtype.itemsize))
    print("check", json.dumps(row), flush=True)
    return row


def qwen2_layer_shapes() -> dict:
    """The 12 leaves of one qwen2-1.5b decoder layer with the agent axis."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    specs = transformer.block_specs(get_config("qwen2-1.5b"),
                                    transformer.BlockDesc("attn", "dense"))
    out = {}
    for part, leaves in specs.items():
        for name, spec in leaves.items():
            out[f"{part}.{name}"] = (K,) + tuple(spec.shape)
    return out


def capture_row(ops, SineMLP, SINE_MLP, steps=12):
    """One fused outer update (Adam, ATC, combine_every=2, a 3-row
    link-failure schedule over the paper graph, clip 1.0) captured in a
    CUDA graph with the step as a device tensor that the graph advances,
    replayed ``steps`` times against as many eager calls with the host
    step: params and moments equal at TOL[float32]."""
    from repro_torch.core import fused, topology, update
    from repro_torch.optim import get_optimizer

    gen = torch.Generator().manual_seed(7)
    schedule = topology.make_schedule(
        "link_failure", topology.build_topology("paper", K, "metropolis"),
        p=0.2, period=3, seed=0).stacked()
    opt = get_optimizer("adam", 1e-3)
    outer = fused.make_fused_outer(opt, "atc", update.CommSchedule(2),
                                   schedule, grad_clip=1.0, num_agents=K,
                                   device=DEVICE)
    init = SineMLP(SINE_MLP).init(gen, device=DEVICE)
    params = {k: x.unsqueeze(0).expand((K,) + x.shape).clone()
              for k, x in init.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    eager_p, eager_s = dict(params), opt.init(params)
    graph_p = {k: p.clone() for k, p in params.items()}
    graph_s = opt.init(graph_p)
    step = torch.zeros((), dtype=torch.int64, device=DEVICE)
    replay = fused.capture_outer(outer, graph_p, grads, graph_s, step)
    before = ops.launch_counts["fused_combine_update"]
    eager_s_total = replay_total = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        for g in grads.values():
            g.copy_(torch.randn(g.shape, generator=gen).to(DEVICE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_p, eager_s = outer(eager_p, grads, eager_s, i)
        torch.cuda.synchronize()
        eager_s_total += time.perf_counter() - t0
        start.record()
        replay()
        end.record()
        end.synchronize()
        replay_total += start.elapsed_time(end)
    if int(step) != steps:
        raise AssertionError(f"capture: the graph's step is {int(step)}, "
                             f"expected {steps}")
    err = 0.0
    for k in params:
        err = max(err, compare(graph_p[k], eager_p[k], torch.float32,
                               f"capture params[{k}]"))
    for a, b in zip(fused._tensors(graph_s), fused._tensors(eager_s)):
        err = max(err, compare(a, b, torch.float32, "capture moments"))
    row = dict(steps=steps, every=2, S=schedule.shape[0], max_abs_err=err,
               tol=TOL[torch.float32],
               eager_launches=ops.launch_counts["fused_combine_update"]
               - before,
               eager_ms_host_clock=1e3 * eager_s_total / steps,
               replay_ms=replay_total / steps)
    print("capture", json.dumps(row), flush=True)
    return row


def kernels_phase(ops, ref, SineMLP, SINE_MLP, paper_A):
    from repro_torch.kernels.dif_combine import ablate

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    A = torch.as_tensor(paper_A, dtype=torch.float32, device=DEVICE)
    table = A[None].contiguous()
    # --- main-path shapes: the sine MLP's leaves with the agent axis -----
    sine = {name: (K,) + spec.shape
            for name, spec in SineMLP(SINE_MLP).specs().items()}
    phi = {n: torch.randn(s, generator=gen, device=DEVICE)
           for n, s in sine.items()}
    main_combine = check_combine_leaves(ops, ref, A, phi,
                                        "pallas main-path step")
    for kind in ops.KINDS:
        for mode in ops.MODES:
            for S in (1, 4):
                tab = fused_inputs(gen, kind, S, K, 1, torch.float32)[0]
                for step in (0, 1, 4 * S + 1):   # gate 0, 1, 1 (every=2)
                    check_fused_leaves(ops, ref, gen, tab, sine,
                                       torch.float32, "sine leaves",
                                       kind=kind, mode=mode, step=step,
                                       every=2)
    # one training step's launch: Adam, ATC, the static paper graph (S=1),
    # the host step as the trainer passes it
    fused_step = check_fused_leaves(ops, ref, gen, table, sine,
                                    torch.float32, "fused main-path step",
                                    kind="adam", mode="atc", step=7,
                                    timed=True)

    # --- one qwen2-1.5b decoder layer: 12 ragged leaves, 46.8M a agent ---
    layer = qwen2_layer_shapes()
    qwen2 = {"dif_combine": [], "fused_combine_update": []}
    for dtype in (torch.float32, torch.bfloat16):
        phi = {n: torch.randn(s, generator=gen, device=DEVICE).to(dtype)
               for n, s in layer.items()}
        qwen2["dif_combine"].append(check_combine_leaves(
            ops, ref, A, phi, "qwen2-1.5b layer"))
        del phi
        qwen2["fused_combine_update"].append(check_fused_leaves(
            ops, ref, gen, table, layer, dtype, "qwen2-1.5b layer",
            kind="adam", mode="atc", step=7, timed=True))
        torch.cuda.empty_cache()

    # --- large: K=6, M=2^24, the single-buffer interface -------------------
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
    capture = capture_row(ops, SineMLP, SINE_MLP)
    ablation = ablate.run()
    print("ablation", json.dumps(ablation), flush=True)
    return dict(main_combine=main_combine, fused_step=fused_step,
                qwen2=qwen2, large=large, capture=capture,
                ablation=ablation)


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


def main_path_phase(quickstart, ops, n_groups):
    """The quickstart with each backend; ``n_groups`` is the sine MLP's
    dtype groups, each one launch a step of the combine (``pallas``) or of
    the fused update (``fused``)."""
    runs = {}
    for backend in ("dense", "pallas", "fused"):
        runs[backend] = run_quickstart(quickstart, ops, backend, STEPS)
    cpu, cpu_counts = run_quickstart(quickstart, ops, "dense", 5, "cpu")
    expect = {"dense": {"dif_combine": 0, "fused_combine_update": 0},
              "pallas": {"dif_combine": STEPS * n_groups,
                         "fused_combine_update": 0},
              "fused": {"dif_combine": 0,
                        "fused_combine_update": STEPS * n_groups}}
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


def tf32_bound(row, phase, cost) -> None:
    """A float32 row's second bound of ``phase`` ("fwd" or "bwd"), this
    design's: its products as three TF32 products at the TF32 tensor rate,
    or its bytes, whichever is larger (``{phase}_bound_ms`` stays the
    float32 rate's); and its bytes alone over the memory rate."""
    if row["dtype"] == "float32":
        nbytes, flops = cost
        row[f"{phase}_tf32_bound_ms"], row[f"{phase}_tf32_bound_by"] = \
            bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
        row[f"{phase}_bytes_bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S


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


def randn_view(gen, shape, dtype, unaligned=False):
    """A random tensor of ``shape`` on the card; ``unaligned``: a view of
    the first d columns of one with d + 1, whose rows are not 16-byte
    aligned (the kernels then read it element by element)."""
    if not unaligned:
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    wide = torch.randn(*shape[:-1], shape[-1] + 1, generator=gen,
                       device=DEVICE).to(dtype)
    return wide[..., :shape[-1]]


def check_flash(fops, fref, gen, B, H, S, d, dtype, causal, window,
                n=10, faults=False, timed=True, unaligned=False):
    """The heads-first (B, H, S, d) kernels against ``attention_ref``, its
    autograd gradient and the plain backward; ``timed``: also the kernels',
    plain versions' and SDPA's times and the bounds."""
    q, k, v, do = (randn_view(gen, (B, H, S, d), dtype, unaligned)
                   for _ in range(4))
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
            f" window={window}" + (" unaligned" if unaligned else ""))
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
               window=window, unaligned=unaligned, fwd_max_abs_err=fwd_err,
               bwd_max_abs_err=bwd_err, bwd_vs_plain_max_abs_err=bwd_plain_err,
               tol=tol)
    if not timed:
        print("flash check", json.dumps(row), flush=True)
        return row
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
    for phase in ("fwd", "bwd"):
        tf32_bound(row, phase, flash_cost(B, H, S, d, q.element_size(), pairs,
                                          phase == "bwd"))
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


def zero_seq(x, heads_dim, lo, hi):
    """``x`` with sequence rows [lo, hi) zeroed, in either layout."""
    return zero_rows(x, lo, hi) if heads_dim == 1 else \
        zero_rows(x.transpose(1, 2), lo, hi).transpose(1, 2)


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
    card at the serving shape, forward and backward, and one float32
    forward, backward and T2 call at lm-100m's shape, from torch.profiler;
    fails unless each forward runs its one kernel and each backward and T2
    its two, with no copy, expansion or reduction beside them.  Run before the
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
    # the float32 backward at lm-100m's shape: its two kernels and nothing
    # else (no head expansion, copy, D or per-KV-head sum beside them)
    f = LM100M_FLASH
    q32, do32 = (torch.randn(f["B"], f["S"], f["H"], f["d"], generator=gen,
                             device=DEVICE) for _ in "qo")
    k32, v32 = (torch.randn(f["B"], f["S"], f["KV"], f["d"], generator=gen,
                            device=DEVICE) for _ in "kv")
    fwd32 = lambda: fops.gqa_flash_attention_fwd_lse(q32, k32, v32)
    out32, lse32 = fwd32()
    bwd32 = lambda: fops.gqa_flash_attention_bwd(q32, k32, v32, out32,
                                                 lse32, do32)
    bwd32()
    # T2 in float32: its two kernels (no D, copy or per-KV-head sum beside)
    tq, tdo = (torch.randn_like(q32) for _ in "qo")
    tk, tv = (torch.randn_like(k32) for _ in "kv")
    to, tlse = fops.flash_attention_fwd_tangent(q32, k32, v32, lse32, tq, tk,
                                                tv, heads_dim=2)
    t2 = lambda: fops.flash_attention_bwd_tangent(
        q32, k32, v32, out32, lse32, do32, tq, tk, tv, to, tlse, tdo,
        heads_dim=2)
    t2()
    row["fwd_float32"] = device_kernels(fwd32)
    row["bwd_float32"] = device_kernels(bwd32)
    row["bwd_tangent_float32"] = device_kernels(t2)
    print("flash kernels per call", json.dumps(row), flush=True)
    if len(row["fwd"]) != 1 or len(row["bwd"]) != 2:
        raise AssertionError(
            f"a gqa_flash_attention forward call ran {row['fwd']} and its "
            f"backward {row['bwd']} on the card; expected the forward "
            f"kernel alone and the two backward kernels")
    for key, call, n, part in (
            ("fwd_float32", "gqa_flash_attention_fwd_lse", 1, "fwd_kernel"),
            ("bwd_float32", "gqa_flash_attention_bwd", 2, "d"),
            ("bwd_tangent_float32", "flash_attention_bwd_tangent", 2,
             "tangent_d")):
        names = row[key]
        if len(names) != n or not all("tf32::" + part in x for x in names):
            raise AssertionError(
                f"a float32 {call} call ran {names} on the card; expected "
                f"its {n} tf32 kernel(s) and nothing else")
    return row


def check_gqa_flash(fops, fref, gen, B, S, H, KV, d, dtype, causal, window,
                    n=10, serving=False, timed=True, unaligned=False):
    """The model layout, K/V with their KV heads (what the serving path
    calls): the kernels against ``attention_ref`` on K/V expanded to H
    heads and its autograd gradient (which sums each KV head's gradient
    over its query heads), and the backward against its plain version.
    The autograd reference runs on float32 copies of the inputs and rounds
    its results once to the dtype: on bf16 leaves the backward of the
    expansion would round each query head's dK/dV to bf16 before their
    sum, as the kernel (float32 sums, one rounding) does not.
    Bounds count the unexpanded K/V; the yardstick is SDPA with
    ``enable_gqa`` on the (B, H, S, d) views.  ``serving``: also the
    planted faults and the times with a cold L2.  ``timed=False``: the
    checks alone; ``unaligned``: views whose rows are not 16-byte
    aligned."""
    dev = torch.device(DEVICE)
    q, do = (randn_view(gen, (B, S, H, d), dtype, unaligned) for _ in "qo")
    k, v = (randn_view(gen, (B, S, KV, d), dtype, unaligned) for _ in "kv")
    kw = dict(causal=causal, window=window)
    out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, **kw)
    dq, dk, dv = fops.gqa_flash_attention_bwd(q, k, v, out, lse, do, **kw)
    rep = H // KV

    def heads(t, expand=False):          # (B, S, n, d) -> (B, H, S, d)
        return (t.repeat_interleave(rep, 2) if expand else t).transpose(1, 2)

    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = fref.attention_ref(heads(leaves[0]), heads(leaves[1], True),
                              heads(leaves[2], True), **kw).transpose(1, 2)
    want.backward(do.float())
    want = want.detach().to(dtype)
    grads = [leaf.grad.to(dtype) for leaf in leaves]
    _, want_lse = fref.gqa_flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    what = (f"gqa flash B={B} S={S} H={H} KV={KV} d={d} {str(dtype)[6:]} "
            f"causal={causal} window={window}"
            + (" unaligned" if unaligned else ""))
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
    bwd_err = max(compare(g, want_g, dtype, f"{what} d{name}",
                          tol["bwd"], sl + row_atol(want_g))
                  for g, want_g, sl, name in zip((dq, dk, dv), grads, slack,
                                                 "qkv"))
    pairs = int(fref.band_mask(S, S, causal, window, dev).sum())
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    row = dict(B=B, S=S, H=H, KV=KV, d=d, dtype=str(dtype)[6:],
               causal=causal, window=window, unaligned=unaligned,
               fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
               bwd_vs_plain_max_abs_err=bwd_plain_err, tol=tol)
    if not timed:
        print("gqa flash check", json.dumps(row), flush=True)
        return row
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
    for phase in ("fwd", "bwd"):
        tf32_bound(row, phase, flash_cost(B, H, S, d, q.element_size(), pairs,
                                          phase == "bwd", KV=KV))
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
                       [heads(g) for g in grads],
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
    # the model's layout in both dtypes (float32: the 3xTF32 backward), then
    # the serving shape, and qwen2-1.5b's shape in float32 with SDPA beside it
    g = FLASH_GQA_MAIN
    gqa_rows = [check_gqa_flash(fops, fref, gen, 2, S, g["H"], g["KV"],
                                g["d"], dtype, g["causal"], g["window"], n=5)
                for S in (128, 1024)
                for dtype in (g["dtype"], torch.float32)]
    gqa = check_gqa_flash(fops, fref, gen, g["B"], g["S"], g["H"], g["KV"],
                          g["d"], g["dtype"], g["causal"], g["window"], n=20,
                          serving=True)
    gqa["float32"] = check_gqa_flash(fops, fref, gen, g["B"], g["S"],
                                     g["H"], g["KV"], g["d"], torch.float32,
                                     g["causal"], g["window"], n=10)
    print_f32("qwen2-1.5b f32", gqa["float32"])
    # the float32 kernels' other cases, untimed: d = 32 and 30 (d % 4 != 0:
    # element by element), S not a multiple of 64, GQA ratios 1, 2 and 6,
    # and views whose rows are not 16-byte aligned
    rows += [check_flash(fops, fref, gen, 2, 4, 200, 32, torch.float32,
                         True, None, timed=False),
             check_flash(fops, fref, gen, 1, 2, 200, 64, torch.float32,
                         False, 48, timed=False, unaligned=True)]
    gqa_rows += [check_gqa_flash(fops, fref, gen, B, S, H, KV, d,
                                 torch.float32, causal, window, timed=False,
                                 unaligned=un)
                 for B, S, H, KV, d, causal, window, un in F32_EXTRA]
    torch.cuda.empty_cache()
    return main, rows, gqa, gqa_rows


def print_f32(what, row) -> None:
    """Two lines: the float32 forward's and backward's times beside SDPA's,
    their three bounds and the CUDA-core kernels they replaced."""
    for p, name, launches, simt in (
            ("fwd", "forward", "its one launch", FLASH_F32_FWD_SIMT_MS),
            ("bwd", "backward", "both launches", FLASH_F32_BWD_SIMT_MS)):
        print(f"{what} flash {name} (3xTF32): {row[f'{p}_ms']:.4f} ms for "
              f"{launches}; SDPA's {name} {row[f'{p}_library_ms']:.4f} ms; "
              f"bounds {row[f'{p}_bound_ms']:.4f} ms (float32 rate, "
              f"{row[f'{p}_bound_by']}), {row[f'{p}_tf32_bound_ms']:.4f} ms "
              f"(three TF32 products, {row[f'{p}_tf32_bound_by']}) and "
              f"{row[f'{p}_bytes_bound_ms']:.4f} ms (bytes); the CUDA-core "
              f"kernels it replaced {simt} ms at lm-100m's shape (PERF.md)",
              flush=True)


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
    per (b, chunk) the causal half of C.B^T once per B/C group (c(c+1)N
    over the c(c+1)/2 pairs k <= q: a group's heads share it), and per head
    the causal half of M.x (c(c+1)P) and the entering-state and
    state-update products (4cPN): the least work these inputs need."""
    c = chunk
    nbytes = ((2 * B * L * H * P + 2 * B * L * G * N) * itemsize
              + 4 * (B * L * H + H + B * H * P * N))
    flops = ((c * (c + 1) * N * G + (c * (c + 1) * P + 4 * c * P * N) * H)
             * B * (L // c))
    return nbytes, float(flops)


def ssd_pass_costs(B, L, H, P, N, G, chunk) -> dict:
    """(bytes, flops, peak rate) of each bf16 pass: its inputs read once
    and its outputs written once, the products' flops on these inputs.
    Chunk states: x, dt, A, B in, S and seg out; 2cPN a (b, h, chunk).
    State passing: S and each chunk's last seg in, the entering states'
    hi/lo planes (chunks 1 ..) and the final state out; 2PN a (b, h, chunk)
    on the CUDA cores.  Chunk outputs: x, dt, seg, B, C and the planes in,
    y out; C.B^T once per group, M.x, and 2cPN a (b, h, chunk) for the
    entering state of chunks 1 ..."""
    c, nc = chunk, L // chunk
    x, bc = 2 * B * L * H * P, 2 * B * L * G * N
    dt = seg = 4 * B * L * H
    S, state = 4 * B * nc * H * P * N, 4 * B * H * P * N
    planes = 2 * 2 * B * (nc - 1) * H * P * N
    return {
        "ssd_chunk_state": (x + dt + 4 * B * H + bc + S + seg,
                            2.0 * c * P * N * B * H * nc, BF16_FLOP_PER_S),
        "ssd_state_pass": (S + 4 * B * H * nc + planes + state,
                           2.0 * P * N * B * H * nc, FP32_FLOP_PER_S),
        "ssd_chunk_scan": (2 * x + dt + seg + 2 * bc + planes,
                           float((c * (c + 1) * N * G
                                  + c * (c + 1) * P * H) * B * nc
                                 + 2 * c * P * N * H * B * (nc - 1)),
                           BF16_FLOP_PER_S)}


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


def check_ssd_passes(sops, sref, gen, B, L, H, P, N, G, chunk,
                     timed=False) -> dict:
    """Each bf16 pass's kernel against its plain version on the same inputs
    (the kernel's own outputs of the pass before): the chunk states (S,
    seg) against ``chunk_state_ref``, the state passing (hi + lo, the final
    state) against ``state_pass_ref``, the chunk outputs against
    ``chunk_scan_ref`` of hi + lo.  Float32 results within
    SSD_TOL[float32] (the hi/lo halves keep 16 bits of each float32
    operand); y within SSD_TOL[bfloat16] and the row slack.  Timed: each
    kernel's ms, its plain version's and its bound."""
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, torch.bfloat16)
    f32 = SSD_TOL[torch.float32]
    S, seg = sops.ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    hi, lo, state = sops.ssd_state_pass(S, seg, chunk=chunk)
    y = sops.ssd_chunk_scan(x, dt, seg, Bm, Cm, hi, lo, chunk=chunk)
    entering = hi.float() + lo.float()
    plain = {
        "ssd_chunk_state": lambda: sref.chunk_state_ref(x, dt, A, Bm, chunk),
        "ssd_state_pass": lambda: sref.state_pass_ref(S, seg, chunk),
        "ssd_chunk_scan": lambda: sref.chunk_scan_ref(
            x, dt, seg, Bm, Cm, entering, chunk)}
    Sr, segr = plain["ssd_chunk_state"]()
    er, sr = plain["ssd_state_pass"]()
    yr = plain["ssd_chunk_scan"]()
    torch.cuda.synchronize()
    what = f"ssd passes B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk}"
    errs = {"ssd_chunk_state": max(
                compare(S, Sr, torch.float32, what + " S", f32),
                compare(seg, segr, torch.float32, what + " seg", f32)),
            "ssd_state_pass": max(
                compare(entering, er, torch.float32, what + " s_in", f32),
                compare(state, sr, torch.float32, what + " state", f32)),
            "ssd_chunk_scan": compare(
                y, yr, torch.bfloat16, what + " y", SSD_TOL[torch.bfloat16],
                ssd_slack(yr.float(), torch.bfloat16))}
    row = {k: {"max_abs_err": v} for k, v in errs.items()}
    if timed:
        kernel = {
            "ssd_chunk_state": lambda: sops.ssd_chunk_state(
                x, dt, A, Bm, chunk=chunk),
            "ssd_state_pass": lambda: sops.ssd_state_pass(S, seg,
                                                          chunk=chunk),
            "ssd_chunk_scan": lambda: sops.ssd_chunk_scan(
                x, dt, seg, Bm, Cm, hi, lo, chunk=chunk)}
        for name, (nbytes, flops, peak) in ssd_pass_costs(
                B, L, H, P, N, G, chunk).items():
            row[name].update(
                ms=time_ms(kernel[name], 20),
                plain_ms=time_ms(plain[name], 1, reps=3),
                library_ms=None, bytes=nbytes, flops=flops)
            row[name]["bound_ms"], row[name]["bound_by"] = bound_ms(
                nbytes, flops, peak)
    print(what, json.dumps(row), flush=True)
    return row


def ssd_calls_phase(sops) -> list:
    """The kernels that one bf16 ``ssd_scan_kernel`` call runs on the card
    at the serving shape, from torch.profiler; fails unless they are the
    three passes' kernels, one each, with no copy, expansion or other
    kernel beside them.  Run before the training step's profile (phase 5),
    as flash_calls_phase."""
    m = SSD_MAIN
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x, dt, A, Bm, Cm = ssd_inputs(gen, m["B"], m["L"], m["H"], m["P"],
                                  m["N"], m["G"], torch.bfloat16)
    sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=m["chunk"])
    names = device_kernels(lambda: sops.ssd_scan_kernel(
        x, dt, A, Bm, Cm, chunk=m["chunk"]))
    print("ssd kernels per bf16 call", json.dumps(names), flush=True)
    if len(names) != len(SSD_PASSES) or sorted(
            k for k in SSD_PASSES.values()
            if any(k in n for n in names)) != sorted(SSD_PASSES.values()):
        raise AssertionError(
            f"a bf16 ssd_scan_kernel call ran {names} on the card; expected "
            f"the kernels {list(SSD_PASSES.values())} and nothing else")
    return names


def t3_calls_phase(sops) -> list:
    """The kernels that one bf16 ``ssd_scan_tangent`` call (T3) runs on the
    card at the mamba2 training shape, from torch.profiler; fails unless
    they are its three passes' kernels, one each, and nothing else.  Run
    before the training step's profile (phase 5), as ssd_calls_phase."""
    t = SSD_TRAIN
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    x, dt, A, Bm, Cm = ssd_inputs(gen, t["B"], t["L"], t["H"], t["P"],
                                  t["N"], t["G"], torch.bfloat16)
    tangents = [torch.randn(a.shape, generator=gen, device=DEVICE
                            ).to(a.dtype) for a in (x, dt, A, Bm, Cm)]
    call = lambda: sops.ssd_scan_tangent(x, dt, A, Bm, Cm, *tangents,
                                         chunk=t["chunk"])
    call()
    names = device_kernels(call)
    print("T3 kernels per bf16 call", json.dumps(names), flush=True)
    if len(names) != len(T3_PASSES) or sorted(
            k for k in T3_PASSES.values()
            if any(k in n for n in names)) != sorted(T3_PASSES.values()):
        raise AssertionError(
            f"a bf16 ssd_scan_tangent call ran {names} on the card; "
            f"expected the kernels {list(T3_PASSES.values())} and nothing "
            f"else")
    return names


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
    """The pairing's backward on the card (the backward's kernels,
    ``ssd_scan_bwd``) against the chunked scan's VJP it replaced (chunk by
    chunk, one chunk's (B, c, c, H) tiles live at a time) and one
    ``torch.func.vjp`` over the whole loop of chunks (every chunk's tiles
    live at once), on the same inputs in one process: time with the host's
    dispatch, kernel time, peak allocation, and the largest difference of
    each from the kernels' gradients."""
    from repro_torch.kernels.ssd_scan import chunked
    x, dt, A, Bm, Cm, gy, gs = inputs

    def kernels():
        return sops._chunked_vjp(x, dt, A, Bm, Cm, gy, gs, chunk)

    def by_chunk():
        return chunked.ssd_scan_vjp(x, dt, A, Bm, Cm, gy, gs, chunk)

    def whole_loop():
        _, vjp_fn = torch.func.vjp(
            lambda *a: layers.ssd_scan(*(t.float() for t in a), chunk),
            x, dt, A, Bm, Cm)
        return vjp_fn((gy.float(), gs.float()))

    fns = (("kernels", kernels), ("by_chunk", by_chunk),
           ("whole_loop", whole_loop))
    row = {name: dict(ms=time_events(fn, 3), device_ms=device_ms(fn),
                      peak_gb=peak_gb(fn)) for name, fn in fns}
    ours = kernels()
    for name, fn in fns[1:]:
        row[name]["max_abs_grad_diff"] = max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(ours, fn()))
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


def ssd_continuity(sops, layers, gen, dtype=torch.float32):
    """Two halves: the kernel over the first, the chunked scan (float32)
    from the kernel's state over the second, equal the kernel over the
    whole sequence (bfloat16: y within SSD_TOL[bfloat16] and the row
    slack, the float32 state within SSD_TOL[float32])."""
    B, L, H, P, N, chunk = 2, 512, 4, 64, 128, 128
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, 1, dtype)
    y, s = sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    h = L // 2
    first = [t[:, :h].contiguous() for t in (x, dt, Bm, Cm)]
    second = [t[:, h:].contiguous().float() for t in (x, dt, Bm, Cm)]
    y1, s1 = sops.ssd_scan_kernel(*first[:2], A, *first[2:], chunk=chunk)
    y2, s2 = layers.ssd_scan(*second[:2], A, *second[2:], chunk,
                             init_state=s1)
    torch.cuda.synchronize()
    tol = SSD_TOL[torch.float32]
    halves = torch.cat([y1.float(), y2], 1)
    row = dict(B=B, L=L, H=H, P=P, N=N, chunk=chunk, dtype=str(dtype)[6:],
               y_max_abs_err=compare(halves, y.float(), torch.float32,
                                     "ssd two halves y", SSD_TOL[dtype],
                                     ssd_slack(y.float(), dtype)),
               state_max_abs_err=compare(s2, s, torch.float32,
                                         "ssd two halves state", tol))
    print("ssd continuity", json.dumps(row), flush=True)
    return row


def ssd_phase(sops, sref, layers):
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows, pass_rows = [], []
    for L, chunk in ((128, 32), (256, 64), (256, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_ssd(sops, sref, layers, gen, 2, L, 2, 16, 32,
                                  2, chunk, dtype))
        pass_rows.append(check_ssd_passes(sops, sref, gen, 2, L, 2, 16, 32,
                                          2, chunk))
    # ragged chunks, narrow heads and two groups, then one chunk (a prompt
    # no longer than the model's chunk: empty hi/lo planes; 100 rows, not a
    # multiple of 16), as tests/test_torch_cuda.py
    for L, H, P, N, G, chunk in ((96, 4, 8, 16, 2, 48),
                                 (256, 4, 64, 128, 1, 256),
                                 (100, 4, 16, 32, 2, 100)):
        pass_rows.append(check_ssd_passes(sops, sref, gen, 2, L, H, P, N, G,
                                          chunk))
    continuity = {str(dtype)[6:]: ssd_continuity(sops, layers, gen, dtype)
                  for dtype in (torch.float32, torch.bfloat16)}
    m = SSD_MAIN
    main = {str(dtype)[6:]: check_ssd(
        sops, sref, layers, gen, m["B"], m["L"], m["H"], m["P"], m["N"],
        m["G"], m["chunk"], dtype, timed=True, faults=True)
        for dtype in (torch.bfloat16, torch.float32)}
    passes = check_ssd_passes(sops, sref, gen, m["B"], m["L"], m["H"],
                              m["P"], m["N"], m["G"], m["chunk"], timed=True)
    b = main["bfloat16"]
    b["design_bound_ms"], _ = bound_ms(
        sum(v["bytes"] for v in passes.values()),
        sum(v["flops"] for v in passes.values()), BF16_FLOP_PER_S)
    print(f"ssd serving shape, bf16: {b['ms']:.4f} ms a call; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); this design's bound "
          f"(each pass's bytes) {b['design_bound_ms']:.4f} ms; the "
          f"CUDA-core kernel it replaced {SSD_SIMT_MS} ms (PERF.md)",
          flush=True)
    torch.cuda.empty_cache()
    bwd = ssd_bwd_rows(sops, sref, gen)
    return main, rows, continuity, passes, pass_rows, bwd


def ssd_summary(main, rows, continuity, passes, pass_rows, calls,
                serve_row) -> list:
    """The kernels-line entries of the SSD scan: the whole bf16 call
    (``ssd_scan``: its launches count calls) and each of its three
    kernels, numbers at the serving path's shape in bfloat16, launches from
    the mamba2 serve run."""
    b, m = main["bfloat16"], SSD_MAIN
    shape = (f"(B={m['B']}, L={m['L']}, H={m['H']}, P={m['P']}, N={m['N']}, "
             f"G={m['G']}, chunk={m['chunk']}) bfloat16")
    call = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
            "replaces": REPLACES["ssd_scan"],
            "launches": serve_row["launches"]["ssd_scan"],
            "max_abs_err": b["y_max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "design_bound_ms": b["design_bound_ms"],
            "kernels_per_call": calls,
            "chunked_ms": b["chunked_ms"],
            "bwd_compare": b["bwd_compare"],
            "shape": f"{shape}; launches: calls in the mamba2 serve run's "
                     f"adapt dispatch (three kernels each, the entries "
                     f"below); library: none (no single PyTorch call); "
                     f"chunked_ms: the port's chunked torch scan",
            "float32": main["float32"], "continuity": continuity,
            "sweep_checks": len(rows) + len(pass_rows),
            "sweep_worst_y_err": max(r["y_max_abs_err"] for r in rows)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [call] + [
        {"name": name, "route": "cuda", "source": SSD_SOURCE,
         "replaces": REPLACES["ssd_scan"],
         "launches": serve_row["launches"][name],
         **{k: passes[name][k] for k in keys},
         "shape": f"{shape}; one launch a bf16 call",
         "sweep_worst_err": max(r[name]["max_abs_err"] for r in pass_rows)}
        for name in SSD_PASSES]


# ---------------------------------------------------------------------------
# Phases 9 and 12: the scan's backward (ssd_scan_bwd) and its tangent
# (ssd_scan_bwd_tangent), csrc/ssd_bwd.cu
# ---------------------------------------------------------------------------

BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def bwd_outside(got, want, steep=False) -> tuple[int, float]:
    """(elements of ``got`` outside SSD_BWD_TOL of ``want``, non-finite
    ones included; the largest |got - want|), for one gradient: ``want``'s
    dtype picks the limit; dA where seg falls past 88 STEEP_DA_REL."""
    rtol, rel = SSD_BWD_TOL[want.dtype]
    if steep:
        rel = max(rel, STEEP_DA_REL)
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    limit = rtol * w.abs() + rel * w.abs().max()
    bad = int((err > limit).sum()) + int((~torch.isfinite(g)).sum())
    return bad, float(err.max()) if err.numel() else 0.0


def check_bwd_grads(got, want, what, steep=False) -> dict:
    """Each of the five gradients (or their tangents) within its limit;
    raises otherwise.  Returns each one's largest error."""
    errs = {}
    for name, g, w in zip(BWD_NAMES, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
        bad, errs[name] = bwd_outside(g, w, steep and name == "dA")
        if bad:
            raise AssertionError(f"{what} {name}: {bad} elements outside "
                                 f"{SSD_BWD_TOL[w.dtype]} (max abs err "
                                 f"{errs[name]:.3e})")
    return errs


def ssd_bwd_inputs(gen, B, L, H, P, N, G, dtype, per_sequence_A=False,
                   steep_dt=None, tangents=False):
    """ssd_inputs with the cotangents gy (x's dtype) and gs (float32),
    A per sequence on request, every dt ``steep_dt`` on request (seg then
    falls by hundreds within a chunk), and standard normal tangents of all
    seven with ``tangents``."""
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, dtype)
    if steep_dt is not None:
        dt = torch.full_like(dt, steep_dt)
    if per_sequence_A:
        A = A * (0.5 + torch.rand(B, 1, generator=gen, device=DEVICE))
    gy = torch.randn(x.shape, generator=gen, device=DEVICE).to(dtype)
    gs = torch.randn(B, H, P, N, generator=gen, device=DEVICE)
    args = [x, dt, A, Bm, Cm, gy, gs]
    if not tangents:
        return args
    return args, [torch.randn(a.shape, generator=gen, device=DEVICE
                              ).to(a.dtype) for a in args]


def bwd_plain(sref, args, chunk):
    """The backward's three plain passes composed."""
    S, Lc, seg = sref.bwd_state_ref(*args[:6], chunk)
    s_in, gO, sg = sref.bwd_state_pass_ref(S, Lc, seg, args[6], chunk)
    return sref.bwd_chunk_ref(*args[:6], seg, s_in, gO, sg, chunk)


def bwd_tangent_plain(sref, args, targs, chunk):
    """The tangent's three plain passes composed."""
    S, tS, Lc, tLc, seg, tseg = sref.tangent_bwd_state_ref(
        *args[:6], *targs[:6], chunk)
    s_in, ts_in, gO, tgO, sg, tsg = sref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, args[6], targs[6], chunk)
    return sref.tangent_bwd_chunk_ref(*args[:6], seg, s_in, gO, sg,
                                      *targs[:6], tseg, ts_in, tgO, tsg,
                                      chunk)


def ssd_bwd_cost(B, L, H, P, N, G, chunk, itemsize, tangent=False
                 ) -> dict:
    """(bytes, flops) of each of the backward's three wrappers and of the
    whole call: inputs read once, outputs written once; flops the least
    work on these inputs (2 a multiply-add), per (b, chunk): the causal
    half of C.B^T once per group (c(c+1)N), and per head the causal halves
    of D = gy x^T, M^T gy (c(c+1)P each), Z B and Z^T C (c(c+1)N each),
    and the (P x N) x c products S, Lc, gO B, gO^T x and gy s_in (2cPN
    each).  The tangent reads every input and its tangent, writes the
    outputs' tangents, and does each product three times (A B, A' B,
    A B')."""
    c, nc = chunk, L // chunk
    k = 2 if tangent else 1
    x, bc = itemsize * B * L * H * P, itemsize * B * L * G * N
    dt = seg = 4 * B * L * H
    a = 4 * B * H
    S = 4 * B * nc * H * P * N
    sg, gs = 4 * B * H * nc, 4 * B * H * P * N
    heads = B * nc * H
    gram = c * (c + 1) * N * G * B * nc
    intra = (2 * c * (c + 1) * P + 2 * c * (c + 1) * N) * heads
    f = 3 if tangent else 1
    costs = {
        "state": (k * (2 * x + 2 * bc + dt + a) + k * (2 * S + seg),
                  f * 4.0 * c * P * N * heads),
        "pass": (k * (2 * S + seg // c + gs) + k * (2 * S + sg),
                 f * 6.0 * P * N * heads),
        "chunk": (k * (2 * x + 2 * bc + dt + a + seg + 2 * S + sg)
                  + x + 2 * bc + dt + a,
                  f * float(gram + intra + 6 * c * P * N * heads))}
    whole = (k * (2 * x + 2 * bc + dt + a + gs) + x + 2 * bc + dt + a,
             f * float(gram + intra + 10 * c * P * N * heads))
    return {"whole": whole, **costs}


def bwd_faults(sops, args, chunk, want, what, tangent=False, targs=None):
    """Plant faults in the kernels' outputs and require the check against
    the plain version to reject each: the state cotangent not carried
    across chunks (each chunk's gO but the last zeroed), dA without the
    first chunk's term (each chunk's dA from a call on its rows alone, the
    others summed), dB not summed over a group's heads (gy and gs, and
    their tangents, zeroed but for the first head of each group)."""
    x, dt, A, Bm, Cm, gy, gs = args
    B, L, H = x.shape[:3]
    nc = L // chunk
    tg = targs if tangent else None
    if tangent:
        S, tS, Lc, tLc, seg, tseg = sops.ssd_bwd_tangent_state(
            *args[:6], *tg[:6], chunk=chunk)
        s_in, ts_in, gO, tgO, sg, tsg = sops.ssd_bwd_tangent_pass(
            S, tS, Lc, tLc, seg, tseg, gs, tg[6], chunk=chunk)
    else:
        S, Lc, seg = sops.ssd_bwd_state(*args[:6], chunk=chunk)
        s_in, gO, sg = sops.ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk)

    def chunk_call(sl, cs, a6, g_in, g_out, g_sg, t6=None, tin=None,
                   tout=None, tsgc=None):
        rows = [t[:, sl].contiguous() if t.ndim >= 3 else t for t in a6]
        segc = seg[:, :, sl].contiguous()
        if not tangent:
            return sops.ssd_bwd_chunk(*rows, segc, g_in, g_out, g_sg,
                                      chunk=chunk)
        trows = [t[:, sl].contiguous() if t.ndim >= 3 else t for t in t6]
        return sops.ssd_bwd_tangent_chunk(
            *rows, segc, g_in, g_out, g_sg, *trows,
            tseg[:, :, sl].contiguous(), tin, tout, tsgc, chunk=chunk)

    def inner(a, b):
        return (a * b).sum((-2, -1)).transpose(1, 2).contiguous()

    faults = {}
    # the state cotangent not carried: gO (and gO') of chunks 0 .. nc-2 zero
    keep_last = torch.zeros(nc, device=DEVICE)
    keep_last[-1] = 1
    gOb = (gO * keep_last[None, :, None, None, None]).contiguous()
    if tangent:
        tgOb = (tgO * keep_last[None, :, None, None, None]).contiguous()
        faults["state cotangent not carried"] = (0, chunk_call(
            slice(0, L), chunk, args[:6], s_in, gOb, inner(s_in, gOb),
            tg[:6], ts_in, tgOb, inner(ts_in, gOb) + inner(s_in, tgOb)))
    else:
        faults["state cotangent not carried"] = (0, chunk_call(
            slice(0, L), chunk, args[:6], s_in, gOb, inner(s_in, gOb)))
    # dA without the first chunk's term
    parts = []
    for c in range(nc):
        sl, cc = slice(c * chunk, (c + 1) * chunk), slice(c, c + 1)
        one = [t[:, cc].contiguous() for t in (s_in, gO)]
        if tangent:
            tone = [t[:, cc].contiguous() for t in (ts_in, tgO)]
            parts.append(chunk_call(sl, chunk, args[:6], *one,
                                    sg[:, :, cc].contiguous(), tg[:6],
                                    *tone, tsg[:, :, cc].contiguous())[2])
        else:
            parts.append(chunk_call(sl, chunk, args[:6], *one,
                                    sg[:, :, cc].contiguous())[2])
    all_parts = sum(parts[1:], parts[0])
    if bwd_outside(all_parts, want[2])[0]:
        raise AssertionError(f"{what}: dA summed chunk by chunk falls "
                             f"outside the check")
    faults["dA without the first chunk"] = (2, sum(parts[2:], parts[1]))
    # dB not summed over a group's heads
    first = torch.zeros(H, device=DEVICE)
    first[::H // Bm.shape[2]] = 1

    def heads0(t, dim):
        shape = [1] * t.ndim
        shape[dim] = H
        return (t * first.view(shape).to(t.dtype)).contiguous()

    bad_args = [*args[:5], heads0(gy, 2), heads0(gs, 1)]
    if tangent:
        bad_t = [*tg[:5], heads0(tg[5], 2), heads0(tg[6], 1)]
        faults["dB not summed over a group"] = (3, sops.ssd_scan_bwd_tangent(
            *bad_args, *bad_t, chunk=chunk))
    else:
        faults["dB not summed over a group"] = (3, sops.ssd_scan_bwd(
            *bad_args, chunk=chunk))
    caught = {}
    for name, (i, bad) in faults.items():
        out = bad if name.startswith("dA") else bad[i]
        flagged, _ = bwd_outside(out, want[i])
        if not flagged:
            raise AssertionError(f"{what}: planted fault '{name}' passed "
                                 f"the check")
        caught[name] = flagged
    return caught


def check_ssd_bwd(sops, sref, gen, B, L, H, P, N, G, chunk, dtype,
                  per_sequence_A=False, steep_dt=None, timed=False,
                  faults=False, tangent=False) -> dict:
    """One call of ``ssd_scan_bwd`` (``tangent``: ``ssd_scan_bwd_tangent``)
    at one shape against the plain passes composed (one call, five
    launches): each gradient within SSD_BWD_TOL, and a second call equal
    to the bit.  ``faults``: the planted faults of bwd_faults must fail the
    check.  ``timed``: the call's ms, its plain version's, its bound, each
    wrapper's ms and bound, and the chunked VJP (or its jvp) it replaced,
    host included."""
    args, targs = ssd_bwd_inputs(gen, B, L, H, P, N, G, dtype,
                                 per_sequence_A, steep_dt, tangents=True)
    key = "ssd_scan_bwd_tangent" if tangent else "ssd_scan_bwd"
    if tangent:
        call = lambda: sops.ssd_scan_bwd_tangent(*args, *targs, chunk=chunk)
        plain = lambda: bwd_tangent_plain(sref, args, targs, chunk)
    else:
        call = lambda: sops.ssd_scan_bwd(*args, chunk=chunk)
        plain = lambda: bwd_plain(sref, args, chunk)
    got, n = counted(sops, key, call, key)
    again = call()
    want = plain()
    torch.cuda.synchronize()
    what = (f"{key} (B={B}, L={L}, H={H}, P={P}, N={N}, G={G}, "
            f"chunk={chunk}) {str(dtype)[6:]}"
            + (" A per sequence" if per_sequence_A else "")
            + (f" dt={steep_dt}" if steep_dt is not None else ""))
    errs = check_bwd_grads(got, want, what, steep=steep_dt is not None)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    row = dict(shape=[B, L, H, P, N, G, chunk], dtype=str(dtype)[6:],
               per_sequence_A=per_sequence_A, steep_dt=steep_dt,
               max_abs_err=max(errs.values()), errs=errs, same_bits=True)
    if faults:
        row["planted_faults_caught"] = bwd_faults(sops, args, chunk, want,
                                                  what, tangent, targs)
    if timed:
        from repro_torch.kernels.ssd_scan import chunked
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
            FP32_FLOP_PER_S
        costs = ssd_bwd_cost(B, L, H, P, N, G, chunk,
                             args[0].element_size(), tangent)
        row["ms"] = time_ms(call, 5)
        row["plain_ms"] = (time_events(plain, 1) if tangent
                           else time_ms(plain, 1, reps=3))
        row["bound_ms"], row["bound_by"] = bound_ms(*costs["whole"], rate)
        row["library_ms"] = None
        if tangent:
            chunked_call = lambda: torch.func.jvp(
                lambda *a: chunked.ssd_scan_vjp(*a, chunk), tuple(args),
                tuple(targs))
        else:
            chunked_call = lambda: chunked.ssd_scan_vjp(*args, chunk)
        row["chunked_ms"] = time_events(chunked_call, 2)
        row["passes"] = bwd_pass_times(sops, sref, args, targs, chunk,
                                       tangent, costs, rate)
        print(f"{what}: {row['ms']:.4f} ms (plain {row['plain_ms']:.2f}, "
              f"chunked {row['chunked_ms']:.2f} with the host; bound "
              f"{row['bound_ms']:.4f} {row['bound_by']}); passes "
              f"{ {k: round(v['ms'], 4) for k, v in row['passes'].items()} }"
              f"; errs {errs}", flush=True)
    return row


def bwd_pass_times(sops, sref, args, targs, chunk, tangent, costs, rate
                   ) -> dict:
    """Each wrapper of the call (state, pass, chunk: its three kernels)
    timed on the outputs of the one before, beside its plain version and
    its bound."""
    x, dt, A, Bm, Cm, gy, gs = args
    if tangent:
        st = sops.ssd_bwd_tangent_state(*args[:6], *targs[:6], chunk=chunk)
        S, tS, Lc, tLc, seg, tseg = st
        ps = sops.ssd_bwd_tangent_pass(S, tS, Lc, tLc, seg, tseg, gs,
                                       targs[6], chunk=chunk)
        s_in, ts_in, gO, tgO, sg, tsg = ps
        kernel = {
            "state": lambda: sops.ssd_bwd_tangent_state(
                *args[:6], *targs[:6], chunk=chunk),
            "pass": lambda: sops.ssd_bwd_tangent_pass(
                S, tS, Lc, tLc, seg, tseg, gs, targs[6], chunk=chunk),
            "chunk": lambda: sops.ssd_bwd_tangent_chunk(
                *args[:6], seg, s_in, gO, sg, *targs[:6], tseg, ts_in, tgO,
                tsg, chunk=chunk)}
        plain = {
            "state": lambda: sref.tangent_bwd_state_ref(
                *args[:6], *targs[:6], chunk),
            "pass": lambda: sref.tangent_bwd_state_pass_ref(
                S, tS, Lc, tLc, seg, tseg, gs, targs[6], chunk),
            "chunk": lambda: sref.tangent_bwd_chunk_ref(
                *args[:6], seg, s_in, gO, sg, *targs[:6], tseg, ts_in, tgO,
                tsg, chunk)}
    else:
        S, Lc, seg = sops.ssd_bwd_state(*args[:6], chunk=chunk)
        s_in, gO, sg = sops.ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk)
        kernel = {
            "state": lambda: sops.ssd_bwd_state(*args[:6], chunk=chunk),
            "pass": lambda: sops.ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk),
            "chunk": lambda: sops.ssd_bwd_chunk(*args[:6], seg, s_in, gO, sg,
                                                chunk=chunk)}
        plain = {
            "state": lambda: sref.bwd_state_ref(*args[:6], chunk),
            "pass": lambda: sref.bwd_state_pass_ref(S, Lc, seg, gs, chunk),
            "chunk": lambda: sref.bwd_chunk_ref(*args[:6], seg, s_in, gO,
                                                sg, chunk)}
    out = {}
    for name in ("state", "pass", "chunk"):
        nbytes, flops = costs[name]
        r = FP32_FLOP_PER_S if name == "pass" else rate
        out[name] = dict(ms=time_ms(kernel[name], 5),
                         plain_ms=(time_events(plain[name], 1) if tangent
                                   else time_ms(plain[name], 1, reps=3)),
                         library_ms=None, bytes=nbytes, flops=flops)
        out[name]["bound_ms"], out[name]["bound_by"] = bound_ms(nbytes,
                                                                flops, r)
    return out


def bwd_calls_phase(sops) -> dict:
    """The kernels that one bf16 ``ssd_scan_bwd`` call and one bf16
    ``ssd_scan_bwd_tangent`` call run on the card at the mamba2 training
    shape, from torch.profiler; fails unless each is its five kernels, one
    launch each, and nothing else.  Run before the training step's profile
    (phase 5), as ssd_calls_phase."""
    t = SSD_TRAIN
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    args, targs = ssd_bwd_inputs(gen, t["B"], t["L"], t["H"], t["P"],
                                 t["N"], t["G"], torch.bfloat16, True,
                                 tangents=True)
    out = {}
    for name, call, kernels in (
            ("ssd_scan_bwd", lambda: sops.ssd_scan_bwd(
                *args, chunk=t["chunk"]), SSD_BWD_KERNELS),
            ("ssd_scan_bwd_tangent", lambda: sops.ssd_scan_bwd_tangent(
                *args, *targs, chunk=t["chunk"]), SSD_BWD_TANGENT_KERNELS)):
        call()
        names = device_kernels(call)
        print(f"{name} kernels per bf16 call", json.dumps(names), flush=True)
        want = sorted(kernels.values())
        if len(names) != len(want) or sorted(
                k for k in want if any(k + "<" in n or k + "(" in n
                                       for n in names)) != want:
            raise AssertionError(f"a bf16 {name} call ran {names} on the "
                                 f"card; expected the kernels {want} and "
                                 f"nothing else")
        out[name] = names
    return out


def ssd_bwd_rows(sops, sref, gen, tangent=False) -> tuple[list, dict]:
    """The backward (``tangent``: its tangent) over tests/test_kernels.py's
    grid (B=2, H=2, P=16, N=32, two groups), a ragged row (chunks of 48,
    A per sequence, narrow heads, two groups), full-width heads with one
    group, one chunk of 100 rows, and seg falling past 88 within each of
    two chunks, in float32 and bfloat16; then the mamba2 training shape (A
    per sequence) in both dtypes and the serving shape in bfloat16, timed,
    with planted faults."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for L, chunk in ((128, 32), (256, 64), (256, 128)):
            rows.append(check_ssd_bwd(sops, sref, gen, 2, L, 2, 16, 32, 2,
                                      chunk, dtype, tangent=tangent))
        for L, H, P, N, G, chunk, per_seq in (
                (96, 4, 8, 16, 2, 48, True), (256, 4, 64, 128, 1, 256, True),
                (100, 4, 16, 32, 2, 100, False)):
            rows.append(check_ssd_bwd(sops, sref, gen, 2, L, H, P, N, G,
                                      chunk, dtype, per_sequence_A=per_seq,
                                      tangent=tangent))
        rows.append(check_ssd_bwd(sops, sref, gen, 2, 512, 4, 16, 32, 2,
                                  256, dtype, steep_dt=4.0, tangent=tangent))
    t, m = SSD_TRAIN, SSD_MAIN
    main = {f"train_{str(dtype)[6:]}": check_ssd_bwd(
        sops, sref, gen, t["B"], t["L"], t["H"], t["P"], t["N"], t["G"],
        t["chunk"], dtype, per_sequence_A=True, timed=True, faults=True,
        tangent=tangent) for dtype in (torch.bfloat16, torch.float32)}
    main["serve_bfloat16"] = check_ssd_bwd(
        sops, sref, gen, m["B"], m["L"], m["H"], m["P"], m["N"], m["G"],
        m["chunk"], torch.bfloat16, timed=True, faults=True, tangent=tangent)
    torch.cuda.empty_cache()
    return rows, main


def ssd_bwd_summary(bwd, tan, train_rows, mamba_row) -> list:
    """The kernels-line entries of the backward and its tangent: the whole
    call (five launches; its launches count calls) and each of its three
    wrappers, numbers at the mamba2 training shape in bfloat16 with A per
    sequence, launches from the mamba2 training run (the backward's also
    from the serve run)."""
    t = SSD_TRAIN
    shape = (f"(B={t['B']}, L={t['L']}, H={t['H']}, P={t['P']}, N={t['N']}, "
             f"G={t['G']}, chunk={t['chunk']}) bfloat16, A per sequence")
    launches = train_rows["mamba2"]["launches"]
    out = []
    for name, (rows, main), prefix in (
            ("ssd_scan_bwd", bwd, "ssd_bwd_"),
            ("ssd_scan_bwd_tangent", tan, "ssd_bwd_tangent_")):
        b = main["train_bfloat16"]
        out.append({
            "name": name, "route": "cuda", "source": SSD_BWD_SOURCE,
            "replaces": None, "launches": launches[name],
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "chunked_ms": b["chunked_ms"],
            "shape": f"{shape}; five launches a call (the entries below); "
                     f"no TPU counterpart; launches: calls in the mamba2 "
                     f"training run; library: none; chunked_ms: the "
                     f"chunked VJP {'(its jvp) ' if 'tangent' in name else ''}"
                     f"it replaced, host included",
            "launches_in_serve_run": mamba_row["launches"].get(name),
            "float32": main["train_float32"],
            "serving_shape": main["serve_bfloat16"],
            "sweep_checks": len(rows),
            "sweep_worst_err": max(r["max_abs_err"] for r in rows)})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        for wrapper in ("state", "pass", "chunk"):
            p = b["passes"][wrapper]
            kernels = (("chunk", "finish", "reduce") if wrapper == "chunk"
                       else (wrapper,))
            out.append({
                "name": prefix + wrapper, "route": "cuda",
                "source": SSD_BWD_SOURCE, "replaces": None,
                "launches": launches[prefix + wrapper],
                "max_abs_err": b["max_abs_err"],
                **{k: p[k] for k in keys},
                "shape": f"{shape}; kernels "
                         f"{[prefix + k for k in kernels]} (launches: the "
                         f"first's in the mamba2 training run; "
                         f"{', '.join(prefix + k for k in kernels[1:])} "
                         f"{'the same' if len(kernels) > 1 else ''}); "
                         f"max_abs_err: the whole call's",
                "serving_shape": {k: main["serve_bfloat16"]["passes"][
                    wrapper][k] for k in keys}})
    return out


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
    torch.profiler: all kernels, the SSD scan's forward kernels (the three
    bf16 passes, or the float32 kernel), its backward's five kernels
    (``sbw::``), and the chunked-scan backward (its ``record_function``
    range, with every kernel launched inside it: on the card it runs only
    on CPU tensors, so none is expected)."""
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
    busy = fwd = bwd = sbw = 0.0
    fwd_n = bwd_n = sbw_n = 0
    sbw_kernels = {}
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
            if any(k in evt.key for k in SSD_FORWARD_KERNELS):
                fwd, fwd_n = fwd + us, fwd_n + evt.count
            if "sbw::" in evt.key:
                sbw, sbw_n = sbw + us, sbw_n + evt.count
                sbw_kernels[evt.key[:60]] = dict(ms=us / 1e3,
                                                 launches=evt.count)
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
                ssd_bwd_ms=sbw / 1e3, ssd_bwd_launches=sbw_n,
                ssd_bwd_kernels=sbw_kernels, ssd_bwd_share=sbw / busy,
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
                                   for r in rows + gqa_rows),
            **({"qwen2_float32": gqa["float32"]} if p == "bwd" else {})}


# ---------------------------------------------------------------------------
# Phase 12: the forward-mode tangent kernels against their plain versions
# ---------------------------------------------------------------------------

# T1-T3 against torch.func.jvp of their plain versions: float32 within 1e-4
# of the output's largest |value| (the same products summed in another
# order; the plain backward sums in float64); bfloat16 within one rounding
# of it (2^-8) plus the output's own rounding (rtol 1.6e-2): a tangent that
# is exactly 0 in the plain version (a row that sees one key) is a rounding
# residue of the kernel's float32 sums.
TANGENT_TOL = {torch.float32: (0.0, 1e-4),
               torch.bfloat16: (1.6e-2, 2.0 ** -8)}
TANGENTS = ("flash_attention_fwd_tangent", "flash_attention_bwd_tangent",
            "ssd_scan_tangent", "ssd_scan_bwd_tangent")
# The mamba2 training path's scan: 4 agents x 2 tasks x 1 sequence of 512
# tokens folded into one batch, chunk 256.
SSD_TRAIN = dict(B=8, L=512, H=24, P=64, N=128, G=1, chunk=256)


def tangent_outside(got, want) -> tuple[int, float]:
    """(elements of ``got`` outside TANGENT_TOL of ``want``, largest |got -
    want|; 0 for no elements: one chunk has no entering states)."""
    rtol, rel = TANGENT_TOL[want.dtype]
    g, w = got.detach().float(), want.detach().float()
    if not w.numel():
        return 0, 0.0
    err = (g - w).abs()
    limit = rtol * w.abs() + rel * w.abs().max()
    bad = int((err > limit).sum()) + int((~torch.isfinite(g)).sum())
    return bad, float(err.max()) if err.numel() else 0.0


def check_tangent(got, want, what: str) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    bad, err = tangent_outside(got, want)
    if bad:
        raise AssertionError(f"{what}: {bad} elements outside "
                             f"{TANGENT_TOL[want.dtype]} (max abs err "
                             f"{err:.3e})")
    return err


def flash_tangent_cost(B, H, KV, S, d, itemsize, pairs, backward
                       ) -> tuple[float, float]:
    """(bytes, flops) of T1 or T2, each input read once and each output
    written once.  T1: q, q', o' (H heads) and k, k', v, v' (KV heads),
    lse in and lse' out (float32); 6d multiply-adds a pair a head (s, s'
    twice, P V, P s' V, P V').  T2: q, o, dO, q', o', dO', dq' and k, v,
    k', v', dk', dv', lse and lse' in; 12d a pair (s, s' twice, dP, dP'
    twice, dq' twice, dk' twice, dv' twice).  ``pairs``: the allowed
    (query, key) pairs of one head."""
    qb, kb, rows = B * S * H * d * itemsize, B * S * KV * d * itemsize, \
        4 * B * H * S
    if backward:
        return 7 * qb + 6 * kb + 2 * rows, 24.0 * d * pairs * B * H
    return 3 * qb + 4 * kb + 2 * rows, 12.0 * d * pairs * B * H


def check_flash_tangents(fops, fref, gen, heads_dim, shape, dtype, causal,
                         window, timed=False, unaligned=False,
                         faults=False) -> dict:
    """T1 and T2 at one shape against their plain versions (one and two
    launches); with ``timed``, the kernels' and plain versions' times and
    the bounds (float32: also T2's products as three TF32 products, and
    its bytes alone); ``unaligned``: views whose rows are not 16-byte
    aligned; ``faults``: planted faults in T2's results, and T2 run without
    lse', must fail the check."""
    from repro_torch.kernels.flash_attention.ref import band_mask
    if heads_dim == 1:
        B, H, S, d = shape
        KV, qs = H, shape
        ks = qs
    else:
        B, S, H, KV, d = shape
        qs, ks = (B, S, H, d), (B, S, KV, d)
    mk = lambda s: randn_view(gen, s, dtype, unaligned)
    q, tq, do, tdo = (mk(qs) for _ in range(4))
    k, v, tk, tv = (mk(ks) for _ in range(4))
    fwd = fref.flash_fwd_ref if heads_dim == 1 else fref.gqa_flash_fwd_ref
    out, lse = fwd(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, heads_dim=heads_dim)
    what = (f"tangent {'bhsd' if heads_dim == 1 else 'gqa'} {shape} "
            f"{str(dtype)[6:]} causal={causal} window={window}"
            + (" unaligned" if unaligned else ""))
    t1 = lambda: fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv,
                                                  **kw)
    (to, tlse), n1 = counted(fops, "flash_attention_fwd_tangent", t1)
    want_to, want_tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv,
                                                    **kw)
    e1 = max(check_tangent(to, want_to, what + " o'"),
             check_tangent(tlse, want_tlse, what + " lse'"))
    t2 = lambda: fops.flash_attention_bwd_tangent(
        q, k, v, out, lse, do, tq, tk, tv, want_to, want_tlse, tdo, **kw)
    grads, n2 = counted(fops, "flash_attention_bwd_tangent", t2)
    wants = fref.flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                       want_to, want_tlse, tdo, **kw)
    e2 = max(check_tangent(g, w, f"{what} {n}'")
             for g, w, n in zip(grads, wants, ("dq", "dk", "dv")))
    if (n1, n2) != (1, 2):
        raise AssertionError(f"{what}: {n1} and {n2} launches, expected 1 "
                             f"and 2")
    row = dict(layout="bhsd" if heads_dim == 1 else "gqa", shape=list(shape),
               dtype=str(dtype)[6:], causal=causal, window=window,
               unaligned=unaligned, fwd_max_abs_err=e1, bwd_max_abs_err=e2)
    if faults:
        # rows of each result zeroed, and lse' left out (T2 given zeros)
        dq, dk, dv = grads
        planted = {"dq' rows 0:64 zero": (0, zero_seq(dq, heads_dim, 0, 64)),
                   "dk' rows 64:128 zero": (1, zero_seq(dk, heads_dim, 64,
                                                        128)),
                   "dv' rows 128:192 zero": (2, zero_seq(dv, heads_dim, 128,
                                                         192))}
        lse_out = fops.flash_attention_bwd_tangent(
            q, k, v, out, lse, do, tq, tk, tv, want_to,
            torch.zeros_like(want_tlse), tdo, **kw)
        planted.update({f"{n}' without lse'": (i, g) for i, (g, n) in
                        enumerate(zip(lse_out, ("dq", "dk", "dv")))})
        for name, (i, bad) in planted.items():
            if tangent_outside(bad, wants[i])[0] == 0:
                raise AssertionError(f"{what}: planted fault '{name}' passed "
                                     f"the check")
        row["planted_faults_caught"] = list(planted)
    if timed:
        pairs = int(band_mask(S, S, causal, window).sum())
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
            FP32_FLOP_PER_S
        for p, fn, plain, n in (
                ("fwd", t1, lambda: fref.flash_fwd_tangent_ref(
                    q, k, v, tq, tk, tv, **kw), 20),
                ("bwd", t2, lambda: fref.flash_bwd_tangent_ref(
                    q, k, v, out, lse, do, tq, tk, tv, want_to, want_tlse,
                    tdo, **kw), 10)):
            nbytes, flops = flash_tangent_cost(B, H, KV, S, d,
                                               q.element_size(), pairs,
                                               p == "bwd")
            row[f"{p}_ms"] = time_ms(fn, n)
            row[f"{p}_plain_ms"] = time_events(plain, 3)
            row[f"{p}_bound_ms"], row[f"{p}_bound_by"] = bound_ms(
                nbytes, flops, rate)
            if dtype == torch.float32 and p == "bwd":
                tf32_bound(row, p, (nbytes, flops))
        print(f"{what}: T1 {row['fwd_ms']:.4f} ms (plain "
              f"{row['fwd_plain_ms']:.3f}, bound {row['fwd_bound_ms']:.4f} "
              f"{row['fwd_bound_by']}), T2 {row['bwd_ms']:.4f} ms (plain "
              f"{row['bwd_plain_ms']:.3f}, bound {row['bwd_bound_ms']:.4f} "
              f"{row['bwd_bound_by']}); errs {e1:.2e} {e2:.2e}", flush=True)
    return row


def ssd_tangent_cost(B, L, H, P, N, G, chunk, itemsize
                     ) -> tuple[float, float]:
    """(bytes, flops) of T3: x, x', B, B', C, C' read and y' written in the
    working dtype, dt, dt', A, A' read and the state's tangent written in
    float32; per (b, chunk) the causal halves of C.B^T, C'.B^T and C.B'^T
    once per group (3c(c+1)N), and per head the causal halves of the two
    products with x and x' (2c(c+1)P) and the six (P x N) x c products of
    the entering states and the state update (12cPN)."""
    c = chunk
    nbytes = ((3 * B * L * H * P + 4 * B * L * G * N) * itemsize
              + 4 * (2 * B * L * H + 2 * B * H + B * H * P * N))
    flops = ((3 * c * (c + 1) * N * G
              + (2 * c * (c + 1) * P + 12 * c * P * N) * H) * B * (L // c))
    return nbytes, float(flops)


def t3_pass_costs(B, L, H, P, N, G, chunk) -> dict:
    """(bytes, flops, design flops, peak rate) of each of T3's bf16 passes:
    its inputs read once and its outputs written once; flops the least
    work on these inputs (G = C.B^T and G' = C'.B^T + C.B'^T once per group,
    products of bf16 inputs only), design flops what this design issues
    (G and G' once per block of kT3ScanHeads = 2 heads, and every product
    that takes a float32 operand as a bf16 hi/lo pair twice).
    Tangent chunk states: x, x', dt, dt', A, A', B, B' in; S, S', seg, seg'
    out; (u x)^T B, (u' x + u x')^T B and (u x)^T B', 2cPN each a (b, h,
    chunk), all hi/lo.  Tangent state passing: S, S' and the chunks' last
    seg, seg' in; four planes and the final S' out; 6PN a (b, h, chunk) on
    the CUDA cores.  Tangent chunk outputs: x, x', dt, dt', seg, seg', B,
    B', C, C' and four planes in, y' out; the causal halves of G and G'
    (3c(c+1)N a group), of M1 x and M2 x' (2c(c+1)P a head, hi/lo), and the
    entering C s_in^T, C' s_in^T, C s'_in^T (6cPN a head of chunks 1 ..,
    hi/lo)."""
    c, nc = chunk, L // chunk
    x, bc = 2 * B * L * H * P, 2 * B * L * G * N
    dt = seg = 4 * B * L * H
    S, state = 4 * B * nc * H * P * N, 4 * B * H * P * N
    planes = 2 * 2 * B * (nc - 1) * H * P * N
    heads = B * nc * H
    gram = 3.0 * c * (c + 1) * N * B * nc
    blocks = G * -(-(H // G) // 2)               # pass-3 blocks a (b, chunk)
    mx = 2.0 * c * (c + 1) * P * heads
    enter = 6.0 * c * P * N * B * (nc - 1) * H
    return {
        "ssd_tangent_state": (2 * x + 2 * dt + 8 * B * H + 2 * bc + 2 * S
                              + 2 * seg, 6.0 * c * P * N * heads,
                              12.0 * c * P * N * heads, BF16_FLOP_PER_S),
        "ssd_tangent_pass": (2 * S + 8 * B * H * nc + 2 * planes + state,
                             6.0 * P * N * heads, 6.0 * P * N * heads,
                             FP32_FLOP_PER_S),
        "ssd_tangent_scan": (3 * x + 4 * dt + 4 * bc + 2 * planes,
                             gram * G + mx + enter,
                             gram * blocks + 2 * mx + 2 * enter,
                             BF16_FLOP_PER_S)}


def check_t3_passes(sops, sref, gen, B, L, H, P, N, G, chunk, timed=False,
                    steep_dt=None) -> dict:
    """Each of T3's bf16 kernels against its plain version on the same
    inputs (the kernel's own outputs of the pass before), A per sequence:
    the tangent chunk states (S, S', seg, seg') against
    ``tangent_state_ref``, the tangent state passing (the planes' hi + lo,
    the final S') against ``tangent_pass_ref``, the tangent chunk outputs
    against ``tangent_scan_ref`` of hi + lo; float32 results within
    TANGENT_TOL[float32], y' within TANGENT_TOL[bfloat16], every result
    finite.  ``steep_dt``: every dt that value, so that seg falls by
    hundreds within a chunk (a masked pair's exponent would overflow).
    Timed: each kernel's ms, its plain version's, its bound and this
    design's."""
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, torch.bfloat16)
    if steep_dt is not None:
        dt = torch.full_like(dt, steep_dt)
    A = A * (0.5 + torch.rand(B, 1, generator=gen, device=DEVICE))
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen,
                                       device=DEVICE).to(t.dtype)
                           for t in (x, dt, A, Bm, Cm))
    S, tS, seg, tseg = sops.ssd_tangent_state(x, dt, A, Bm, tx, tdt, tA, tB,
                                              chunk=chunk)
    hi, lo, thi, tlo, tstate = sops.ssd_tangent_pass(S, tS, seg, tseg,
                                                     chunk=chunk)
    ty = sops.ssd_tangent_scan(x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, hi,
                               lo, thi, tlo, chunk=chunk)
    s_in, ts_in = hi.float() + lo.float(), thi.float() + tlo.float()
    plain = {
        "ssd_tangent_state": lambda: sref.tangent_state_ref(
            x, dt, A, Bm, tx, tdt, tA, tB, chunk),
        "ssd_tangent_pass": lambda: sref.tangent_pass_ref(S, tS, seg, tseg,
                                                          chunk),
        "ssd_tangent_scan": lambda: sref.tangent_scan_ref(
            x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, s_in, ts_in, chunk)}
    want_state = plain["ssd_tangent_state"]()
    er, ter, tsr = plain["ssd_tangent_pass"]()
    yr = plain["ssd_tangent_scan"]()
    torch.cuda.synchronize()
    what = (f"T3 passes B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk}"
            + (f" dt={steep_dt}" if steep_dt is not None else ""))
    errs = {"ssd_tangent_state": max(
                check_tangent(a, b, f"{what} {n}") for a, b, n in
                zip((S, tS, seg, tseg), want_state, ("S", "S'", "seg",
                                                      "seg'"))),
            "ssd_tangent_pass": max(
                check_tangent(a, b, f"{what} {n}") for a, b, n in
                zip((s_in, ts_in, tstate), (er, ter, tsr),
                    ("s_in", "s'_in", "state'"))),
            "ssd_tangent_scan": check_tangent(ty, yr, what + " y'")}
    row = {k: {"max_abs_err": v} for k, v in errs.items()}
    if timed:
        kernel = {
            "ssd_tangent_state": lambda: sops.ssd_tangent_state(
                x, dt, A, Bm, tx, tdt, tA, tB, chunk=chunk),
            "ssd_tangent_pass": lambda: sops.ssd_tangent_pass(
                S, tS, seg, tseg, chunk=chunk),
            "ssd_tangent_scan": lambda: sops.ssd_tangent_scan(
                x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, hi, lo, thi, tlo,
                chunk=chunk)}
        for name, (nbytes, flops, design, peak) in t3_pass_costs(
                B, L, H, P, N, G, chunk).items():
            row[name].update(
                ms=time_ms(kernel[name], 20),
                plain_ms=time_ms(plain[name], 1, reps=3),
                library_ms=None, bytes=nbytes, flops=flops,
                design_flops=design)
            row[name]["bound_ms"], row[name]["bound_by"] = bound_ms(
                nbytes, flops, peak)
            row[name]["design_bound_ms"], _ = bound_ms(nbytes, design, peak)
    print(what, json.dumps(row), flush=True)
    return row


def check_ssd_tangent(sops, sref, gen, B, L, H, P, N, G, chunk, dtype,
                      per_sequence_A=False, timed=False, faults=False
                      ) -> dict:
    """T3 at one shape against its plain version (one launch); with
    ``faults``, planted faults must fail the check: the tangent state not
    carried across chunks, one chunk's rows of y' zeroed, C' dropped."""
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, dtype)
    if per_sequence_A:
        A = A * (0.5 + torch.rand(B, 1, generator=gen, device=DEVICE))
    tx, tdt, tA, tB, tC = (torch.randn(t.shape, generator=gen,
                                       device=DEVICE).to(t.dtype)
                           for t in (x, dt, A, Bm, Cm))
    args = (x, dt, A, Bm, Cm, tx, tdt, tA, tB, tC)
    call = lambda *a: sops.ssd_scan_tangent(*a, chunk=chunk)
    (ty, ts), n = counted(sops, "ssd_scan_tangent", lambda: call(*args),
                          "ssd_scan_tangent")
    wy, ws = sref.ssd_scan_tangent_ref(*args)
    what = (f"ssd tangent (B={B}, L={L}, H={H}, P={P}, N={N}, G={G}, "
            f"chunk={chunk}) {str(dtype)[6:]}"
            + (" A per sequence" if per_sequence_A else ""))
    row = dict(shape=[B, L, H, P, N, G, chunk], dtype=str(dtype)[6:],
               per_sequence_A=per_sequence_A,
               y_max_abs_err=check_tangent(ty, wy.to(dtype), what + " y'"),
               state_max_abs_err=check_tangent(ts, ws, what + " state'"))
    if faults:
        nc = L // chunk
        fresh = [call(*(t[:, i * chunk:(i + 1) * chunk].contiguous()
                        if t.ndim >= 3 else t for t in args))[0]
                 for i in range(nc)]
        zeroed = ty.clone()
        zeroed[:, chunk:2 * chunk] = 0
        planted = {"state not carried": torch.cat(fresh, 1),
                   "a chunk's rows zeroed": zeroed,
                   "C' dropped": call(*args[:9], torch.zeros_like(tC))[0]}
        for name, bad in planted.items():
            if tangent_outside(bad, wy.to(dtype))[0] == 0:
                raise AssertionError(f"{what}: planted fault '{name}' "
                                     f"passed the check")
        row["planted_faults_caught"] = list(planted)
    if timed:
        nbytes, flops = ssd_tangent_cost(B, L, H, P, N, G, chunk,
                                         x.element_size())
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
            FP32_FLOP_PER_S
        row["ms"] = time_ms(lambda: call(*args), 5)
        row["plain_ms"] = time_events(
            lambda: sref.ssd_scan_tangent_ref(*args), 1)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, rate)
        print(f"{what}: T3 {row['ms']:.4f} ms (plain {row['plain_ms']:.1f}, "
              f"bound {row['bound_ms']:.4f} {row['bound_by']}); errs "
              f"{row['y_max_abs_err']:.2e} {row['state_max_abs_err']:.2e}",
              flush=True)
    return row


def tangent_phase(fops, fref, sops, sref) -> dict:
    """T1 and T2 over the flash sweep's shapes and masks (B=2, H=4), the
    float32 rows of F32_EXTRA and the qwen2 model layout at the training
    shape; T3 over the SSD grid, a
    ragged row with two groups, A per sequence, and the mamba2 training
    and serving shapes (with planted faults); bfloat16 and float32."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for S in (128, 256, 1024):
        for d in (64, 128):
            for causal, window in ((True, None), (False, None), (True, 64)):
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(check_flash_tangents(
                        fops, fref, gen, 1, (2, 4, S, d), dtype, causal,
                        window))
    # T2's float32 kernels' other cases (T1 beside them): d = 32 and 30,
    # ragged S, GQA ratios 1, 2 and 6, rows not 16-byte aligned
    rows.append(check_flash_tangents(fops, fref, gen, 1, (2, 4, 200, 32),
                                     torch.float32, True, None))
    rows += [check_flash_tangents(fops, fref, gen, 2, (B, S, H, KV, d),
                                  torch.float32, causal, window,
                                  unaligned=un)
             for B, S, H, KV, d, causal, window, un in F32_EXTRA]
    g = FLASH_GQA_MAIN
    gqa = {str(dtype)[6:]: check_flash_tangents(
        fops, fref, gen, 2, (g["B"], g["S"], g["H"], g["KV"], g["d"]),
        dtype, True, None, timed=True)
        for dtype in (torch.bfloat16, torch.float32)}
    ssd_rows = []
    for L, chunk in ((128, 32), (256, 64), (256, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            ssd_rows.append(check_ssd_tangent(sops, sref, gen, 2, L, 2, 16,
                                              32, 2, chunk, dtype))
    for dtype in (torch.float32, torch.bfloat16):
        ssd_rows.append(check_ssd_tangent(sops, sref, gen, 2, 96, 4, 8, 16,
                                          2, 48, dtype, per_sequence_A=True))
    t, m = SSD_TRAIN, SSD_MAIN
    ssd_train = {str(dtype)[6:]: check_ssd_tangent(
        sops, sref, gen, t["B"], t["L"], t["H"], t["P"], t["N"], t["G"],
        t["chunk"], dtype, per_sequence_A=True, timed=True, faults=True)
        for dtype in (torch.bfloat16, torch.float32)}
    ssd_serve = check_ssd_tangent(sops, sref, gen, m["B"], m["L"], m["H"],
                                  m["P"], m["N"], m["G"], m["chunk"],
                                  torch.bfloat16, timed=True, faults=True)
    # T3's bf16 kernels one by one: the grid, a ragged row with two
    # groups, one chunk, seg falling past 88 within each of two chunks, and
    # the training and serving shapes, timed
    pass_rows = [check_t3_passes(sops, sref, gen, 2, L, 2, 16, 32, 2, chunk)
                 for L, chunk in ((128, 32), (256, 64), (256, 128))]
    pass_rows += [check_t3_passes(sops, sref, gen, 2, L, H, P, N, G, chunk)
                  for L, H, P, N, G, chunk in ((96, 4, 8, 16, 2, 48),
                                               (100, 4, 16, 32, 2, 100))]
    pass_rows.append(check_t3_passes(sops, sref, gen, 2, 512, 4, 16, 32, 2,
                                     256, steep_dt=4.0))
    passes = {name: check_t3_passes(sops, sref, gen, s["B"], s["L"], s["H"],
                                    s["P"], s["N"], s["G"], s["chunk"],
                                    timed=True)
              for name, s in (("train", t), ("serve", m))}
    for name, row in (("train", ssd_train["bfloat16"]), ("serve", ssd_serve)):
        p = passes[name]
        row["design_bound_ms"], _ = bound_ms(
            sum(v["bytes"] for v in p.values()),
            sum(v["design_flops"] for v in p.values()), BF16_FLOP_PER_S)
        each = ", ".join(f"{k} {v['ms']:.4f}" for k, v in p.items())
        print(f"T3 at the {name} shape, bf16: {row['ms']:.4f} ms a call "
              f"({each}); "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); this "
              f"design's bound {row['design_bound_ms']:.4f} ms; the "
              f"CUDA-core kernel it replaced {T3_SIMT_MS} ms at the train "
              f"shape (PERF.md)", flush=True)
    torch.cuda.empty_cache()
    bwd_tangent = ssd_bwd_rows(sops, sref, gen, tangent=True)
    return dict(flash_rows=rows, flash_gqa=gqa, ssd_rows=ssd_rows,
                ssd_train=ssd_train, ssd_serve=ssd_serve, passes=passes,
                pass_rows=pass_rows, bwd_tangent=bwd_tangent)


def tangent_summary(tan, train_rows) -> list:
    """The kernels-line entries of T1, T2 and T3: numbers at the training
    path's shapes in bfloat16, launches from the training runs (qwen2 for
    T1/T2, mamba2 for T3)."""
    g, t = tan["flash_gqa"]["bfloat16"], tan["ssd_train"]["bfloat16"]
    fg = FLASH_GQA_MAIN
    flash_shape = (f"(B={fg['B']}, S={fg['S']}, H={fg['H']}, KV={fg['KV']}, "
                   f"d={fg['d']}) bfloat16 causal, model layout")
    out = []
    for name, p in (("flash_attention_fwd_tangent", "fwd"),
                    ("flash_attention_bwd_tangent", "bwd")):
        out.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": None, "launches": train_rows["qwen2"]["launches"][
                name],
            "max_abs_err": g[f"{p}_max_abs_err"], "ms": g[f"{p}_ms"],
            "plain_ms": g[f"{p}_plain_ms"], "bound_ms": g[f"{p}_bound_ms"],
            "bound_by": g[f"{p}_bound_by"], "library_ms": None,
            "shape": flash_shape + ("; two launches a call (dq', then "
                                    "dk'/dv'); ms is both" if p == "bwd"
                                    else "")
                     + "; no TPU counterpart; launches: the qwen2 "
                       "training run; library: none (no PyTorch call "
                       "computes the tangent)",
            "float32": {k: v for k, v in tan["flash_gqa"]["float32"].items()
                        if k.startswith(p)},
            "sweep_checks": len(tan["flash_rows"]),
            "sweep_worst_err": max(r[f"{p}_max_abs_err"]
                                   for r in tan["flash_rows"])})
    s = SSD_TRAIN
    out.append({
        "name": "ssd_scan_tangent", "route": "cuda", "source": SSD_SOURCE,
        "replaces": None,
        "launches": train_rows["mamba2"]["launches"]["ssd_scan_tangent"],
        "max_abs_err": t["y_max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "shape": f"(B={s['B']}, L={s['L']}, H={s['H']}, P={s['P']}, "
                 f"N={s['N']}, G={s['G']}, chunk={s['chunk']}) bfloat16, A "
                 f"per sequence; no TPU counterpart; launches: the mamba2 "
                 f"training run; library: none",
        "design_bound_ms": t["design_bound_ms"],
        "float32": tan["ssd_train"]["float32"], "serving_shape":
            tan["ssd_serve"], "sweep_checks": len(tan["ssd_rows"])})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "design_bound_ms")
    train = tan["passes"]["train"]
    for name in T3_PASSES:
        out.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": None,
            "launches": train_rows["mamba2"]["launches"][name],
            **{k: train[name][k] for k in keys},
            "shape": f"(B={s['B']}, L={s['L']}, H={s['H']}, P={s['P']}, "
                     f"N={s['N']}, G={s['G']}, chunk={s['chunk']}) bfloat16, "
                     f"A per sequence; one launch a bf16 T3 call; launches: "
                     f"the mamba2 training run",
            "serving_shape": {k: tan["passes"]["serve"][name][k]
                              for k in keys},
            "sweep_worst_err": max(r[name]["max_abs_err"]
                                   for r in tan["pass_rows"])})
    return out


# ---------------------------------------------------------------------------
# Phases 13-14: LM meta-training through launch/train.py
# ---------------------------------------------------------------------------

# The training shape: 512 tokens (2 chunks of 256 for mamba2), global batch
# 16 = 4 agents x 2 tasks x (1 support + 1 query) sequence.
TRAIN_SHAPE = dict(name="chip_train_512", seq=512, batch=16)
TRAIN_COMMON = ["--agents", "4", "--seed", "0", "--prefetch", "2"]
MAMBA_TRAIN_ARGS = ["--arch", "mamba2-130m", "--shape", TRAIN_SHAPE["name"],
                    "--layers", str(MAMBA_TRAIN_LAYERS), "--fused-outer",
                    "--steps-per-dispatch", "2", "--eval-every", "2",
                    "--eval-tasks", "4", "--eval-inner-steps", "1",
                    "--ckpt-every", "2", *TRAIN_COMMON]
QWEN_TRAIN_SHAPE = dict(name="chip_train_256", seq=256, batch=16)
QWEN_TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--shape", QWEN_TRAIN_SHAPE["name"],
                   "--layers", "2", "--combine", "pallas",
                   "--steps-per-dispatch", "1", "--eval-every", "2",
                   "--eval-tasks", "2", "--eval-inner-steps", "1",
                   *TRAIN_COMMON]
# The resumed run's step-4 loss against the uninterrupted run's: the bf16
# agreement limit (the same steps on the same card; only the kernels'
# schedules may differ).
RESUME_RTOL = AGREE_RTOL["card_bf16_vs_cpu_bf16"]


def check_run_log(path: str, *flags) -> str:
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "check_run_log.py"), path,
                          *flags], capture_output=True, text=True,
                         timeout=120, check=False)
    if out.returncode:
        raise AssertionError(f"check_run_log {path} {flags}: "
                             f"{out.stdout}{out.stderr}")
    return out.stdout.strip()


def all_counts(modules) -> dict:
    return {k: n for m in modules for k, n in m.launch_counts.items()}


def profile_train_step(bundle, state, batch, modules) -> dict:
    """One meta-step under torch.profiler: wall time, device time split
    into the forward kernels, the tangent kernels, the flash backward
    kernels, the SSD backward's kernels and their tangent's (``sbw::``),
    the outer update and the rest; the chunked SSD backward and its jvp
    (their record_function ranges: CPU tensors only, so none on the card);
    the card's idle share; each kernel's launches by the wrappers'
    counters; peak memory."""
    from torch.profiler import ProfilerActivity, profile
    state, _ = bundle.step_fn(state, batch)           # warm
    torch.cuda.synchronize()
    # the warm step's cached blocks back to the card: the qwen2 cut peaks
    # within 9 GB of its 80, and a fragmented cache runs it out of memory
    torch.cuda.empty_cache()
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = bundle.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = all_counts(modules)
    peak = torch.cuda.max_memory_allocated()
    ranges = ("ssd_scan_chunked_bwd", "ssd_scan_chunked_bwd_jvp")
    split = dict(forward=0.0, tangent=0.0, flash_backward=0.0,
                 ssd_bwd=0.0, ssd_bwd_tangent=0.0, outer=0.0, other=0.0)
    in_ranges = {r: 0.0 for r in ranges}
    busy = 0.0
    for evt in prof.key_averages():
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.key in ranges)
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                not annotation:
            busy += us
            key = evt.key
            if "sbw::" in key:
                split["ssd_bwd_tangent" if "sbw::tangent_" in key
                      else "ssd_bwd"] += us
            elif "jvpk" in key or "tangent" in key:
                split["tangent"] += us
            elif any(k in key for k in SSD_FORWARD_KERNELS) or \
                    "fwd_kernel" in key:
                split["forward"] += us
            elif "dq_kernel" in key or "dkv_kernel" in key:
                split["flash_backward"] += us
            elif "fused" in key or "combine" in key:
                split["outer"] += us
            else:
                split["other"] += us
        elif evt.key in ranges and \
                evt.device_type == torch.autograd.DeviceType.CPU:
            t = getattr(evt, "device_time_total", None)
            in_ranges[evt.key] += t if t is not None else getattr(
                evt, "cuda_time_total", 0)
    row = dict(wall_s=wall, peak_gb=peak / 1e9, state_gb=base / 1e9,
               loss=float(metrics["loss"]), launches=launches)
    if busy:
        row.update(device_ms=busy / 1e3,
                   device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
                   split_ms={k: v / 1e3 for k, v in split.items()},
                   chunked_bwd_ms=in_ranges[ranges[0]] / 1e3,
                   chunked_bwd_jvp_ms=in_ranges[ranges[1]] / 1e3)
    else:
        row.update(device_ms="not measured")
    return row


def train_phase(name, cfg, args, shape, expect, log_flags, resume=False
                ) -> dict:
    """Meta-train ``cfg`` (the config ``args`` select) through
    ``launch.train.main`` in this process: 4 steps
    (``expect``: the kernels that must launch), with every launch counter
    zeroed just before and read just after; the run log must pass
    ``check_run_log.py`` with ``log_flags``; losses finite and the
    disagreement falling.  With ``resume``, a second run from the step-2
    checkpoint alone must reach the uninterrupted step-4 loss.  Then one
    meta-step of the final state is profiled."""
    from repro_torch.configs import (INPUT_SHAPES, InputShape,
                                     register_input_shape)
    from repro_torch.kernels.dif_combine import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    modules = (dops, fops, sops)
    register_input_shape(InputShape(shape["name"], shape["seq"],
                                    shape["batch"], "train"),
                         override=True)
    work = ROOT / "build" / "chip_train" / name
    shutil.rmtree(work, ignore_errors=True)
    log = str(work / "run.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    steps = 4 if resume else 2
    args = args + ["--device", DEVICE]
    out = train.main(args + ["--steps", str(steps), "--run-log", log]
                     + (["--ckpt-dir", str(work / "full")] if resume
                        else []))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_counts(modules)
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in expect if not launches.get(k)]
    if missing:
        raise AssertionError(f"train {name}: kernels {missing} never "
                             f"launched: {launches}")
    records = [json.loads(line) for line in open(log)]
    trains = [r for r in records if r["kind"] == "train"]
    if not all(math.isfinite(r["loss"]) for r in trains):
        raise AssertionError(f"train {name}: non-finite loss {trains}")
    dis = [r["disagreement"] for r in trains]
    if not dis[-1] < dis[0]:
        raise AssertionError(f"train {name}: disagreement did not fall: "
                             f"{dis}")
    config = next(r for r in records if r["kind"] == "config")
    if config["mode"] != "maml":
        raise AssertionError(f"train {name}: mode {config['mode']}")
    row = dict(seconds=seconds, launches=launches, peak_run_gb=peak_run,
               losses=[r["loss"] for r in trains], disagreement=dis,
               step_time_s=[r["step_time_s"] for r in trains],
               log_check=check_run_log(log, *log_flags),
               evals=sum(r["kind"] == "eval" for r in records))
    if resume:
        resumed_dir = work / "resume" / "seed0"
        resumed_dir.mkdir(parents=True)
        shutil.copy(work / "full" / "seed0" / "ckpt_00000002.npz",
                    resumed_dir)
        log2 = str(work / "resumed.jsonl")
        again = train.main(args + ["--steps", "2", "--run-log", log2,
                                   "--ckpt-dir", str(work / "resume")])
        a, b = again["losses"][4], out["losses"][4]
        if not abs(a - b) <= RESUME_RTOL * abs(b):
            raise AssertionError(f"train {name}: resumed step-4 loss {a} vs "
                                 f"{b} uninterrupted (rtol {RESUME_RTOL})")
        row.update(resumed_step4_loss=a, step4_loss=b,
                   resumed_log_check=check_run_log(log2, *log_flags))
        del again
    # one meta-step of the final state under torch.profiler
    if (config["arch"], config["num_layers"]) != (cfg.name, cfg.num_layers):
        raise AssertionError(f"train {name}: ran {config['arch']} at "
                             f"{config['num_layers']} layers, expected "
                             f"{cfg.name} at {cfg.num_layers}")
    bundle = S.build_train(cfg, shape["name"], config["K"],
                           combine_override=config["combine_backend"],
                           device=DEVICE)
    src = train.make_train_source(cfg, INPUT_SHAPES[shape["name"]],
                                  bundle.K, bundle.T, bundle.tb)
    with bundle.make_pipeline(src, depth=0) as pipe:
        batch = next(pipe)
    # the profiled step takes the only reference to the final state, so
    # the state it replaces is freed as it goes
    row["profile"] = profile_train_step(bundle, out.pop("state"), batch,
                                        modules)
    del out
    tangents = [k for k in expect if k in TANGENTS]
    if not all(row["profile"]["launches"].get(k) for k in tangents):
        raise AssertionError(f"train {name}: tangent kernels {tangents} "
                             f"not launched in the profiled meta-step: "
                             f"{row['profile']['launches']}")
    p = row["profile"]
    print(f"train {name}: {seconds:.1f} s for {steps} steps; step_time_s "
          f"{row['step_time_s']}; losses {row['losses']}; disagreement "
          f"{dis}; peak {peak_run:.2f} GB (run), "
          f"{p['peak_gb']:.2f} GB (one meta-step, {p['state_gb']:.2f} GB "
          f"before it); profiled step {p['wall_s']:.3f} s, device "
          f"{p.get('device_ms')} ms, idle share "
          f"{p.get('device_idle_share')}, split {p.get('split_ms')}, "
          f"chunked bwd {p.get('chunked_bwd_ms')} ms, its jvp "
          f"{p.get('chunked_bwd_jvp_ms')} ms; launches in the run {launches}, "
          f"in the profiled step {p['launches']}", flush=True)
    del bundle
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 15: one meta-step of each 2-layer cut, the card against the CPU
# ---------------------------------------------------------------------------

# PERF.md states these limits (set before the first chip run): norms over
# all leaves, and per leaf for leaves whose CPU norm is >= 1% of the
# largest leaf's.
GRAD_AGREE = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
CURV_AGREE = {torch.float32: 1e-2, torch.bfloat16: 0.3}
CURV_FLOOR = 0.5
LEAF_FLOOR = 1e-2


def _norm(d, keys=None):
    keys = list(d) if keys is None else keys
    return float(torch.sqrt(sum((d[k].double() ** 2).sum() for k in keys)))


def train_agreement_phase(arch, seq, loss_rtol, cfg=None) -> dict:
    """The ``maml`` and ``fomaml`` meta-gradients of one agent on one task
    of one sequence, the 2-layer cut at full width, on the card (kernels,
    tangent kernels) and on the CPU (plain layers) in the same dtype: the
    loss within the serving limit, the meta-gradient and its curvature
    part (maml - fomaml) within GRAD_AGREE / CURV_AGREE, the curvature at
    least CURV_FLOOR of the CPU's norm."""
    from repro_torch.configs import get_config
    from repro_torch.core import maml
    from repro_torch.data.lm_tasks import LMTaskSource
    from repro_torch.models.transformer import build_model
    if cfg is None:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
    model = build_model(cfg)
    p0 = model.init(torch.Generator().manual_seed(0), torch.float32,
                    device="cpu")
    ep = LMTaskSource(vocab_size=cfg.padded_vocab, seq_len=seq, K=1,
                      tasks_per_agent=1, task_batch=1, n_domains=4,
                      seed=0).sample(0)
    sup = {k: torch.from_numpy(v[0]) for k, v in ep.support.items()}
    qry = {k: torch.from_numpy(v[0]) for k, v in ep.query.items()}
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = {}
        for dev in (DEVICE, "cpu"):
            p = {k: v.to(dev, dtype) for k, v in p0.items()}
            s = {k: v.to(dev) for k, v in sup.items()}
            q = {k: v.to(dev) for k, v in qry.items()}
            for mode in ("maml", "fomaml"):
                t0 = time.perf_counter()
                loss, g = maml.multi_task_meta_grad(
                    model.loss_fn, p, s, q, alpha=cfg.inner_lr, steps=1,
                    mode=mode)
                got[dev, mode] = (float(loss),
                                  {k: v.float().cpu() for k, v in g.items()},
                                  time.perf_counter() - t0)
            del p
        name = str(dtype)[6:]
        card, cpu = got[DEVICE, "maml"], got["cpu", "maml"]
        lk = "card_f32_vs_cpu_f32" if dtype == torch.float32 else \
            "card_bf16_vs_cpu_bf16"
        loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        curv = {d: {k: got[d, "maml"][1][k] - got[d, "fomaml"][1][k]
                    for k in card[1]} for d in (DEVICE, "cpu")}
        norms = {k: _norm(cpu[1], [k]) for k in cpu[1]}
        big = [k for k in norms if norms[k] >= LEAF_FLOOR * max(
            norms.values())]
        cnorms = {k: _norm(curv["cpu"], [k]) for k in curv["cpu"]}
        cbig = [k for k in cnorms if cnorms[k] >= LEAF_FLOOR * max(
            cnorms.values())]
        diff = {k: card[1][k] - cpu[1][k] for k in cpu[1]}
        cdiff = {k: curv[DEVICE][k] - curv["cpu"][k] for k in cpu[1]}
        grad_rel = _norm(diff) / _norm(cpu[1])
        grad_leaf = max(_norm(diff, [k]) / norms[k] for k in big)
        curv_rel = _norm(cdiff) / _norm(curv["cpu"])
        curv_leaf = max(_norm(cdiff, [k]) / cnorms[k] for k in cbig)
        curv_ratio = _norm(curv[DEVICE]) / _norm(curv["cpu"])
        row = dict(loss_card=card[0], loss_cpu=cpu[0], loss_rel=loss_rel,
                   grad_rel=grad_rel, grad_worst_leaf_rel=grad_leaf,
                   curvature_rel=curv_rel, curvature_worst_leaf_rel=curv_leaf,
                   curvature_norm_ratio=curv_ratio,
                   curvature_share=_norm(curv["cpu"]) / _norm(cpu[1]),
                   card_s=card[2], cpu_s=cpu[2])
        print(f"train agreement {arch} {name}: {json.dumps(row)}",
              flush=True)
        fails = []
        if not loss_rel <= loss_rtol[lk]:
            fails.append(f"loss {loss_rel:.2e} > {loss_rtol[lk]}")
        if not max(grad_rel, grad_leaf) <= GRAD_AGREE[dtype]:
            fails.append(f"meta-gradient {grad_rel:.2e}/{grad_leaf:.2e} > "
                         f"{GRAD_AGREE[dtype]}")
        if not max(curv_rel, curv_leaf) <= CURV_AGREE[dtype]:
            fails.append(f"curvature {curv_rel:.2e}/{curv_leaf:.2e} > "
                         f"{CURV_AGREE[dtype]}")
        if not curv_ratio >= CURV_FLOOR:
            fails.append(f"curvature norm ratio {curv_ratio:.3f} < "
                         f"{CURV_FLOOR}")
        if fails:
            raise AssertionError(f"train agreement {arch} {name}: "
                                 + "; ".join(fails))
        rows[name] = row
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 16: few-shot classification (omniglot-cnn) through launch/fewshot.py
# ---------------------------------------------------------------------------

FEWSHOT_STEPS = 150
FEWSHOT_CPU_STEPS = 5
# The reference example's 5-way 1-shot test accuracies after 150 steps
# (examples/fewshot_classification.py --steps 150, JAX on a CPU), printed
# beside this run's.
FEWSHOT_REF_ACC = {"centralized": 0.923, "dif-maml": 0.916,
                   "non-coop": 0.946}
FEWSHOT_MIN_ACC = 0.5            # chance is 1/5
# The card's step against the CPU's from the same state: the loss within
# LOSS_RTOL, and every stepped param within FEWSHOT_PARAM_CAP, Adam's
# largest move either way (2 lr); the share of params beyond 1e-5 is
# printed.  Two things put a param beyond 1e-5 without a fault: Adam's step
# g/(|g| + eps) is steep where |g| is near eps, and a ReLU pre-activation
# within rounding of 0 (tests/test_torch_fewshot.py, KINK_SHARE) may fall
# on the other side of the kink on the card.  The same kink makes one
# device's own 5-step trajectory drift from the other's (1.5e-4 at step 5
# of centralized on an H100 with cuDNN, 8e-8 with cuDNN off): that drift is
# printed, and the step-by-step check is the one held.
FEWSHOT_PARAMS_ATOL = 1e-5
FEWSHOT_PARAM_CAP = 2e-3


def _to_device(tree, device):
    """A TrainState's tensors (dicts, tuples, named tuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree


def fewshot_cpu_agreement(label) -> dict:
    """FEWSHOT_CPU_STEPS steps of one strategy on the card, each held
    against the CPU's step from the same state (the card's, copied); and
    the drift of the two devices' own trajectories, with the card's
    convolutions on cuDNN (the path's) and on PyTorch's own CUDA kernels
    (cuDNN off, for comparison)."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_state, make_meta_step
    from repro_torch.data.episodes import host_tensors, to_device
    from repro_torch.launch import fewshot
    from repro_torch.models import FewShotCNN

    model = FewShotCNN(get_config("omniglot_cnn"))
    mcfg = fewshot.meta_config(fewshot.STRATEGIES[label])
    source = fewshot.make_source()
    steps = {d: make_meta_step(model.loss_fn, mcfg, device=d)
             for d in (DEVICE, "cpu")}
    state = init_state(torch.Generator().manual_seed(0), model.init, mcfg,
                       identical_init=True, device=DEVICE)
    alone = _to_device(state, "cpu")
    no_cudnn = _to_device(alone, DEVICE)
    loss_rel, param_err, outside_share, drift = [], [], [], []
    card_losses, drift_no_cudnn = [], []
    for i in range(FEWSHOT_CPU_STEPS):
        ep = source.sample(i)
        batch = host_tensors((ep.support, ep.query))
        on_card = to_device(batch, torch.device(DEVICE))
        cpu_state, cpu_m = steps["cpu"](_to_device(state, "cpu"), *batch)
        state, m = steps[DEVICE](state, *on_card)
        alone, alone_m = steps["cpu"](alone, *batch)
        with torch.backends.cudnn.flags(enabled=False):
            no_cudnn, raw_m = steps[DEVICE](no_cudnn, *on_card)
        loss, want = float(m["loss"]), float(cpu_m["loss"])
        card_losses.append(loss)
        loss_rel.append(abs(loss / want - 1))
        drift.append(abs(loss / float(alone_m["loss"]) - 1))
        drift_no_cudnn.append(abs(float(raw_m["loss"])
                                  / float(alone_m["loss"]) - 1))
        diffs = [(state.params[k].cpu() - cpu_state.params[k]).abs()
                 for k in state.params]
        param_err.append(max(float(d.max()) for d in diffs))
        outside_share.append(sum(int((d > FEWSHOT_PARAMS_ATOL).sum())
                                 for d in diffs)
                             / sum(d.numel() for d in diffs))
    return dict(loss_rel=loss_rel, param_max_abs_err=param_err,
                param_share_outside=outside_share,
                trajectory_drift=drift,
                trajectory_drift_cudnn_off=drift_no_cudnn,
                card_losses=card_losses)


def fewshot_phase(ops, ref, paper_A) -> dict:
    """The outer-update kernels over the CNN's 6 leaves against their plain
    versions; then ``launch.fewshot.main`` at the full omniglot-cnn config
    for FEWSHOT_STEPS steps: the three strategies on ``dense``, dif-maml
    (ATC) on ``pallas`` and on ``fused``, each run's launch counters zeroed
    just before and read just after; then each strategy's first
    FEWSHOT_CPU_STEPS steps on the card against the CPU's.  Fatal: a
    kernel's launches other than one a step, a loss that is not finite or
    does not fall, pallas or fused more than LOSS_RTOL from dense step by
    step, a card step outside the CPU agreement above (its loss, its
    params' largest difference), a test accuracy at or below
    FEWSHOT_MIN_ACC."""
    from repro_torch.configs import get_config
    from repro_torch.launch import fewshot
    from repro_torch.models import FewShotCNN

    shapes = {n: (K,) + s.shape
              for n, s in FewShotCNN(get_config("omniglot_cnn")).specs()
              .items()}
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    A = torch.as_tensor(paper_A, dtype=torch.float32, device=DEVICE)
    phi = {n: torch.randn(s, generator=gen, device=DEVICE)
           for n, s in shapes.items()}
    checks = {
        "dif_combine": check_combine_leaves(ops, ref, A, phi,
                                            "omniglot-cnn leaves"),
        "fused_combine_update": check_fused_leaves(
            ops, ref, gen, A[None].contiguous(), shapes, torch.float32,
            "omniglot-cnn leaves", kind="adam", mode="atc", step=7,
            timed=True)}
    labels = list(fewshot.STRATEGIES)

    def run(backend, which):
        ops.reset_launch_counts()
        out = fewshot.main(["--steps", str(FEWSHOT_STEPS), "--backend",
                            backend, "--strategies", *which, "--device",
                            DEVICE])
        return out, dict(ops.launch_counts)

    runs = {"dense": run("dense", labels),
            "pallas": run("pallas", ["dif-maml"]),
            "fused": run("fused", ["dif-maml"])}
    expect = {"dense": {"dif_combine": 0, "fused_combine_update": 0},
              "pallas": {"dif_combine": FEWSHOT_STEPS,
                         "fused_combine_update": 0},
              "fused": {"dif_combine": 0,
                        "fused_combine_update": FEWSHOT_STEPS}}
    dense_atc = runs["dense"][0]["dif-maml"]["loss"].numpy()
    rows, fails = {}, []
    for backend, (out, counts) in runs.items():
        if counts != expect[backend]:
            fails.append(f"{backend}: launches {counts}, expected "
                         f"{expect[backend]}")
        for label, r in out.items():
            loss = r["loss"].numpy()
            dis = r["disagreement"].numpy()
            what = f"{backend} {label}"
            first, last = float(loss[:20].mean()), float(loss[-20:].mean())
            rel_dense = float(np.max(np.abs(loss / dense_atc - 1))) \
                if label == "dif-maml" else 0.0
            if not (np.isfinite(loss).all() and np.isfinite(dis).all()):
                fails.append(f"{what}: non-finite loss or disagreement")
            if not last < 0.9 * first:
                fails.append(f"{what}: loss did not fall ({first:.4f} -> "
                             f"{last:.4f})")
            if not r["accuracy"] > FEWSHOT_MIN_ACC:
                fails.append(f"{what}: test accuracy {r['accuracy']:.3f}")
            if not rel_dense <= LOSS_RTOL:
                fails.append(f"{what}: per-step loss differs from dense by "
                             f"{rel_dense:.2e} (limit {LOSS_RTOL})")
            rows[f"{backend}/{label}"] = row = dict(
                backend=backend, strategy=label, steps=FEWSHOT_STEPS,
                ms_per_step=r["ms_per_step"], loss_first20=first,
                loss_last20=last, disagreement_last=float(dis[-1]),
                accuracy=r["accuracy"],
                reference_cpu_accuracy=FEWSHOT_REF_ACC[label],
                loss_rel_vs_dense=rel_dense, launches=counts)
            print("fewshot", json.dumps(row), flush=True)
    del runs, phi
    for label in labels:
        agree = fewshot_cpu_agreement(label)
        rows[f"dense/{label}"]["cpu_agreement"] = agree
        print(f"fewshot card vs CPU {label}", json.dumps(agree), flush=True)
        if not max(agree["loss_rel"]) <= LOSS_RTOL:
            fails.append(f"{label}: a card step's loss differs from the "
                         f"CPU's by {max(agree['loss_rel']):.2e} (limit "
                         f"{LOSS_RTOL})")
        if not max(agree["param_max_abs_err"]) <= FEWSHOT_PARAM_CAP:
            fails.append(f"{label}: a card step's params differ from the "
                         f"CPU's by {max(agree['param_max_abs_err']):.2e} "
                         f"(limit {FEWSHOT_PARAM_CAP})")
    if fails:
        raise AssertionError("fewshot: " + "; ".join(fails))
    torch.cuda.empty_cache()
    return dict(rows=rows, checks=checks,
                launches={"dif_combine": FEWSHOT_STEPS,
                          "fused_combine_update": FEWSHOT_STEPS})


# ---------------------------------------------------------------------------
# Phase 17: lm-100m through launch/decentralized_lm.py
# ---------------------------------------------------------------------------

# The example's geometry: seq 256, global batch 32 = 4 agents x 2 tasks x
# (2 support + 2 query) sequences, 4 steps.
LM100M_SEQ = 256
LM100M_ARGS = ["--steps", "4", "--agents", "4", "--seq", str(LM100M_SEQ),
               "--global-batch", "32", "--prefetch", "2"]
# Its attention calls: 4 agents x 2 tasks x 2 sequences folded into one
# batch, 8 query and 4 KV heads of 64, float32, causal.
LM100M_FLASH = dict(B=16, S=256, H=8, KV=4, d=64, dtype=torch.float32)
LM100M_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                  "flash_attention_fwd_tangent",
                  "flash_attention_bwd_tangent")


def lm100m_phase(fops, fref, modules) -> dict:
    """``launch.decentralized_lm.main`` at lm-100m's full width (12
    layers, d_model 512, vocab 32768, float32, exact MAML, K=4 on the
    ring) for 4 steps, the launch counters zeroed just before and read
    just after; then one meta-step under torch.profiler, and the float32
    flash kernels and T1/T2 at the path's attention shape against their
    plain versions, timed beside their bounds.  Fatal: a loss that is not
    finite, a disagreement that does not fall, a flash kernel or T1/T2 not
    launched in the run or in the profiled step."""
    from repro_torch.launch import decentralized_lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in modules:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    out = decentralized_lm.main([*LM100M_ARGS, "--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_counts(modules)
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    loss, dis = out["loss"].numpy(), out["disagreement"].numpy()
    if not np.isfinite(loss).all():
        raise AssertionError(f"lm-100m: non-finite loss {loss}")
    if not dis[-1] < dis[0]:
        raise AssertionError(f"lm-100m: disagreement did not fall: {dis}")
    missing = [k for k in LM100M_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"lm-100m: kernels {missing} never launched: "
                             f"{launches}")
    bundle = out["bundle"]
    source = decentralized_lm.make_source(bundle.cfg, LM100M_SEQ, bundle)
    with bundle.make_pipeline(source, depth=0) as pipe:
        batch = next(pipe)
    report = out["report"].to_record()
    s_per_step = out["s_per_step"]
    profile = profile_train_step(bundle, out.pop("state"), batch, modules)
    del out, bundle, batch
    missing = [k for k in LM100M_KERNELS if not profile["launches"].get(k)]
    if missing:
        raise AssertionError(f"lm-100m: kernels {missing} not launched in "
                             f"the profiled meta-step: "
                             f"{profile['launches']}")
    torch.cuda.empty_cache()
    g = LM100M_FLASH
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    flash = check_gqa_flash(fops, fref, gen, g["B"], g["S"], g["H"],
                            g["KV"], g["d"], g["dtype"], True, None, n=10,
                            serving=True)
    print_f32("lm-100m f32", flash)
    tangent = check_flash_tangents(fops, fref, gen, 2,
                                   (g["B"], g["S"], g["H"], g["KV"], g["d"]),
                                   g["dtype"], True, None, timed=True,
                                   faults=True)
    print(f"lm-100m f32 T2 (3xTF32): {tangent['bwd_ms']:.4f} ms for both "
          f"launches; bounds {tangent['bwd_bound_ms']:.4f} ms (float32 "
          f"rate, {tangent['bwd_bound_by']}), "
          f"{tangent['bwd_tf32_bound_ms']:.4f} ms (three TF32 products, "
          f"{tangent['bwd_tf32_bound_by']}) and "
          f"{tangent['bwd_bytes_bound_ms']:.4f} ms (bytes); the CUDA-core "
          f"kernels it replaced {T2_F32_SIMT_MS} ms (PERF.md); T1 "
          f"{tangent['fwd_ms']:.4f} ms", flush=True)
    split = profile.get("split_ms", {})
    print(f"lm-100m profiled meta-step, device ms: forward "
          f"{split.get('forward')}, T1+T2 {split.get('tangent')}, flash "
          f"backward {split.get('flash_backward')}, of "
          f"{profile.get('device_ms')} in {profile['wall_s']:.3f} s",
          flush=True)
    torch.cuda.empty_cache()
    row = dict(seconds=seconds, steps=len(loss), s_per_step=s_per_step,
               losses=loss.tolist(),
               disagreement=dis.tolist(), peak_run_gb=peak_run,
               launches=launches, eval=report, profile=profile)
    print(f"lm-100m: {seconds:.1f} s for {len(loss)} steps "
          f"({s_per_step:.3f} s a step after the first); losses "
          f"{row['losses']}; disagreement {row['disagreement']}; peak "
          f"{peak_run:.2f} GB (run), {profile['peak_gb']:.2f} GB (one "
          f"meta-step); profiled step {profile['wall_s']:.3f} s, device "
          f"{profile.get('device_ms')} ms, idle share "
          f"{profile.get('device_idle_share')}, split "
          f"{profile.get('split_ms')}; eval {json.dumps(report)}; launches "
          f"in the run {launches}", flush=True)
    return dict(row, flash=flash, tangent=tangent)


# ---------------------------------------------------------------------------
# Phase 18: adapt-then-serve through launch/serve_adapted.py
# ---------------------------------------------------------------------------

def serve_adapted_phase(modules) -> dict:
    """``launch.serve_adapted.main`` with the reference example's reduced
    arguments (qwen2-1.5b reduced: 2 training steps at K=4 into a
    checkpoint under ``build/``, the centroid restored, adapted to unseen
    domains, decoded), the launch counters zeroed just before and read just
    after.  Fatal: any failure of the run, the flash kernels not launched,
    or a serve log that ``check_run_log.py --serve`` refuses."""
    from repro_torch.launch import serve_adapted
    work = ROOT / "build" / "chip_serve_adapted"
    shutil.rmtree(work, ignore_errors=True)
    log = work / "serve.jsonl"
    for m in modules:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve_adapted.main(["--device", DEVICE, "--ckpt-root", str(work),
                              "--run-log", str(log)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_counts(modules)
    missing = [k for k in ("flash_attention_fwd", "flash_attention_bwd")
               if not launches.get(k)]
    if missing:
        raise AssertionError(f"serve_adapted: kernels {missing} never "
                             f"launched: {launches}")
    rounds = out["serve"]["rounds"]
    row = dict(seconds=seconds, launches=launches,
               serve_log_check=check_run_log(str(log), "--serve"),
               rounds=[{k: r[k] for k in ("n", "hits", "misses", "seconds")}
                       for r in rounds],
               decode_tok_s=out["serve"]["decode"]["decode_tok_s"])
    print("serve_adapted", json.dumps(row), flush=True)
    del out
    torch.cuda.empty_cache()
    return row


def paths_summary(kernels: list, fewshot: dict, lm100m: dict) -> None:
    """Adds each kernel's numbers on the example paths to its kernels-line
    entry: the outer-update kernels over the few-shot CNN's leaves and
    their launches in its pallas / fused runs; the float32 flash kernels
    and T1/T2 at lm-100m's attention shape and their launches in its
    run."""
    by_name = {k["name"]: k for k in kernels}
    for name, check in fewshot["checks"].items():
        by_name[name]["omniglot_cnn"] = dict(
            check, launches_in_run=fewshot["launches"][name],
            run=f"launch.fewshot, {FEWSHOT_STEPS} steps, dif-maml")
    g = LM100M_FLASH
    shape = (f"(B={g['B']}, S={g['S']}, H={g['H']}, KV={g['KV']}, "
             f"d={g['d']}) float32 causal, model layout")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    bwd = by_name["flash_attention_bwd"]
    q32 = bwd.pop("qwen2_float32")
    bwd["qwen2_float32"] = {
        key: q32[f"bwd_{key}"] for key in keys + (
            "library_ms", "tf32_bound_ms", "tf32_bound_by", "bytes_bound_ms")}
    for name, row, p in (
            ("flash_attention_fwd", lm100m["flash"], "fwd"),
            ("flash_attention_bwd", lm100m["flash"], "bwd"),
            ("flash_attention_fwd_tangent", lm100m["tangent"], "fwd"),
            ("flash_attention_bwd_tangent", lm100m["tangent"], "bwd")):
        by_name[name]["lm100m"] = dict(
            {key: row[f"{p}_{key}"] for key in keys},
            library_ms=row.get(f"{p}_library_ms"), shape=shape,
            **{key: row[f"{p}_{key}"] for key in (
                "tf32_bound_ms", "tf32_bound_by", "bytes_bound_ms")
               if f"{p}_{key}" in row},
            launches_in_run=lm100m["launches"][name],
            run="launch.decentralized_lm, 4 steps")

# The tensor-core instruction each Hopper namespace's kernels compile to:
# wgmma (HGMMA) in the bf16 kernels (hop) and T3's bf16 passes (t3),
# mma.sync on TF32 (HMMA) in the float32 flash forward, backward and T2
# (tf32), mma.sync on bf16 (HMMA) in the SSD backward's and its tangent's
# bf16 instantiations (sbw).
TENSOR_OPS = {"hop": "HGMMA", "t3": "HGMMA", "tf32": "HMMA", "sbw": "HMMA"}


def kernel_symbol(text: str) -> str | None:
    """"namespace::kernel<template args>" of the first mangled kernel symbol
    of namespace hop, tf32, t3, jvpk or sbw in ``text``; None for none."""
    for k in re.finditer(r"(\d)(hop|tf32|t3|jvpk|sbw)\d+([a-z_]+?)"
                         r"(?:I((?:Li\d+E|f|13__nv_bfloat16)+)E|E)", text):
        if int(k.group(1)) == len(k.group(2)):
            args = [n or ("float" if t == "f" else "__nv_bfloat16")
                    for n, t in re.findall(r"Li(\d+)E|(f|13__nv_bfloat16)",
                                           k.group(4) or "")]
            return f"{k.group(2)}::{k.group(3)}<{','.join(args)}>"
    return None


def hgmma_phase(libraries: dict) -> dict:
    """What the Hopper kernels compiled to: the tensor-core instructions
    (TENSOR_OPS) in each of them, from ``cuobjdump -sass`` of each built
    library (``libraries`` maps a name to (path, the kernels that do a
    product, as "namespace::kernel")); fails unless every kernel that does
    a product has some: the bf16 flash forward, dQ and dK/dV kernels and
    the float32 (3xTF32) forward, dQ, dK/dV and T2 kernels, the SSD
    chunk-state and
    chunk-output kernels, T3's tangent chunk-state and chunk-output
    kernels, and the SSD backward's and its tangent's state and chunk
    kernels (in their bf16 instantiations; the state passings, finish and
    reduce kernels are elementwise)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for name, (path, kinds) in libraries.items():
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, fn, op = {}, None, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_symbol(m.group(1))
                if fn and fn.split("::")[0] in TENSOR_OPS:
                    op = TENSOR_OPS[fn.split("::")[0]]
                    counts[fn] = 0
                else:
                    fn = None
            elif fn and re.search(rf"\b{op}\b", line):
                counts[fn] += 1
        print(f"sass tensor-core instructions per Hopper kernel ({name}; "
              f"{TENSOR_OPS}):", json.dumps(counts), flush=True)
        for kind in kinds:
            if not any(v for k, v in counts.items()
                       if k.startswith(kind + "<")):
                raise AssertionError(f"no tensor-core instruction in "
                                     f"{kind}: {counts}")
        found[name] = counts
    return found


def build_phase(libraries) -> None:
    """Compile every CUDA source at once (one nvcc each) and load them."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(lib.build)
                   for name, lib in libraries.items()}
        infos = {name: f.result() for name, f in futures.items()}
    for name, info in infos.items():
        print(f"build {name}: {info['seconds']:.2f} s "
              f"(compiled={info['compiled']}) -> {info['path']}", flush=True)
        fn = None
        for line in info["log"].splitlines():
            if "Function properties for" in line:
                fn = kernel_symbol(line) or line.split()[-1]
            # "Performance Loss": ptxas serialized a kernel's wgmma
            if any(k in line for k in ("registers", "spill",
                                       "Performance Loss")):
                print(f"  ptxas {fn}:", line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import SINE_MLP, get_config
    from repro_torch.core import topology
    from repro_torch.kernels.dif_combine import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.launch import quickstart
    from repro_torch.models import SineMLP
    from repro_torch.models import layers

    t_start = time.perf_counter()
    stamps = {}

    def stamp(name):
        """Seconds since the start, at the end of phase ``name``."""
        stamps[name] = time.perf_counter() - t_start
        print(f"[{stamps[name]:.1f} s] {name} done", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build_phase({"dif_combine": ops, "flash_attention": fops,
                 "ssd_scan": sops, "ssd_bwd": sops.BWD_LIB})
    hgmma = hgmma_phase({
        "flash_attention": (fops.build()["path"],
                            ("hop::fwd_kernel", "hop::dq_kernel",
                             "hop::dkv_kernel", "tf32::fwd_kernel",
                             "tf32::dq_kernel", "tf32::dkv_kernel",
                             "tf32::tangent_dq_kernel",
                             "tf32::tangent_dkv_kernel")),
        "ssd_scan": (sops.build()["path"],
                     ("hop::chunk_state_kernel", "hop::chunk_scan_kernel",
                      "t3::tangent_state_kernel",
                      "t3::tangent_scan_kernel")),
        "ssd_bwd": (sops.BWD_LIB.build()["path"],
                    ("sbw::state_kernel", "sbw::chunk_kernel",
                     "sbw::tangent_state_kernel",
                     "sbw::tangent_chunk_kernel"))})
    flash_calls = flash_calls_phase(fops)
    ssd_calls = ssd_calls_phase(sops)
    t3_calls = t3_calls_phase(sops)
    bwd_calls = bwd_calls_phase(sops)
    stamp("build")

    paper_A = topology.build_topology("paper", K, "metropolis").matrix
    kern = kernels_phase(ops, ref, SineMLP, SINE_MLP, paper_A)
    stamp("kernels")
    sine = SineMLP(SINE_MLP).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    n_groups = len({x.dtype for x in sine.values()})
    launches, ms_per_step = main_path_phase(quickstart, ops, n_groups)
    stamp("training")
    # phase 6 before phase 5: after phase 5's profile of the training step,
    # torch.profiler sessions miss some kernel launches
    flash_main, flash_rows, flash_gqa, flash_gqa_rows = flash_phase(fops,
                                                                    fref)
    stamp("flash")
    tangent = tangent_phase(fops, fref, sops, sref)
    stamp("tangents")
    # this slice's main path, LM meta-training through launch/train.py;
    # before phase 5 for the same reason as phase 6
    train_rows = {
        "mamba2": train_phase(
            "mamba2", dataclasses.replace(get_config("mamba2-130m"),
                                          num_layers=MAMBA_TRAIN_LAYERS),
            MAMBA_TRAIN_ARGS,
            TRAIN_SHAPE,
            ("ssd_scan", *SSD_PASSES, "ssd_scan_tangent", *T3_PASSES,
             "ssd_scan_bwd", *SSD_BWD_KERNELS, "ssd_scan_bwd_tangent",
             *SSD_BWD_TANGENT_KERNELS, "fused_combine_update"),
            ("--expect-fused", "--expect-outer-dtype", "bfloat16"),
            resume=True),
        "qwen2": train_phase(
            "qwen2", dataclasses.replace(get_config("qwen2-1.5b"),
                                         num_layers=2),
            QWEN_TRAIN_ARGS, QWEN_TRAIN_SHAPE,
            ("flash_attention_fwd", "flash_attention_bwd",
             "flash_attention_fwd_tangent", "flash_attention_bwd_tangent",
             "dif_combine"),
            ("--expect-outer-dtype", "bfloat16"))}
    stamp("lm training")
    # the example twins (phases 16-18), before phase 5 for the same reason
    fewshot = fewshot_phase(ops, ref, paper_A)
    stamp("fewshot")
    lm100m = lm100m_phase(fops, fref, (ops, fops, sops))
    stamp("lm-100m")
    adapted_serve = serve_adapted_phase((ops, fops, sops))
    stamp("serve_adapted")
    train_agreement = {
        "qwen2-1.5b": train_agreement_phase("qwen2-1.5b", 128, AGREE_RTOL),
        "mamba2-130m": train_agreement_phase("mamba2-130m", 512,
                                             MAMBA_AGREE_RTOL)}
    stamp("training agreement")
    profile = profile_phase("fused")
    stamp("profile")
    counters = {"flash_attention_fwd": fops, "flash_attention_bwd": fops,
                "ssd_scan": sops, **{k: sops for k in SSD_PASSES}}
    # per layer and step: one flash forward launch, and the backward's two
    # (dK/dV and dQ); one bf16 SSD scan call, a launch of each of its three
    # kernels, and one call of its backward, a launch of each of its five
    serve_row = serve_phase(SERVE_ARGS, counters, lambda n, k: {
        "flash_attention_fwd": n * k, "flash_attention_bwd": 2 * n * k})
    stamp("serve")
    agreement = agreement_phase()
    # the float32 backward (3xTF32) at the shape this phase's f32 adaptation
    # gives it: 2 sequences of 256, qwen2's 12 / 2 heads of 128
    agreement["flash_f32"] = check_gqa_flash(
        fops, fref, torch.Generator(device=DEVICE).manual_seed(12), 2, 256,
        12, 2, 128, torch.float32, True, None, n=5)
    stamp("agreement")
    ssd_main, ssd_rows, continuity, ssd_passes, ssd_pass_rows, ssd_bwd = \
        ssd_phase(sops, sref, layers)
    stamp("ssd")
    mamba_row = serve_phase(MAMBA_SERVE_ARGS, counters,
                            lambda n, k: {"ssd_scan": n * k,
                                          **{p: n * k for p in SSD_PASSES},
                                          "ssd_scan_bwd": n * k,
                                          **{p: n * k for p in
                                             SSD_BWD_KERNELS}},
                            replay=("profile", "memory"))
    stamp("mamba2 serve")
    mamba_agreement = agreement_phase(
        dataclasses.replace(get_config("mamba2-130m"), num_layers=2),
        MAMBA_AGREE_RTOL, seq=1024, task_batch=4)

    mc, fs, large = kern["main_combine"], kern["fused_step"], kern["large"]
    summary = {"kernels": [
        # library_ms: no one PyTorch call combines a dict of leaves; the
        # single-buffer rows in "large" carry cuBLAS's time
        {"name": "dif_combine", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["dif_combine"],
         "launches": launches["pallas"]["dif_combine"],
         "max_abs_err": mc["max_abs_err"], "ms": mc["ms"],
         "plain_ms": mc["plain_ms"], "bound_ms": mc["bound_ms"],
         "bound_by": mc["bound_by"], "library_ms": None,
         "shape": f"the {mc['leaves']} sine leaves (K=6, {mc['columns']} "
                  f"columns), float32, one launch per step",
         "large": large["dif_combine"],
         "qwen2_layer": kern["qwen2"]["dif_combine"]},
        {"name": "fused_combine_update", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_combine_update"],
         "launches": launches["fused"]["fused_combine_update"],
         "max_abs_err": fs["max_abs_err"], "ms": fs["ms"],
         "plain_ms": fs["plain_ms"], "bound_ms": fs["bound_ms"],
         "bound_by": fs["bound_by"], "library_ms": None,
         "shape": f"the {fs['leaves']} sine leaves (K=6, {fs['columns']} "
                  f"columns), adam/atc, float32, one launch per step",
         "large": [r for r in large["fused_combine_update"]
                   if r["kind"] == "adam" and r["mode"] == "atc"
                   and r["gate"] == 1.0 and r["S"] == 1],
         "qwen2_layer": kern["qwen2"]["fused_combine_update"],
         "capture": kern["capture"]},
        *(flash_summary(name, flash_main, serve_row, flash_rows, flash_gqa,
                        flash_gqa_rows, flash_calls)
          for name in ("flash_attention_fwd", "flash_attention_bwd")),
        *ssd_summary(ssd_main, ssd_rows, continuity, ssd_passes,
                     ssd_pass_rows, ssd_calls, mamba_row),
        *tangent_summary(tangent, train_rows),
        *ssd_bwd_summary(ssd_bwd, tangent["bwd_tangent"], train_rows,
                         mamba_row),
    ], "ms_per_step": ms_per_step, "train": train_rows,
        "fewshot": fewshot["rows"], "lm100m": lm100m,
        "serve_adapted": adapted_serve,
        "train_agreement": train_agreement, "profile": profile, "serve": serve_row,
        "agreement": agreement, "mamba2_serve": mamba_row,
        "mamba2_agreement": mamba_agreement, "hgmma": hgmma,
        "outer_update_ablation": kern["ablation"],
        "flash_kernels_per_call": flash_calls,
        "ssd_bwd_kernels_per_call": bwd_calls,
        "phase_end_seconds": stamps,
        "seconds": time.perf_counter() - t_start}
    paths_summary(summary["kernels"], fewshot, lm100m)
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
