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
                bf16 flash forward, dQ and dK/dV kernels and T1's and T2's
                three bf16 tangent kernels, the SSD
                chunk-state and chunk-output kernels and T3's tangent
                chunk-state and chunk-output kernels and the SSD backward's
                and its tangent's bf16 state, gram and chunk kernels, HMMA
                (mma.sync on TF32) in the float32 flash forward, dQ and
                dK/dV kernels, T1's and T2's float32 kernels, the SSD
                scan's float32 chunk-state and chunk-output kernels
                (namespace tfs) and the SSD backward's and its tangent's
                float32 state, gram and chunk kernels (namespace tbw);
                each must have some.  Then one
                call of ``gqa_flash_attention`` at the serving shape must
                run one kernel forward and two backward, one bf16 T1 call
                ``hop::tangent_fwd_kernel`` alone and one bf16 T2 call
                ``hop::tangent_dq_kernel`` and ``tangent_dkv_kernel``,
                at lm-100m's shape
                one float32 forward its one kernel, one float32 backward its
                two, one float32 T1 ``tf32::tangent_fwd_kernel`` alone and
                one float32 T2 its two, one bf16 SSD scan call the
                SSD's three hop kernels and one float32 call the three
                tfs kernels, one bf16 ``ssd_scan_tangent`` call
                T3's three, one bf16 ``ssd_scan_bwd`` and one
                ``ssd_scan_bwd_tangent`` call their six each (namespace
                ``hbw`` and the shared state passing) and one float32
                ``ssd_scan_bwd`` and one ``ssd_scan_bwd_tangent`` call
                their six each (namespace ``tbw`` and the shared state
                passing), and nothing
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
                schedule) against eager calls.  (The study of copies of the
                source without stores, without the mix and with 1, 3 or 4
                ring stages, ``python -m
                repro_torch.kernels.dif_combine.ablate``, ran here until
                the encoder-decoder phases came in.)  The single-buffer
                fused rows are timed at Adam/ATC, gate 1, one schedule row
                only; the others are checked.
4. training  -- runs ``python -m repro_torch.launch.quickstart`` (K=6 agents
                on the paper's Fig. 2a graph, ATC, exact MAML, Adam) for 300
                steps with ``--backend dense``, ``pallas`` and ``fused`` from
                one init and one episode stream, and 5 steps on the CPU as a
                reference.  Losses must be finite and fall, disagreement stay
                small, the backends agree step by step, and each kernel's
                launch counter, zeroed just before its run, show its launches.
5. profile   -- device time per step of the fused training step
                (torch.profiler, 20 steps), to show where a step's time
                goes.
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
                at full width cut to 2 of its 28 layers (``--layers 2``;
                bfloat16, fresh init from seed 0; 4 users x 4 sequences x
                256 tokens, 2 adapt steps, 2 rounds, 128 prompt + 128
                generated tokens).  The flash launch counters, zeroed just
                before, must show 2 x 2 forward and 2 x 2 x 2 backward
                launches (one adapt dispatch; the
                backward is a dK/dV and a dQ kernel); round 1 has 4
                misses and round 2 4 hits; every adapted leaf is finite; each
                user's support loss falls with adaptation; 256 tokens come
                out per sequence.  (Users of one domain share a cache entry,
                as in the reference: a hit returns the state of the
                domain's last adapted user, and that user's support loss
                must stay below the launch model's.)  Prints adapt,
                compress and SVD seconds, tok/s and peak device memory by
                stage.
8. agreement -- the same config cut to 2 layers, one set of weights and one
                episode (one sequence of 256 tokens): the launch and adapted support and query losses on
                the card (kernels) match a CPU run of the port (plain
                versions) in the same dtype, within 2e-2 relative in
                float32 and 1e-3 in bfloat16, and adaptation lowers the
                support loss in every run.  The
                CPU's bf16 losses against its f32 ones are reported.  The
                float32 flash backward is then held at 2 x 256 (12 / 2
                heads of 128) against autograd and its
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
                of the CUDA-core kernel it replaced.  The float32 route's
                call (three launches, namespace tfs) and each of its
                kernels against their plain versions on the grid, a
                ragged row, one chunk of 100 rows, widths no multiple of 4
                and seg falling past 88, A shared and per sequence, then
                timed at the serving and training shapes and one 512-token
                sequence beside the float32-rate, three-TF32-product and
                bytes bounds (each pass too) and the CUDA-core kernel it
                replaced.  Then the scan's
                backward (``ssd_scan_bwd``, six launches of
                ``csrc/ssd_bwd.cu`` in either dtype) against its
                three plain passes
                composed, within SSD_BWD_TOL: the grid, a ragged row (chunk
                48, A per sequence), full-width heads, one chunk of 100
                rows and seg falling past 88, in both dtypes, and the
                mamba2 training and serving shapes (both dtypes), timed
                beside the plain version, the chunked VJP it replaced and
                the bound (in float32 also the three-TF32-product one; and
                each wrapper and each of the chunk wrapper's four launches
                alone), with planted
                faults (the state cotangent not carried, dA without a
                chunk's term, dB not summed over a group's heads) that must
                fail; every row's second call must give the same bits.
10. mamba2 serve -- runs ``python -m repro_torch.launch.serve --arch
                mamba2-130m --layers 6 --prompt-len 512 --gen 512`` at
                full width cut to 6 of its 24 layers (bfloat16, fresh init
                from seed 0; 4 users x 4 sequences x 1024 tokens, 2 adapt
                steps, 2 rounds).  The ssd_scan and ssd_scan_bwd call
                counters and each of their kernels' launch counters, zeroed
                just before, must show 6 x 2 (one adapt dispatch); 4
                misses then 4 hits; finite adapted leaves; falling support
                losses; 1024 tokens a sequence.  Prints the serve phase's
                numbers as phase 7 does, the device time of one more
                dispatch split between the forward kernels and the
                backward's kernels by name (torch.profiler).
11. mamba2 agreement -- phase 8 for mamba2-130m cut to 2 layers at full
                width, one episode of 1 x 1024 tokens: float32 within 1e-4
                relative, bfloat16 within 1e-3.
12. tangents -- holds the forward-mode tangent kernels against
                ``torch.func.jvp`` of their plain versions: T1 (flash
                forward tangent) and T2 (flash backward tangent, two
                launches) over phase 6's sweep (B=2, H=4, S in {128, 256,
                1024} x d in {64, 128} x three masks x two dtypes) and the
                qwen2 model layout at the training shape (B=16, S=256,
                H=12, KV=2, d=128, causal; timed; planted faults: o' rows
                zeroed, T2's results' rows zeroed, T2 without lse'), and
                rows as phase 6's float32 ones in both dtypes (d = 30 and
                32, ragged S, GQA ratios 1, 2 and 6, unaligned views);
                T1 and T2 in both dtypes on values sharing a mean
                (SHARED_MEAN: the shapes where a P rounded once to bf16,
                without its lo half, falls outside the tolerance); T3
                (the SSD scan's tangent)
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
                (``ssd_scan_bwd_tangent``, the backward's passes on dual
                numbers) over phase 9's backward rows, the same way, and at
                the serving shape in float32 too; each float32 row timed
                beside its float32-rate and 3xTF32 bounds and the CUDA-core
                kernels it replaced (SSD_BWD_TANGENT_F32_SIMT_MS).
                Runs before phase 5, as phase 6.
13. mamba2 training -- this slice's main path: ``launch.train.main`` in
                this process on mamba2-130m at full width cut to 4 of its
                24 layers (``--layers 4``; bf16, fresh init from seed 0),
                K=4 agents on the ring,
                exact MAML, ``--fused-outer``, a registered 512-token shape
                with global batch 16 (2 tasks x 1 sequence an agent), 4
                steps in dispatches of 2, eval every 2 steps (4 tasks, 1
                adaptation step); the launch counters
                are zeroed just before and read just after, and the SSD
                kernels, T3, the scan's backward and its tangent
                (``ssd_scan_bwd``, ``ssd_scan_bwd_tangent``, each of their
                six bf16 kernels) and the fused update must have launched;
                the
                losses are finite, the disagreement falls, the run log
                passes ``scripts/check_run_log.py --expect-fused``.  Then 2
                steps that save the step-2 checkpoint and 2 more resumed
                from it alone (``--ckpt-every 0``: no write; the chip
                machine bounds what a call writes to 45 GiB) must reach the
                uninterrupted step-4 loss within 1e-3, and one meta-step of
                the resumed state is profiled (device time split, idle share,
                peak memory, T3 and the backward's tangent launched; the
                SSD backward and its tangent reported by kernel name).
14. qwen2 training -- the same for qwen2-1.5b at full width cut to 2
                layers, ``--combine pallas``, 256 tokens, 2 steps: the
                flash kernels, T1, T2 and ``dif_combine`` must launch.
15. training agreement -- one ``maml`` and one ``fomaml`` meta-gradient of
                each 2-layer cut (one agent, one task of one sequence:
                64 tokens for qwen2, 512 for mamba2) on
                the card and on the CPU in the same dtype: the loss within
                phase 8's / 11's limits, the meta-gradient within 1e-3
                (f32) / 5e-2 (bf16) of the CPU's norm, its curvature part
                (maml - fomaml) within 1e-2 / 0.3 and at least half the
                CPU's norm (over all leaves, and per leaf for leaves whose
                CPU norm is at least 1% of the largest).  Its CPU half
                runs first, while nvcc builds the kernels (so do those of
                phases 21, 26 and 29).  Then one float32
                ``maml`` meta-gradient of mamba2's cut is profiled on the
                card (``meta_grad_split``): the device time, launches and
                shares of the SSD scan's forward kernels, T3's, the
                backward's and its tangent's.
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
19. deepseek serve -- ``launch/serve.py`` with phase 7's arguments on
                deepseek-v2-lite-16b at full width (d_model 2048, 16 MLA
                heads, kv_lora 512, 64 experts top-6 + 2 shared of 1408,
                vocab 102400) cut to 2 of its 27 layers (the dense layer 0
                and one MoE layer; bf16, fresh init from seed 0): 4 misses
                then 4 hits, finite adapted leaves, falling support losses,
                256 tokens a sequence, and no flash or SSD kernel launched
                (MLA's attention is the plain one by name: q/k head 192, v
                head 128; the route is printed).  Prints phase 7's numbers.
20. deepseek training -- phase 13 for the same cut: ``fomaml``, momentum,
                ``--fused-outer``, 256 tokens, global batch 16, eval of one
                task an agent (K x tasks adapted copies of 2.17 GB), one
                ``fused_combine_update`` launch a step (2 steps); then 2
                steps with ``--combine pallas`` (no eval), one
                ``dif_combine`` launch a step; then phase 13's checkpoint
                and resume on deepseek at reduced width (the same blocks
                and leaf names; at the cut's full width a 17.4 GB
                checkpoint is written and read); then both outer-update
                kernels over the cut's 31 leaves at K=4 (1,085 M columns,
                bf16, momentum/ATC) against their plain versions leaf by
                leaf, timed beside the plain versions and the bounds.
21. MoE agreement -- phases 8 and 15 (``fomaml`` only) for deepseek's
                cut and reduced mixtral-8x22b, one task of one sequence of
                128 tokens, one set of weights a model: losses within 1e-4 (f32) / 1e-3
                (bf16), the meta-gradient within phase 15's limits (in bf16
                the routed experts' and router's leaves through the norm
                over all leaves only), and the share of (token, choice)
                pairs routed to another expert on the card than on the CPU
                within 1e-3 (f32) / 2e-2 (bf16).
22. MoE dispatch -- ``moe_apply_einsum`` against ``moe_apply_sorted`` on
                the card at deepseek's MoE layer width (2 x 128 tokens, f32,
                capacity ample): within 1e-5 of the largest |value|; each
                path's time.
23. encoder-decoder flash -- the flash forward and backward (against
                ``attention_ref``'s autograd and the plain backward) and T1
                and T2 (against their plain versions), bf16 and float32, in
                the model's layout at the shapes whisper-large-v3 and
                llama-3.2-vision give them, non-causal: the encoder (4 x
                1500 frames, 20 heads of 64: a last key tile of 28), the
                cross-attention (256 queries against 1500 keys), reduced
                llama-vision's cross-attention (64 queries, 4 heads, against
                16 keys with 2 KV heads); and causal rows with S < S_k and
                S > S_k.  The encoder and cross rows timed at the serving
                batch (16 sequences) in bf16 beside their bounds and SDPA's
                times.  Keys 1472-1499 zeroed in the kernels' input only
                must fail the check (the last, partial key tile is read),
                for the forward and backward and for bf16 T1 and T2.
24. whisper serve -- phase 7 for whisper-large-v3 at full width (d_model
                1280, 20 heads of 64, d_ff 5120, vocab 51866, 1500 zero
                frames) cut to 4 encoder + 4 decoder layers: 3 flash
                forward and 6 backward launches a layer and adapt step
                (encoder, decoder, cross), and the encoder's forward once
                more for the decode's cross K/V; one more adapt dispatch
                under torch.profiler, and one more with the flash launches
                told apart by their query and key lengths and mask (the
                encoder's 1500 x 1500, the decoder's causal 256 x 256, the
                cross-attention's 256 x 1500): each role n x k forward and
                2 n x k backward launches.
25. whisper training -- phase 13 for whisper cut to 2 + 2 layers: exact
                MAML (the flash kernels, T1 and T2), Adam, bf16, K=4 on the
                ring, T=2, 256 tokens, ``--fused-outer``, eval, checkpoint
                and resume, one profiled meta-step (T1 and T2 apart, and
                their calls tallied by shape); then bf16 T1 and T2 timed
                apart at the encoder's 1500 x 1500, the cross-attention's
                256 x 1500 and the decoder's causal 256 x 256, at the batch
                of the profiled step's calls, beside their bounds, the
                plain versions' times at 2 sequences (the first sequences
                held against the plain versions); then 2 steps with
                ``--combine pallas``.
26. encoder-decoder agreement -- phase 15 for whisper cut to 1 + 1 layers
                (``maml`` and ``fomaml``, so the curvature part is held as
                in phase 15; one sequence of 128 tokens and 1500 random
                frames) and for
                reduced llama-vision (``fomaml``, 16 random patches; and
                phase 8's losses), every cross gate set to 0.5 first (at its
                zero init the cross path carries nothing): losses within
                1e-4 (f32) / 1e-3 (bf16), the meta-gradient within phase
                15's limits, the cross leaves' largest error printed apart.
27. new-config flash -- the bf16 flash forward and backward in the
                model's layout, causal, against ``attention_ref``'s autograd
                and the plain backward, at the full-width attention shapes
                of the last configurations: qwen2-7b at the serving shape
                (16 x 256 tokens, 28 query heads over 4 KV heads of 128),
                codeqwen1.5-7b (32 over 32), command-r-35b (64 over 8),
                and one qwen2-7b KV group (7 over 1) at 10240 tokens under
                qwen2-7b-swa's window of 8192; each timed beside its bound
                and SDPA's time.
28. qwen2-7b serve -- phase 7 for qwen2-7b at full width (d_model 3584,
                28/4 heads of 128, d_ff 18944, vocab 152064) cut to 2 of
                its 28 layers (1.556 B parameters, bf16, fresh init from
                seed 0): one flash forward and two backward launches a
                layer and adapt step; phase 7's numbers.
29. new-config agreement -- phases 8 and 15 for reduced qwen2-7b,
                qwen2-7b-swa (128 tokens against its reduced window of 64),
                codeqwen1.5-7b, command-r-35b and jamba-1.5-large-398b
                (one period of 8 layers), ``maml`` and ``fomaml``, one
                sequence of 128 tokens: losses within 1e-4 (f32) / 1e-3
                (bf16), the meta-gradient and its curvature part within
                phase 15's limits; jamba in float32 with an inner step of
                lr 1e-5 (at its config's 1e-2, and in bfloat16 at either,
                float32 and bfloat16 themselves lie far from float64:
                JAMBA_AGREE_LR), its bfloat16 meta-gradients and
                routing choices no further than 2x the CPU's bfloat16 ones
                from the CPU's float32 ones (BF16_WITNESS), and so its
                bfloat16 adapted losses, T1, T2, T3 and the SSD backward's tangent
                launched in its meta-gradients, and its float32
                routing-flip share within 1e-3.
30. jamba -- reduced jamba through ``launch/serve.py`` (float32, 4 users
                x 4 x 128 tokens: 4 misses then 4 hits, the hybrid decode
                cache, and in the adapt dispatch the float32 flash, SSD
                scan and SSD backward kernels launched a layer and step as
                its plan gives) and ``launch/train.py`` (``fomaml``, SGD,
                bf16, ``--fused-outer``: its 142 leaves in three launches a
                step, 48 a launch; eval, checkpoint and resume within
                1e-3).
Phases 16-18 run after phase 14, before phase 15; phases 23 and 27
right after phase 6; phases 19-22, 24-26 and 28-30 after phase 15, before
phase 5.

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
# The float32 route's three kernels (namespace tfs, 3xTF32 mma.sync), by
# their launch-count keys, and the profiler names a float32 call must run.
SSD_F32_PASSES = {"ssd_f32_chunk_state": "tfs::chunk_state_kernel",
                  "ssd_f32_state_pass": "tfs::state_pass_kernel",
                  "ssd_f32_chunk_scan": "tfs::chunk_scan_kernel"}
# The SSD scan's forward kernels as torch.profiler names them: the passes
# of either route (tfs's share hop's names), and the one-launch float32
# kernel that tfs replaced (an earlier commit's, profiled by
# scripts/profile_f32_meta_grad.py).
SSD_FORWARD_KERNELS = (*SSD_PASSES.values(), "ssd_scan_kernel")
# T3's three bf16 kernels (launch-count keys, and their profiler names): the
# forward's passes with the tangent plane beside each.
T3_PASSES = {"ssd_tangent_state": "tangent_state_kernel",
             "ssd_tangent_pass": "tangent_pass_kernel",
             "ssd_tangent_scan": "tangent_scan_kernel"}
# The scan backward's kernels in bfloat16, as the training and serve runs
# call it (launch-count keys, and the names torch.profiler reports them
# by): five of namespace hbw and the state passing the routes share
# (ssd::pass_kernel), in launch order; and its tangent's.
SSD_BWD_KERNELS = {"ssd_bwd_state": "hbw::state_kernel",
                   "ssd_bwd_pass": "ssd::pass_kernel",
                   "ssd_bwd_gram": "hbw::gram_kernel",
                   "ssd_bwd_chunk": "hbw::chunk_kernel",
                   "ssd_bwd_finish": "hbw::finish_kernel",
                   "ssd_bwd_reduce": "hbw::reduce_kernel"}
SSD_BWD_TANGENT_KERNELS = {
    k.replace("ssd_bwd_", "ssd_bwd_tangent_"): v.replace("::", "::tangent_")
    for k, v in SSD_BWD_KERNELS.items()}
# The float32 backward's and tangent's: namespace tbw's (3xTF32 mma.sync)
# and the shared state passing, under the same launch-count keys.
SSD_BWD_F32_KERNELS = {k: v.replace("hbw::", "tbw::")
                       for k, v in SSD_BWD_KERNELS.items()}
SSD_BWD_TANGENT_F32_KERNELS = {
    k: v.replace("hbw::", "tbw::")
    for k, v in SSD_BWD_TANGENT_KERNELS.items()}
# The namespaces of ssd_bwd.cu's kernels (torch.profiler's names): the
# bf16 route, the float32 route (backward and tangent) and the state
# passing they share.  The forward's kernels (ssd_scan.cu: hop, tfs) are
# told by SSD_FORWARD_KERNELS, T3's by SSD_T3_NAMESPACES.
SSD_BWD_NAMESPACES = ("hbw::", "tbw::", "ssd::")
SSD_T3_NAMESPACES = ("t3::", "jvpk::")


def is_ssd_bwd(key: str) -> bool:
    return any(n in key for n in SSD_BWD_NAMESPACES)


def ssd_role(key: str) -> str | None:
    """Which SSD path a profiler key's kernel belongs to: "ssd_fwd" (the
    scan's passes, or the float32 kernel tfs replaced), "ssd_t3" (the
    scan's tangent), "ssd_bwd" or "ssd_bwd_tangent" (ssd_bwd.cu's); None
    for another kernel."""
    if any(n in key for n in SSD_T3_NAMESPACES):
        return "ssd_t3"
    if is_ssd_bwd(key):
        return "ssd_bwd_tangent" if "::tangent_" in key else "ssd_bwd"
    if any(k in key for k in SSD_FORWARD_KERNELS):
        return "ssd_fwd"
    return None


def short_kernel(key: str) -> str:
    """A profiler key as "namespace::kernel" where it names one of the
    port's kernel namespaces (the anonymous namespace left out), else its
    text before the argument list."""
    m = re.search(r"\b(hop|tfs|t3|jvpk|hbw|tbw|ssd|tf32)::(\w+)", key)
    return m.group(0) if m else key.split("(")[0].replace("void ", "")[:60]

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
# table), printed beside this run's time; and the one-launch CUDA-core
# kernel that the float32 route replaced, at the serving shape (PERF.md,
# row 5) and the float32 backward's CUDA-core kernels at the mamba2
# training shape (PERF.md, row 9).
SSD_SIMT_MS = 2.284
SSD_F32_SIMT_MS = 2.337
SSD_BWD_F32_SIMT_MS = 1.6364
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
# The same for T1 in float32 at lm-100m's attention shape and the SSD
# backward's tangent in float32 at the mamba2 training shape (A per
# sequence), both on the CUDA cores before this design (PERF.md, section
# 6, rows 6 and 10).
T1_F32_SIMT_MS = 0.2487
SSD_BWD_TANGENT_F32_SIMT_MS = 17.676
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
# qwen2-1.5b serves at full width cut to QWEN_SERVE_LAYERS of its 28 layers,
# to keep the script inside its time limit (PERF.md §4: on an H100 the
# whole script took 886 s with 28 layers, 784 s with 8; 2 since the MoE
# phases came in: at 4 layers it took 977-1136 s).
QWEN_SERVE_LAYERS = 2
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--layers", str(QWEN_SERVE_LAYERS),
              "--batch", "4",
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
# both at 24 layers (PERF.md, section 6); 8 and 12 layers until the MoE
# phases came in (PERF.md §4), 4 and 6 since.
MAMBA_TRAIN_LAYERS = 4
MAMBA_SERVE_LAYERS = 6
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
                        # timed: the row the kernels line reports
                        large["fused_combine_update"].append(check_fused(
                            ops, ref, gen, kind, mode, gate, S, LARGE_M,
                            dtype, timed=(kind, mode, gate, S) == (
                                "adam", "atc", 1.0, 1)))
        torch.cuda.empty_cache()
    capture = capture_row(ops, SineMLP, SINE_MLP)
    return dict(main_combine=main_combine, fused_step=fused_step,
                qwen2=qwen2, large=large, capture=capture)


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

def flash_cost(B, H, S, d, itemsize, pairs_per_head, backward, KV=None,
               Sk=None):
    """(bytes, flops) of one forward or backward: every input read once and
    every output written once, K and V (and dK, dV) with their KV heads
    (H unless given) and their S_k rows (S unless given); 4 d flops per
    allowed (query, key) pair and query head in the forward (q.k and p.v),
    10 d in the backward (the recomputed scores, dP, dV, dK and dQ).
    ``pairs_per_head`` counts the pairs the mask allows in this run."""
    tile = B * H * S * d * itemsize
    kv_tile = B * (H if KV is None else KV) * (S if Sk is None else Sk) \
        * d * itemsize
    rows = B * H * S * 4                                # one float32 a row
    if backward:   # q, k, v, out, dO and lse in; dq, dk, dv out
        return (4 * tile + 4 * kv_tile + rows,
                10.0 * d * pairs_per_head * B * H)
    return 2 * tile + 2 * kv_tile + rows, 4.0 * d * pairs_per_head * B * H


def tf32_bound(row, phase, cost) -> None:
    """A float32 row's second bound of ``phase`` (the keys' prefix: "fwd",
    "bwd", "t3" or "call"), this design's: its products as three TF32 products at the TF32 tensor rate,
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
    card at the serving shape, forward and backward, one bf16 T1 and T2
    call at the same shape, and one float32 forward, backward, T1 and T2
    call at lm-100m's shape, from torch.profiler; fails unless each forward
    and T1 runs its one kernel and each backward and T2 its two (bf16 T1
    and T2: hop's tangent kernels; float32: tf32's), with no copy,
    expansion or reduction beside them.  Run before the
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
    # T1 and T2 in bf16 at the same shape (qwen2's training shape): hop's
    # tangent kernels and nothing else
    q, k, v = (t.detach() for t in leaves)
    out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, **kw)
    tq, tdo = (torch.randn_like(q) for _ in "qo")
    tk, tv = (torch.randn_like(k) for _ in "kv")
    t1 = lambda: fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv,
                                                  heads_dim=2, **kw)
    to, tlse = t1()
    t2 = lambda: fops.flash_attention_bwd_tangent(
        q, k, v, out, lse, do, tq, tk, tv, to, tlse, tdo, heads_dim=2, **kw)
    t2()
    row["fwd_tangent"] = device_kernels(t1)
    row["bwd_tangent"] = device_kernels(t2)
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
    t1_32 = lambda: fops.flash_attention_fwd_tangent(
        q32, k32, v32, lse32, tq, tk, tv, heads_dim=2)
    to, tlse = t1_32()
    t2 = lambda: fops.flash_attention_bwd_tangent(
        q32, k32, v32, out32, lse32, do32, tq, tk, tv, to, tlse, tdo,
        heads_dim=2)
    t2()
    row["fwd_float32"] = device_kernels(fwd32)
    row["bwd_float32"] = device_kernels(bwd32)
    row["fwd_tangent_float32"] = device_kernels(t1_32)
    row["bwd_tangent_float32"] = device_kernels(t2)
    print("flash kernels per call", json.dumps(row), flush=True)
    if len(row["fwd"]) != 1 or len(row["bwd"]) != 2:
        raise AssertionError(
            f"a gqa_flash_attention forward call ran {row['fwd']} and its "
            f"backward {row['bwd']} on the card; expected the forward "
            f"kernel alone and the two backward kernels")
    for key, parts in (("fwd_tangent", ("hop::tangent_fwd_kernel",)),
                       ("bwd_tangent", ("hop::tangent_dq_kernel",
                                        "hop::tangent_dkv_kernel"))):
        names = row[key]
        if len(names) != len(parts) or not all(
                sum(part in x for x in names) == 1 for part in parts):
            raise AssertionError(
                f"a bf16 flash_attention_{key} call ran {names} on the "
                f"card; expected {parts} and nothing else")
    for key, call, n, part in (
            ("fwd_float32", "gqa_flash_attention_fwd_lse", 1, "fwd_kernel"),
            ("bwd_float32", "gqa_flash_attention_bwd", 2, "d"),
            ("fwd_tangent_float32", "flash_attention_fwd_tangent", 1,
             "tangent_fwd_kernel"),
            ("bwd_tangent_float32", "flash_attention_bwd_tangent", 2,
             "tangent_d")):
        names = row[key]
        if len(names) != n or not all("tf32::" + part in x for x in names):
            raise AssertionError(
                f"a float32 {call} call ran {names} on the card; expected "
                f"its {n} tf32 kernel(s) and nothing else")
    return row


def check_gqa_flash(fops, fref, gen, B, S, H, KV, d, dtype, causal, window,
                    n=10, serving=False, timed=True, unaligned=False,
                    Sk=None):
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
    aligned; ``Sk``: keys and values of another length than the queries
    (cross-attention)."""
    dev = torch.device(DEVICE)
    Sk = S if Sk is None else Sk
    q, do = (randn_view(gen, (B, S, H, d), dtype, unaligned) for _ in "qo")
    k, v = (randn_view(gen, (B, Sk, KV, d), dtype, unaligned) for _ in "kv")
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
    what = (f"gqa flash B={B} S={S} Sk={Sk} H={H} KV={KV} d={d} "
            f"{str(dtype)[6:]} causal={causal} window={window}"
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
             sk.reshape(B, KV, rep, Sk, d).sum(2).transpose(1, 2), 0.0)
    bwd_err = max(compare(g, want_g, dtype, f"{what} d{name}",
                          tol["bwd"], sl + row_atol(want_g))
                  for g, want_g, sl, name in zip((dq, dk, dv), grads, slack,
                                                 "qkv"))
    pairs = int(fref.band_mask(S, Sk, causal, window, dev).sum())
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    row = dict(B=B, S=S, Sk=Sk, H=H, KV=KV, d=d, dtype=str(dtype)[6:],
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
                        phase == "bwd", KV=KV, Sk=Sk), peak)
    for phase in ("fwd", "bwd"):
        tf32_bound(row, phase, flash_cost(B, H, S, d, q.element_size(), pairs,
                                          phase == "bwd", KV=KV, Sk=Sk))
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
                                            dtype, causal, window, n=3))
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
    the causal half of M.x (c(c+1)P) and the state-update product (2cPN);
    per head the entering-state product (2cPN) of chunks 1 .. only, since
    chunk 0 enters with a zero state: the least work these inputs need, the
    products of the passes' costs (ssd_pass_costs, ssd_f32_pass_costs)
    summed."""
    c, nc = chunk, L // chunk
    nbytes = ((2 * B * L * H * P + 2 * B * L * G * N) * itemsize
              + 4 * (B * L * H + H + B * H * P * N))
    flops = ((c * (c + 1) * N * G + c * (c + 1) * P * H) * B * nc
             + 2 * c * P * N * H * B * (2 * nc - 1))
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
        cost = ssd_cost(B, L, H, P, N, G, chunk, x.element_size())
        row["bound_ms"], row["bound_by"] = bound_ms(*cost, peak)
        tf32_bound(row, "call", cost)
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


def ssd_f32_pass_costs(B, L, H, P, N, G, chunk) -> dict:
    """(bytes, flops, peak rate) of each float32 pass (namespace tfs): its
    inputs read once and its outputs written once, float32 throughout.
    Chunk states: x, dt, A, B in, S and seg out; 2cPN a (b, h, chunk).
    State passing: S and each chunk's last seg in, the entering states of
    chunks 1 .. and the final state out; 2PN a (b, h, chunk) on the CUDA
    cores.  Chunk outputs: x, dt, seg, B, C and the entering states in, y
    out; C.B^T once per group, M.x, and 2cPN a (b, h, chunk) for the
    entering state of chunks 1 ..  The products' rate is the float32
    rate's; :func:`f32_bounds` gives the three-TF32-product bound too."""
    c, nc = chunk, L // chunk
    x, bc = 4 * B * L * H * P, 4 * B * L * G * N
    dt = seg = 4 * B * L * H
    S, state = 4 * B * nc * H * P * N, 4 * B * H * P * N
    s_in = 4 * B * (nc - 1) * H * P * N
    return {
        "ssd_f32_chunk_state": (x + dt + 4 * B * H + bc + S + seg,
                                2.0 * c * P * N * B * H * nc),
        "ssd_f32_state_pass": (S + 4 * B * H * nc + s_in + state,
                               2.0 * P * N * B * H * nc),
        "ssd_f32_chunk_scan": (2 * x + dt + seg + 2 * bc + s_in,
                               float((c * (c + 1) * N * G
                                      + c * (c + 1) * P * H) * B * nc
                                     + 2 * c * P * N * H * B * (nc - 1)))}


def f32_bounds(row, nbytes, flops, tensor=True) -> None:
    """A float32 row's bounds: ``bound_ms`` at the float32 rate,
    ``tf32_bound_ms`` as three TF32 products at the TF32 tensor rate (the
    design's; ``tensor`` False for a pass on the CUDA cores, whose only
    bound is the float32 rate's) and ``bytes_bound_ms``; each the larger
    of its products' time and the bytes' time."""
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    if tensor:
        row["tf32_bound_ms"], row["tf32_bound_by"] = bound_ms(
            nbytes, 3 * flops, TF32_FLOP_PER_S)
    row["bytes_bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S


def check_ssd_f32(sops, sref, gen, B, L, H, P, N, G, chunk,
                  per_sequence_A=False, timed=False, steep_dt=None,
                  head_blocks=False) -> dict:
    """One float32 ``ssd_scan_kernel`` call (three launches, namespace
    tfs) against the per-step recurrence (SSD_TOL[float32]), a second call
    equal to the bit, and each of its passes against its plain version on
    the same inputs (the kernel's own outputs of the pass before; every dt
    ``steep_dt`` on request, so that seg falls by hundreds within a
    chunk): the
    chunk states against ``chunk_state_ref``, the state passing against
    ``state_pass_ref``, the chunk outputs against ``chunk_scan_ref``, all
    within SSD_TOL[float32].  Timed: the call's ms and each pass's beside
    their bounds (``f32_bounds``) and the plain versions' ms.
    ``head_blocks``: the call's chunk outputs must run four heads a block
    (``tfs::chunk_scan_kernel<4>``), and its first and last sequences
    called alone one head a block (``<1>``, a grid too small for four) must
    give the same bits as the call's (``f32_head_blocks``)."""
    f32 = torch.float32
    tol = SSD_TOL[f32]
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, L, H, P, N, G, f32)
    if per_sequence_A:
        A = A * (0.5 + torch.rand(B, 1, generator=gen, device=DEVICE))
    if steep_dt is not None:
        dt = torch.full_like(dt, steep_dt)
    call = lambda: sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    before = dict(sops.launch_counts)
    y, s = call()
    counts = {k: sops.launch_counts[k] - before[k] for k in SSD_F32_PASSES}
    y2, s2 = call()
    rep = H // G
    plain = lambda: sref.ssd_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 2),
                                      Cm.repeat_interleave(rep, 2))
    yr, sr = plain()
    S, seg = sops.ssd_f32_chunk_state(x, dt, A, Bm, chunk=chunk)
    s_in, state = sops.ssd_f32_state_pass(S, seg, chunk=chunk)
    yp = sops.ssd_f32_chunk_scan(x, dt, seg, Bm, Cm, s_in, chunk=chunk)
    plains = {
        "ssd_f32_chunk_state": lambda: sref.chunk_state_ref(x, dt, A, Bm,
                                                            chunk),
        "ssd_f32_state_pass": lambda: sref.state_pass_ref(S, seg, chunk),
        "ssd_f32_chunk_scan": lambda: sref.chunk_scan_ref(
            x, dt, seg, Bm, Cm, s_in, chunk)}
    Sr, segr = plains["ssd_f32_chunk_state"]()
    er, str_ = plains["ssd_f32_state_pass"]()
    ypr = plains["ssd_f32_chunk_scan"]()
    torch.cuda.synchronize()
    what = (f"ssd f32 B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk}"
            + (" A per sequence" if per_sequence_A else "")
            + (f" dt={steep_dt}" if steep_dt is not None else ""))
    if counts != dict.fromkeys(SSD_F32_PASSES, 1):
        raise AssertionError(f"{what}: launches {counts}, expected one of "
                             f"each float32 pass")
    if not (torch.equal(y, y2) and torch.equal(s, s2)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    if head_blocks:
        f32_head_blocks(sops, what, (x, dt, A, Bm, Cm), chunk, y, s)
    row = dict(B=B, L=L, H=H, P=P, N=N, G=G, chunk=chunk, dtype="float32",
               per_sequence_A=per_sequence_A, steep_dt=steep_dt,
               same_bits=True, head_blocks=head_blocks,
               y_max_abs_err=compare(y, yr, f32, what + " y", tol),
               state_max_abs_err=compare(s, sr, f32, what + " state", tol),
               passes={
                   "ssd_f32_chunk_state": {"max_abs_err": max(
                       compare(S, Sr, f32, what + " S", tol),
                       compare(seg, segr, f32, what + " seg", tol))},
                   "ssd_f32_state_pass": {"max_abs_err": max(
                       compare(s_in, er, f32, what + " s_in", tol),
                       compare(state, str_, f32, what + " state", tol))},
                   "ssd_f32_chunk_scan": {"max_abs_err": compare(
                       yp, ypr, f32, what + " chunk outputs", tol)}})
    if timed:
        row["ms"] = time_ms(call, 10)
        row["plain_ms"] = time_ms(plain, 1, reps=3)
        row["library_ms"] = None
        f32_bounds(row, *ssd_cost(B, L, H, P, N, G, chunk, 4))
        kernel = {
            "ssd_f32_chunk_state": lambda: sops.ssd_f32_chunk_state(
                x, dt, A, Bm, chunk=chunk),
            "ssd_f32_state_pass": lambda: sops.ssd_f32_state_pass(
                S, seg, chunk=chunk),
            "ssd_f32_chunk_scan": lambda: sops.ssd_f32_chunk_scan(
                x, dt, seg, Bm, Cm, s_in, chunk=chunk)}
        for name, (nbytes, flops) in ssd_f32_pass_costs(
                B, L, H, P, N, G, chunk).items():
            r = row["passes"][name]
            r.update(ms=time_ms(kernel[name], 10),
                     plain_ms=time_ms(plains[name], 1, reps=3),
                     library_ms=None, bytes=nbytes, flops=flops)
            f32_bounds(r, nbytes, flops,
                       tensor=name != "ssd_f32_state_pass")
    print("ssd f32 check", json.dumps(row), flush=True)
    return row


def f32_head_blocks(sops, what, args, chunk, y, s) -> None:
    """Fails unless the float32 chunk outputs of ``args`` run four heads a
    block (``ssd_f32_scan_heads``) and the first and last sequences,
    called alone, one head a block (a grid too small for four) and give
    the bits ``y`` and ``s`` of the whole call."""
    B, L, H, _ = args[0].shape
    G = args[3].shape[2]
    heads = (sops.ssd_f32_scan_heads(B, L, H, G, chunk),
             sops.ssd_f32_scan_heads(1, L, H, G, chunk))
    if heads != (4, 1):
        raise AssertionError(f"{what}: heads a block {heads} for the call "
                             f"and one sequence, expected (4, 1)")
    for b in (0, B - 1):
        one = [t[b:b + 1] for t in args]
        if args[2].dim() == 1:         # A shared by every sequence
            one[2] = args[2]
        yb, sb = sops.ssd_scan_kernel(*one, chunk=chunk)
        if not (torch.equal(yb[0], y[b]) and torch.equal(sb[0], s[b])):
            raise AssertionError(
                f"{what}: sequence {b} one head a block differs from four "
                f"heads a block by {(yb[0] - y[b]).abs().max().item():.3e}")
    print(f"{what}: four heads a block and one head a block give the same "
          f"bits (sequences 0 and {B - 1})", flush=True)


def ssd_f32_rows(sops, sref, gen) -> dict:
    """The float32 route over phase 9's grid, a ragged row (chunk 48, P=8,
    N=16, two groups), one chunk of 100 rows, widths that are no multiple
    of 4 (P=30, N=30; P=5, N=7: staged element by element), each with A
    shared and per sequence, and seg falling past 88 within each of two
    chunks, and four heads a block in two groups of six heads against one
    head a block (``f32_head_blocks``); then timed at the serving shape,
    the mamba2 training shape (A per sequence) and one 512-token sequence
    of its width (the float32 meta-gradient of the 2-layer cut's), each
    printed beside its bounds and the time of the CUDA-core kernel the
    route replaced at the serving shape."""
    rows = []
    for L, H, P, N, G, chunk in ((128, 2, 16, 32, 2, 32),
                                 (256, 2, 16, 32, 2, 128),
                                 (96, 4, 8, 16, 2, 48),
                                 (100, 4, 16, 32, 2, 100),
                                 (120, 3, 30, 30, 1, 40),
                                 (64, 2, 5, 7, 1, 32)):
        for per_seq in (False, True):
            rows.append(check_ssd_f32(sops, sref, gen, 2, L, H, P, N, G,
                                      chunk, per_seq))
    rows.append(check_ssd_f32(sops, sref, gen, 2, 512, 4, 16, 32, 2, 256,
                              steep_dt=4.0))
    # four heads a block: group 1 and a block of two heads (H / G = 6)
    rows.append(check_ssd_f32(sops, sref, gen, 16, 1024, 12, 64, 128, 2, 256,
                              head_blocks=True))
    t, m = SSD_TRAIN, SSD_MAIN
    main = {
        "serve": check_ssd_f32(sops, sref, gen, m["B"], m["L"], m["H"],
                               m["P"], m["N"], m["G"], m["chunk"],
                               timed=True),
        "train": check_ssd_f32(sops, sref, gen, t["B"], t["L"], t["H"],
                               t["P"], t["N"], t["G"], t["chunk"], True,
                               timed=True),
        "one_sequence": check_ssd_f32(sops, sref, gen, 1, t["L"], t["H"],
                                      t["P"], t["N"], t["G"], t["chunk"],
                                      timed=True)}
    for shape, r in main.items():
        print(f"SSD scan, float32, at the {shape} shape: {r['ms']:.4f} ms a "
              f"call ("
              + ", ".join(f"{k[8:]} {v['ms']:.4f}"
                          for k, v in r["passes"].items())
              + f"); bounds {r['bound_ms']:.4f} ms (float32 rate, "
              f"{r['bound_by']}), {r['tf32_bound_ms']:.4f} (three TF32 "
              f"products, {r['tf32_bound_by']}), {r['bytes_bound_ms']:.4f} "
              f"(bytes); the CUDA-core kernel it replaced {SSD_F32_SIMT_MS}"
              f" ms at the serving shape (PERF.md)", flush=True)
    torch.cuda.empty_cache()
    return dict(main, sweep_checks=len(rows),
                sweep_worst_y_err=max(r["y_max_abs_err"] for r in rows))


def ssd_calls_phase(sops) -> dict:
    """The kernels that one bf16 and one float32 ``ssd_scan_kernel`` call
    run on the card at the serving shape, from torch.profiler; fails unless
    they are the three passes' kernels of the dtype's route (hop's, tfs's),
    one each, with no copy, expansion or other kernel beside them (in
    float32 not the one-launch CUDA-core kernel tfs replaced).  Run before
    the training step's profile (phase 5), as flash_calls_phase."""
    m = SSD_MAIN
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    for dtype, want in ((torch.bfloat16, [f"hop::{k}" for k in
                                          SSD_PASSES.values()]),
                        (torch.float32, list(SSD_F32_PASSES.values()))):
        x, dt, A, Bm, Cm = ssd_inputs(gen, m["B"], m["L"], m["H"], m["P"],
                                      m["N"], m["G"], dtype)
        sops.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=m["chunk"])
        names = device_kernels(lambda: sops.ssd_scan_kernel(
            x, dt, A, Bm, Cm, chunk=m["chunk"]))
        what = str(dtype)[6:]
        print(f"ssd kernels per {what} call", json.dumps(names), flush=True)
        if sorted(short_kernel(n) for n in names) != sorted(want):
            raise AssertionError(
                f"a {what} ssd_scan_kernel call ran {names} on the card; "
                f"expected the kernels {want} and nothing else")
        out[what] = names
        del x, dt, A, Bm, Cm
    return out


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
    f32 = ssd_f32_rows(sops, sref, gen)
    torch.cuda.empty_cache()
    bwd = ssd_bwd_rows(sops, sref, gen)
    return main, rows, continuity, passes, pass_rows, f32, bwd


def ssd_summary(main, rows, continuity, passes, pass_rows, f32, calls,
                serve_row, f32_split) -> list:
    """The kernels-line entries of the SSD scan: the whole bf16 call
    (``ssd_scan``: its launches count calls) and each of its three
    kernels, numbers at the serving path's shape in bfloat16, launches from
    the mamba2 serve run; beside each, the float32 route's (namespace tfs,
    ``f32``: ssd_f32_rows) at the training and serving shapes and one
    sequence, with the float32-rate and three-TF32-product bounds, its
    launches from the profiled float32 meta-gradient (``f32_split``)."""
    b, m = main["bfloat16"], SSD_MAIN
    shape = (f"(B={m['B']}, L={m['L']}, H={m['H']}, P={m['P']}, N={m['N']}, "
             f"G={m['G']}, chunk={m['chunk']}) bfloat16")
    whole = ("ms", "plain_ms", "bound_ms", "bound_by", "tf32_bound_ms",
             "tf32_bound_by", "bytes_bound_ms", "y_max_abs_err")
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
                     f"chunked_ms: the port's chunked torch scan; float32: "
                     f"the float32 route (three tfs launches a call) at the "
                     f"serving shape, its other shapes beside",
            "float32": main["float32"],
            **{f"float32_{k}": {key: f32[k].get(key) for key in whole}
               for k in ("serve", "train", "one_sequence")},
            "float32_launches_in_f32_meta_grad": f32_split.get(
                "ssd_fwd_launches"),
            "float32_sweep_checks": f32["sweep_checks"],
            "continuity": continuity,
            "sweep_checks": len(rows) + len(pass_rows),
            "sweep_worst_y_err": max(r["y_max_abs_err"] for r in rows)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    each = ("ms", "plain_ms", "bound_ms", "bound_by", "tf32_bound_ms",
            "tf32_bound_by", "bytes_bound_ms", "max_abs_err")
    out = [call]
    for name in SSD_PASSES:
        f32_name = name.replace("ssd_", "ssd_f32_", 1)
        kernel = SSD_F32_PASSES[f32_name]
        out.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": REPLACES["ssd_scan"],
            "launches": serve_row["launches"][name],
            **{k: passes[name][k] for k in keys},
            "shape": f"{shape}; one launch a bf16 call; float32: its float32 "
                     f"route's kernel {kernel} at the mamba2 training shape "
                     f"(A per sequence), the serving shape and one sequence",
            "sweep_worst_err": max(r[name]["max_abs_err"]
                                   for r in pass_rows),
            "float32": dict(
                kernel=kernel,
                **{k: f32["train"]["passes"][f32_name].get(k) for k in each},
                serving_shape={k: f32["serve"]["passes"][f32_name].get(k)
                               for k in each},
                one_sequence={k: f32["one_sequence"]["passes"][f32_name].get(
                    k) for k in each},
                launches_in_f32_meta_grad=f32_split.get(
                    "ssd_kernels", {}).get(kernel, {}).get("launches"))})
    return out


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
    """(bytes, flops) of each of the backward's three wrappers ("state",
    "pass", "chunk": the chunk wrapper's launches together), of each launch
    of the chunk wrapper in bfloat16 ("gram", "chunk_kernel", "finish",
    "reduce") and of the whole call: inputs read once, outputs written
    once; flops the least work on these inputs (2 a multiply-add), per (b,
    chunk): the causal half of C.B^T once per group (c(c+1)N), and per head
    the causal halves of D = gy x^T, M^T gy (c(c+1)P each), Z B and Z^T C
    (c(c+1)N each), and the (P x N) x c products S, Lc, gO B, gO^T x and
    gy s_in (2cPN each).  The tangent reads every input and its tangent,
    writes the outputs' tangents, and does each product three times (A B,
    A' B, A B').  A launch's bytes are its own inputs and outputs: the
    gram tiles C.B^T (64 x 64 float32 for each pair of 64-row tiles q >= k,
    per group), the per-head dB and dC and the float32 row sums that the
    finish and reduce launches read."""
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
    nt = -(-c // 64)
    tiles = 4 * 64 * 64 * nt * (nt + 1) // 2 * G * B * nc
    per_head = 4 * B * L * H * N                 # dB or dC of each head
    rows = 4 * B * H * L                         # ddd, dsk, dsq or tk
    dap = 4 * B * nc * H
    costs = {
        "state": (k * (2 * x + 2 * bc + dt + a) + k * (2 * S + seg),
                  f * 4.0 * c * P * N * heads),
        "pass": (k * (2 * S + seg // c + gs) + k * (2 * S + sg),
                 f * 6.0 * P * N * heads),
        "chunk": (k * (2 * x + 2 * bc + dt + a + seg + 2 * S + sg)
                  + x + 2 * bc + dt + a,
                  f * float(gram + intra + 6 * c * P * N * heads)),
        "gram": (k * (2 * bc + tiles), f * float(gram)),
        "chunk_kernel": (k * (2 * x + 2 * bc + dt + seg + 2 * S + tiles
                              + 4 * rows) + x + 2 * per_head,
                         f * float(intra + 6 * c * P * N * heads)),
        "finish": (k * (5 * rows + sg + dt + a) + dt + dap, 0.0),
        "reduce": (2 * per_head + dap + 2 * bc + a, 0.0)}
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
    at one shape against the plain passes composed (one call: six
    launches): each gradient within SSD_BWD_TOL, and a
    second call equal to the bit.  ``faults``: the planted faults of
    bwd_faults must fail the check.  ``timed``: the call's ms, its plain
    version's, its bound, each wrapper's ms and bound, and the chunked VJP
    (or its jvp) it replaced, host included."""
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
        tf32_bound(row, "call", costs["whole"])
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
              f"{ {k: round(v['ms'], 4) for k, v in row['passes'].items()
                   if k != 'launches'} }; the chunk wrapper's launches "
              f"{ {k: (round(v['ms'], 4), round(v['bound_ms'], 4))
                   for k, v in row['passes'].get('launches', {}).items()} }"
              f"; errs {errs}", flush=True)
    return row


def bwd_pass_times(sops, sref, args, targs, chunk, tangent, costs, rate
                   ) -> dict:
    """Each wrapper of the call (state, pass, chunk: its launches) timed on
    the outputs of the one before, beside its plain version and its bound;
    also each launch of the chunk wrapper alone ("launches": gram, chunk,
    finish, reduce, each on the planes the ones before it filled), beside
    its bound (in float32 also its three-TF32-product bound)."""
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
        if x.dtype == torch.float32 and name != "pass":
            out[name]["tf32_bound_ms"], out[name]["tf32_bound_by"] = \
                bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    calls, _ = sops._chunk_launches(
        *args[:6], seg, s_in, gO, sg, chunk,
        (*targs[:6], tseg, ts_in, tgO, tsg) if tangent else None)
    out["launches"] = {}
    for key, call in calls.items():
        for earlier in calls.values():     # fill what this one reads
            if earlier is call:
                break
            earlier()
        cost = costs["chunk_kernel" if key == "ssd_bwd_chunk"
                     else key[len("ssd_bwd_"):]]
        row = dict(ms=time_ms(call, 5))
        row["bound_ms"], row["bound_by"] = bound_ms(*cost, rate)
        if x.dtype == torch.float32:
            row["tf32_bound_ms"], row["tf32_bound_by"] = bound_ms(
                cost[0], 3 * cost[1], TF32_FLOP_PER_S)
        out["launches"][key] = row
    return out


def bwd_calls_phase(sops) -> dict:
    """The kernels that one ``ssd_scan_bwd`` and one
    ``ssd_scan_bwd_tangent`` call in each dtype run on the card at the
    mamba2 training shape, from torch.profiler; fails unless each is its six
    kernels (SSD_BWD_KERNELS, SSD_BWD_TANGENT_KERNELS, SSD_BWD_F32_KERNELS,
    SSD_BWD_TANGENT_F32_KERNELS), one launch each, and nothing else.
    Run before the training step's profile (phase 5), as
    ssd_calls_phase."""
    t = SSD_TRAIN
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    inputs = {dtype: ssd_bwd_inputs(gen, t["B"], t["L"], t["H"], t["P"],
                                    t["N"], t["G"], dtype, True,
                                    tangents=True)
              for dtype in (torch.bfloat16, torch.float32)}
    out = {}
    for name, dtype, kernels in (
            ("ssd_scan_bwd", torch.bfloat16, SSD_BWD_KERNELS),
            ("ssd_scan_bwd_tangent", torch.bfloat16,
             SSD_BWD_TANGENT_KERNELS),
            ("ssd_scan_bwd", torch.float32, SSD_BWD_F32_KERNELS),
            ("ssd_scan_bwd_tangent", torch.float32,
             SSD_BWD_TANGENT_F32_KERNELS)):
        args, targs = inputs[dtype]
        if name == "ssd_scan_bwd":
            call = lambda: sops.ssd_scan_bwd(*args, chunk=t["chunk"])
        else:
            call = lambda: sops.ssd_scan_bwd_tangent(*args, *targs,
                                                     chunk=t["chunk"])
        call()
        names = device_kernels(call)
        what = f"{name} {str(dtype)[6:]}"
        print(f"{what} kernels per call", json.dumps(names), flush=True)
        want = sorted(kernels.values())
        if len(names) != len(want) or sorted(
                k for k in want if any(k + "<" in n or k + "(" in n
                                       for n in names)) != want:
            raise AssertionError(f"a {what} call ran {names} on the "
                                 f"card; expected the kernels {want} and "
                                 f"nothing else")
        out[what] = names
    return out


def ssd_bwd_rows(sops, sref, gen, tangent=False) -> tuple[list, dict]:
    """The backward (``tangent``: its tangent) over tests/test_kernels.py's
    grid (B=2, H=2, P=16, N=32, two groups), a ragged row (chunks of 48,
    A per sequence, narrow heads, two groups), full-width heads with one
    group, one chunk of 100 rows, and seg falling past 88 within each of
    two chunks, in float32 and bfloat16; then the mamba2 training shape (A
    per sequence) and the serving shape in both dtypes, timed, with planted
    faults; the float32 rows printed beside their three bounds and the
    CUDA-core kernels the float32 route replaced."""
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
    for dtype in (torch.bfloat16, torch.float32):
        main[f"serve_{str(dtype)[6:]}"] = check_ssd_bwd(
            sops, sref, gen, m["B"], m["L"], m["H"], m["P"], m["N"], m["G"],
            m["chunk"], dtype, timed=True, faults=True, tangent=tangent)
    what = "backward's tangent" if tangent else "backward"
    simt = SSD_BWD_TANGENT_F32_SIMT_MS if tangent else SSD_BWD_F32_SIMT_MS
    for shape in ("train", "serve"):
        r = main[f"{shape}_float32"]
        each = {k: round(v["ms"], 4)
                for k, v in r["passes"]["launches"].items()}
        print(f"SSD {what}, float32, at the {shape} shape: "
              f"{r['ms']:.4f} ms a call (state "
              f"{r['passes']['state']['ms']:.4f}, pass "
              f"{r['passes']['pass']['ms']:.4f}, {each}); bounds "
              f"{r['bound_ms']:.4f} ms (float32 rate, {r['bound_by']}), "
              f"{r['call_tf32_bound_ms']:.4f} ms (three TF32 products, "
              f"{r['call_tf32_bound_by']}) and "
              f"{r['call_bytes_bound_ms']:.4f} ms (bytes); the CUDA-core "
              f"kernels the float32 route replaced {simt} ms at the train "
              f"shape (PERF.md)", flush=True)
    torch.cuda.empty_cache()
    return rows, main


def ssd_bwd_summary(bwd, tan, train_rows, mamba_row, f32_split) -> list:
    """The kernels-line entries of the backward and its tangent: the whole
    call (six launches in bfloat16; its launches count calls) and each
    launch (the state and pass wrappers' one each; the chunk wrapper's
    gram, chunk, finish and reduce, each timed alone), numbers at the
    mamba2 training shape in bfloat16 with A per sequence, launches from
    the mamba2 training run (the backward's also from the serve run); each
    launch's float32 kernel (namespace tbw) beside, at both shapes with its
    three bounds, its launches from the profiled float32 meta-gradient
    (``f32_split``, meta_grad_split)."""
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
            "shape": f"{shape}; six launches a call (the entries below); "
                     f"no TPU counterpart; launches: calls in the mamba2 "
                     f"training run; library: none; chunked_ms: the "
                     f"chunked VJP {'(its jvp) ' if 'tangent' in name else ''}"
                     f"it replaced, host included",
            "launches_in_serve_run": mamba_row["launches"].get(name),
            "float32": main["train_float32"],
            "float32_serving_shape": main["serve_float32"],
            "float32_launches_in_f32_meta_grad": f32_split.get(
                name.replace("ssd_scan_", "ssd_") + "_launches"),
            "serving_shape": main["serve_bfloat16"],
            "sweep_checks": len(rows),
            "sweep_worst_err": max(r["max_abs_err"] for r in rows)})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        names = SSD_BWD_TANGENT_KERNELS if "tangent" in name else \
            SSD_BWD_KERNELS
        chunk = b["passes"]["chunk"]
        for launch in ("state", "pass", "gram", "chunk", "finish", "reduce"):
            key = prefix + launch
            if launch in ("state", "pass"):
                p, serve = b["passes"][launch], \
                    main["serve_bfloat16"]["passes"][launch]
                note = f"the {launch} wrapper, its one launch"
            else:
                p = dict(b["passes"]["launches"]["ssd_bwd_" + launch],
                         plain_ms=chunk["plain_ms"], library_ms=None)
                serve = main["serve_bfloat16"]["passes"]["launches"][
                    "ssd_bwd_" + launch]
                note = (f"one of the chunk wrapper's four launches, timed "
                        f"alone; plain_ms: the chunk wrapper's plain version "
                        f"(all four); the wrapper's four launches "
                        f"{chunk['ms']:.4f} ms (bound {chunk['bound_ms']:.4f}"
                        f" {chunk['bound_by']})")
            entry = {
                "name": key, "route": "cuda",
                "source": SSD_BWD_SOURCE, "replaces": None,
                "launches": launches[key],
                "max_abs_err": b["max_abs_err"],
                **{k: p[k] for k in keys},
                "shape": f"{shape}; kernel {names[key]} ({note}); "
                         f"launches: in the mamba2 training run; "
                         f"max_abs_err: the whole call's",
                "serving_shape": {k: serve[k] for k in ("ms", "bound_ms",
                                                        "bound_by")}}
            kernel = (SSD_BWD_TANGENT_F32_KERNELS if "tangent" in name
                      else SSD_BWD_F32_KERNELS)[key]
            f32 = {}
            for where in ("train", "serve"):
                ps = main[f"{where}_float32"]["passes"]
                f32[where] = (ps[launch] if launch in ("state", "pass")
                              else ps["launches"]["ssd_bwd_" + launch])
            entry["float32"] = dict(
                kernel=kernel,
                **{k: f32["train"].get(k) for k in (
                    "ms", "bound_ms", "bound_by", "tf32_bound_ms",
                    "tf32_bound_by")},
                max_abs_err=main["train_float32"]["max_abs_err"],
                serving_shape={k: f32["serve"].get(k) for k in (
                    "ms", "bound_ms", "bound_by", "tf32_bound_ms")},
                launches_in_f32_meta_grad=f32_split.get(
                    "ssd_kernels", {}).get(kernel, {}).get(
                        "launches"))
            out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the serving path at full width
# ---------------------------------------------------------------------------

def serve_phase(args, counters, expect, replay=()):
    """Serve through the CLI entry point with ``args``.  ``counters`` maps
    each kernel to its ops module (``launch_counts``); ``expect(layers,
    steps)`` gives every kernel's launches in the one adapt dispatch (0 for
    kernels the model does not run).  ``replay``: for each entry, one more
    dispatch, under torch.profiler ("profile") or with each flash launch
    tallied by role ("roles")."""
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
    replays = {"profile": dispatch_profile, "roles": dispatch_flash_roles}
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
    passes of either route: hop's, tfs's), its backward's kernels
    (SSD_BWD_NAMESPACES), and the chunked-scan backward (its
    ``record_function`` range, with every kernel launched inside it: on the
    card it runs only on CPU tensors, so none is expected)."""
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
    busy = fwd = bwd = sb = 0.0
    fwd_n = bwd_n = sb_n = 0
    sb_kernels = {}
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
            if is_ssd_bwd(evt.key):
                sb, sb_n = sb + us, sb_n + evt.count
                sb_kernels[short_kernel(evt.key)] = dict(
                    ms=us / 1e3, launches=evt.count)
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
                ssd_bwd_ms=sb / 1e3, ssd_bwd_launches=sb_n,
                ssd_bwd_kernels=sb_kernels, ssd_bwd_share=sb / busy,
                chunked_bwd_ms=bwd / 1e3, chunked_bwd_calls=bwd_n,
                ssd_fwd_share=fwd / busy, chunked_bwd_share=bwd / busy,
                device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
                launches=sum(k[1] for k in kernels),
                top_kernels=[dict(name=k[2][:80], ms=k[0] / 1e3,
                                  launches=k[1])
                             for k in sorted(kernels, reverse=True)[:8]])


def dispatch_flash_roles(eng, supports) -> dict:
    """One more adapt dispatch of the same users with each flash forward
    and backward launch tallied by the query length, key length and mask
    its kernel entry is handed (``ops._launch_strided``'s arguments), and
    by role for an encoder-decoder model: the encoder (non-causal, S =
    S_k), the decoder (causal) and the cross-attention (non-causal, S !=
    S_k).  Counts launches in this dispatch only; the ops' own
    ``launch_counts`` still move."""
    from repro_torch.kernels.flash_attention import ops as fops

    tally: dict = {}
    launch = fops._launch_strided

    def tallied(name, entry, pointers, views, heads_dim, *args):
        S, Sk, causal = args[3], args[4], bool(args[7])
        role = ("decoder" if causal else "encoder" if S == Sk
                else "cross")
        key = (role, "forward" if name == "flash_attention_fwd"
               else "backward", f"{S}x{Sk}")
        tally[key] = tally.get(key, 0) + 1
        return launch(name, entry, pointers, views, heads_dim, *args)

    stacked = eng._stack(supports, eng._bucket(len(supports)))
    torch.cuda.synchronize()
    fops._launch_strided = tallied
    try:
        adapted = eng.harness.adapt_states(eng.params, stacked)
        torch.cuda.synchronize()
    finally:
        fops._launch_strided = launch
    del adapted, stacked
    roles: dict = {}
    for (role, kind, shape), n in sorted(tally.items()):
        r = roles.setdefault(role, {"forward": 0, "backward": 0,
                                    "shapes": []})
        r[kind] += n
        if shape not in r["shapes"]:
            r["shapes"].append(shape)
    return roles


# ---------------------------------------------------------------------------
# Phase 8: the card against the CPU on a 2-layer cut of the same config
# ---------------------------------------------------------------------------

def modality_inputs(cfg, lead, seed) -> dict:
    """Random float32 CPU frames (audio) or patches (vision) with leading
    axes ``lead``, the shapes ``steps.modality_extras`` stubs with zeros:
    zero inputs would give the cross blocks zero K/V, so the agreement
    checks draw them at random; {} for the other families."""
    from repro_torch.launch import steps as S
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen)
            for k, v in S.modality_extras(cfg, lead, torch.float32,
                                          "meta").items()}


def agreement_phase(cfg=None, rtol=None, seq=256, task_batch=2,
                    weights=None):
    """The card against the CPU on one set of weights and one episode of
    ``task_batch`` sequences of ``seq`` tokens.  ``cfg``: qwen2-1.5b at full
    width cut to 2 layers unless given; ``rtol``: AGREE_RTOL unless given;
    ``weights``: float32 CPU weights, a seed-1 init unless given.

    Each card run (kernels) is held against the CPU run (plain versions) in
    its own dtype, on the launch, adapted-support and adapted-query losses.
    The CPU's bf16 run against its f32 run is reported, not gated: bf16
    weights cannot hold most of an inner SGD step of lr 1e-2, so the bf16
    adapted support loss sits above the f32 one on either device.  The
    runs of each pair in ``rtol`` must agree and lower their support loss
    by adaptation.  Without a bf16 pair in ``rtol`` the card's bf16 losses
    may lie at most BF16_WITNESS times as far from the CPU's f32 ones as
    the CPU's bf16 losses do, and must fall with adaptation too.  The
    encoder-decoder and vision families get random frames or patches
    (``modality_inputs``), the same on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.eval.harness import EvalHarness
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    if cfg is None:
        cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    rtol = AGREE_RTOL if rtol is None else rtol
    model = build_model(cfg)
    harness = EvalHarness(model.loss_fn, cfg.inner_lr, 2)
    if weights is None:
        weights = model.init(torch.Generator().manual_seed(1),
                             torch.float32, "cpu")
    ep = serve.make_support_source(cfg, seq, task_batch,
                                   seed=0).eval_sample(1, seed=0)
    extras = [modality_inputs(cfg, (1, task_batch), seed)
              for seed in (5, 6)]
    runs = {"card_f32": (DEVICE, torch.float32),
            "card_bf16": (DEVICE, torch.bfloat16),
            "cpu_f32": ("cpu", torch.float32),
            "cpu_bf16": ("cpu", torch.bfloat16)}
    losses = {}
    for run, (device, dtype) in runs.items():
        t0 = time.perf_counter()
        params = {k: v.to(device, dtype) for k, v in weights.items()}
        sup, qry = ({**{k: torch.from_numpy(v).to(device)
                        for k, v in part.items()},
                     **{k: v.to(device, dtype) for k, v in extra.items()}}
                    for part, extra in zip((ep.support, ep.query), extras))
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
    witnessed = "card_bf16_vs_cpu_bf16" not in rtol
    pairs = [("card_f32", "cpu_f32"), ("card_bf16", "cpu_bf16"),
             ("cpu_bf16", "cpu_f32")] + \
        [("card_bf16", "cpu_f32")] * witnessed
    rel = {f"{run}_vs_{ref}": {
        name: abs(v - losses[ref][name]) / abs(losses[ref][name])
        for name, v in losses[run].items() if name != "seconds"}
        for run, ref in pairs}
    for pair, limit in rtol.items():
        for name, r in rel[pair].items():
            run, ref = pair.split("_vs_")
            if not (math.isfinite(losses[run][name]) and r <= limit):
                raise AssertionError(
                    f"agreement: {name} {run} {losses[run][name]} vs {ref} "
                    f"{losses[ref][name]} (rel {r:.3e} > {limit})")
    held = {run for pair in rtol for run in pair.split("_vs_")}
    if witnessed:
        for name, r in rel["card_bf16_vs_cpu_f32"].items():
            limit = BF16_WITNESS * rel["cpu_bf16_vs_cpu_f32"][name]
            if not (math.isfinite(losses["card_bf16"][name]) and r <= limit):
                raise AssertionError(
                    f"agreement: {name} card_bf16 {losses['card_bf16'][name]}"
                    f" vs cpu_f32 {losses['cpu_f32'][name]} (rel {r:.3e} > "
                    f"{BF16_WITNESS} x the CPU's bf16's, {limit:.3e})")
        held.add("card_bf16")
    for run in held:
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
# bf16 T1 and T2 where the lo halves matter: values sharing a mean of 4 and
# keys a direction, so that o' = O' - lse' O is a difference of two large
# sums and dq' one whose rows of dS sum to 0.  A P (or dS) rounded once to
# bf16 puts them outside TANGENT_TOL (tests/test_torch_flash_tangent_hilo.py
# models it on the CPU); N(0, 1) inputs do not show it.  (B, S, S_k, H, KV,
# d, causal): whisper's encoder cut to one sequence and 2 heads, and a
# causal GQA 6:1 shape at d = 128.
SHARED_MEAN = {"whisper-like 1500x1500": (1, 1500, 1500, 2, 2, 64, False),
               "causal GQA 6:1 d=128": (1, 256, 256, 6, 1, 128, True)}
V_MEAN, K_DIRECTION = 4.0, 1.0
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


def flash_tangent_cost(B, H, KV, S, d, itemsize, pairs, backward, Sk=None
                       ) -> tuple[float, float]:
    """(bytes, flops) of T1 or T2, each input read once and each output
    written once.  T1: q, q', o' (H heads) and k, k', v, v' (KV heads),
    lse in and lse' out (float32); 6d multiply-adds a pair a head (s, s'
    twice, P V, P s' V, P V').  T2: q, o, dO, q', o', dO', dq' and k, v,
    k', v', dk', dv', lse and lse' in; 12d a pair (s, s' twice, dP, dP'
    twice, dq' twice, dk' twice, dv' twice).  ``pairs``: the allowed
    (query, key) pairs of one head; ``Sk``: the key rows (S unless
    given)."""
    Sk = S if Sk is None else Sk
    qb, kb, rows = B * S * H * d * itemsize, B * Sk * KV * d * itemsize, \
        4 * B * H * S
    if backward:
        return 7 * qb + 6 * kb + 2 * rows, 24.0 * d * pairs * B * H
    return 3 * qb + 4 * kb + 2 * rows, 12.0 * d * pairs * B * H


def flash_tangent_design_flops(B, H, d, pairs, backward) -> float:
    """The operations the bf16 tangent kernels (namespace hop) do: every
    product that takes a float32 operand (P, P ⊙ S', P', dS, dS') as A
    runs twice, hi and lo, and T2's dK'/dV' launch forms S, S', dP and dP'
    again.  T1 9d multiply-adds a pair a head (S, S' twice, P V and P V'
    twice each, (P ⊙ S') V twice); T2 24d (part 0: S, S' twice, dP, dP'
    twice, dq' four; part 1: the same six and dk', dv' four each)."""
    return (48.0 if backward else 18.0) * d * pairs * B * H


def check_flash_tangents(fops, fref, gen, heads_dim, shape, dtype, causal,
                         window, timed=False, unaligned=False,
                         faults=False, Sk=None) -> dict:
    """T1 and T2 at one shape against their plain versions (one and two
    launches); with ``timed``, the kernels' and plain versions' times and
    the bounds (float32: also T2's products as three TF32 products, and
    its bytes alone); ``unaligned``: views whose rows are not 16-byte
    aligned; ``faults``: planted faults in T2's results, and T2 run without
    lse', must fail the check; ``Sk`` (the model layout): keys of another
    length than the queries."""
    from repro_torch.kernels.flash_attention.ref import band_mask
    if heads_dim == 1:
        B, H, S, d = shape
        KV, qs = H, shape
        ks = qs
        Sk = S
    else:
        B, S, H, KV, d = shape
        Sk = S if Sk is None else Sk
        qs, ks = (B, S, H, d), (B, Sk, KV, d)
    mk = lambda s: randn_view(gen, s, dtype, unaligned)
    q, tq, do, tdo = (mk(qs) for _ in range(4))
    k, v, tk, tv = (mk(ks) for _ in range(4))
    fwd = fref.flash_fwd_ref if heads_dim == 1 else fref.gqa_flash_fwd_ref
    out, lse = fwd(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, heads_dim=heads_dim)
    what = (f"tangent {'bhsd' if heads_dim == 1 else 'gqa'} {shape} "
            f"Sk={Sk} {str(dtype)[6:]} causal={causal} window={window}"
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
               Sk=Sk, dtype=str(dtype)[6:], causal=causal, window=window,
               unaligned=unaligned, fwd_max_abs_err=e1, bwd_max_abs_err=e2)
    if faults:
        # o' rows zeroed (T1); rows of each of T2's results zeroed, and lse'
        # left out (T2 given zeros)
        if tangent_outside(zero_seq(to, heads_dim, 0, 64), want_to)[0] == 0:
            raise AssertionError(f"{what}: planted fault 'o' rows 0:64 zero' "
                                 f"passed the check")
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
        row["planted_faults_caught"] = ["o' rows 0:64 zero", *planted]
    if timed:
        pairs = int(band_mask(S, Sk, causal, window).sum())
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
                                               p == "bwd", Sk=Sk)
            row[f"{p}_ms"] = time_ms(fn, n)
            row[f"{p}_plain_ms"] = time_events(plain, 3)
            row[f"{p}_bound_ms"], row[f"{p}_bound_by"] = bound_ms(
                nbytes, flops, rate)
            if dtype == torch.float32:
                tf32_bound(row, p, (nbytes, flops))
            if dtype == torch.bfloat16:
                row[f"{p}_design_bound_ms"] = bound_ms(
                    nbytes, flash_tangent_design_flops(
                        B, H, d, pairs, p == "bwd"), rate)[0]
        print(f"{what}: T1 {row['fwd_ms']:.4f} ms (plain "
              f"{row['fwd_plain_ms']:.3f}, bound {row['fwd_bound_ms']:.4f} "
              f"{row['fwd_bound_by']}), T2 {row['bwd_ms']:.4f} ms (plain "
              f"{row['bwd_plain_ms']:.3f}, bound {row['bwd_bound_ms']:.4f} "
              f"{row['bwd_bound_by']}); errs {e1:.2e} {e2:.2e}", flush=True)
    return row


def shared_mean_tangents(fops, fref, dtype=torch.bfloat16) -> dict:
    """T1 and T2 in ``dtype`` at SHARED_MEAN's shapes against their plain
    versions: for each shape and output, [elements outside TANGENT_TOL,
    largest |error|].  Raises nothing: scripts/ablate_flash_tangents.py
    reads it on copies of the source without the lo halves."""
    rows = {}
    for name, (B, S, Sk, H, KV, d, causal) in SHARED_MEAN.items():
        gen = torch.Generator().manual_seed(0)
        draw = lambda *s: torch.randn(*s, generator=gen)
        q, tq, do, tdo = (draw(B, S, H, d) for _ in range(4))
        k, v, tk, tv = (draw(B, Sk, KV, d) for _ in range(4))
        k, v = k + K_DIRECTION * draw(d), v + V_MEAN
        q, k, v, do, tq, tk, tv, tdo = (
            t.to(DEVICE, dtype) for t in (q, k, v, do, tq, tk, tv, tdo))
        kw = dict(causal=causal, window=None, heads_dim=2)
        out, lse = fref.gqa_flash_fwd_ref(q, k, v, causal=causal, window=None)
        to, tlse = fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv,
                                                    **kw)
        want_to, want_tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv,
                                                        **kw)
        grads = fops.flash_attention_bwd_tangent(
            q, k, v, out, lse, do, tq, tk, tv, want_to, want_tlse, tdo, **kw)
        wants = fref.flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                           want_to, want_tlse, tdo, **kw)
        pairs = {"o'": (to, want_to), "lse'": (tlse, want_tlse),
                 **{f"d{n}'": gw for n, gw in zip("qkv", zip(grads, wants))}}
        rows[name] = {n: list(tangent_outside(g, w))
                      for n, (g, w) in pairs.items()}
    return rows


def check_shared_mean_tangents(fops, fref, dtype=torch.bfloat16) -> dict:
    """shared_mean_tangents in ``dtype``, each output within
    TANGENT_TOL."""
    rows = shared_mean_tangents(fops, fref, dtype)
    bad = {name: {n: v for n, v in row.items() if v[0]}
           for name, row in rows.items()}
    what = str(dtype)[6:]
    if any(bad.values()):
        raise AssertionError(f"{what} tangents, values sharing a mean: "
                             f"outside TANGENT_TOL: {bad}")
    print(f"{what} tangents, values sharing a mean (outside, max abs err)",
          json.dumps(rows), flush=True)
    return rows


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
        tf32_bound(row, "t3", (nbytes, flops))
        extra = (f", as three TF32 products {row['t3_tf32_bound_ms']:.4f} "
                 f"{row['t3_tf32_bound_by']}, bytes "
                 f"{row['t3_bytes_bound_ms']:.4f}"
                 if dtype == torch.float32 else "")
        print(f"{what}: T3 {row['ms']:.4f} ms (plain {row['plain_ms']:.1f}, "
              f"bound {row['bound_ms']:.4f} {row['bound_by']}{extra}); errs "
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
    # T2's float32 kernels' other cases and the bf16 kernels' (T1 beside
    # them): d = 32 and 30, ragged S, GQA ratios 1, 2 and 6, rows not
    # 16-byte aligned
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_flash_tangents(fops, fref, gen, 1, (2, 4, 200, 32),
                                         dtype, True, None))
        rows += [check_flash_tangents(fops, fref, gen, 2, (B, S, H, KV, d),
                                      dtype, causal, window, unaligned=un)
                 for B, S, H, KV, d, causal, window, un in F32_EXTRA]
    g = FLASH_GQA_MAIN
    gqa = {str(dtype)[6:]: check_flash_tangents(
        fops, fref, gen, 2, (g["B"], g["S"], g["H"], g["KV"], g["d"]),
        dtype, True, None, timed=True, faults=dtype == torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32)}
    b, f = gqa["bfloat16"], gqa["float32"]
    print(f"qwen2 training shape, bf16: T1 {b['fwd_ms']:.4f} ms (this "
          f"design's bound {b['fwd_design_bound_ms']:.4f}), T2 "
          f"{b['bwd_ms']:.4f} ms ({b['bwd_design_bound_ms']:.4f})",
          flush=True)
    print(f"qwen2 training shape, f32: T1 {f['fwd_ms']:.4f} ms (bounds "
          f"{f['fwd_bound_ms']:.4f} float32 rate, {f['fwd_tf32_bound_ms']:.4f}"
          f" three TF32 products), T2 {f['bwd_ms']:.4f} ms (bounds "
          f"{f['bwd_bound_ms']:.4f}, {f['bwd_tf32_bound_ms']:.4f})",
          flush=True)
    shared_mean = check_shared_mean_tangents(fops, fref)
    shared_mean_f32 = check_shared_mean_tangents(fops, fref, torch.float32)
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
    return dict(flash_rows=rows, flash_gqa=gqa, shared_mean=shared_mean,
                shared_mean_float32=shared_mean_f32,
                ssd_rows=ssd_rows,
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
            "design_bound_ms": g[f"{p}_design_bound_ms"],
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
                                   for r in tan["flash_rows"]),
            "shared_mean_worst_err": max(
                row[n][1] for row in tan["shared_mean"].values()
                for n in (("o'", "lse'") if p == "fwd"
                          else ("dq'", "dk'", "dv'")))})
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
# phase 15's sequence for qwen2 (128 until the encoder-decoder phases came
# in): its CPU runs, the 152064-wide vocab head through second order, are
# most of that phase's host time
QWEN_AGREE_SEQ = 64
MAMBA_AGREE_SEQ = 512
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


def tangent_calls(fops):
    """A context in which each flash tangent call (T1, T2) is tallied by
    its shape as the kernel entry is handed it, "BxSxS_k" and the mask,
    into the dict it yields; the calls themselves run unchanged."""
    import contextlib

    @contextlib.contextmanager
    def tally():
        calls: dict = {}
        wrapped = {}
        for name, kind in (("flash_attention_fwd_tangent", "T1"),
                           ("flash_attention_bwd_tangent", "T2")):
            fn = getattr(fops, name)

            def counted(q, k, *args, _fn=fn, _kind=kind, **kw):
                hd = kw.get("heads_dim", 1)
                S, Sk = (q.shape[2], k.shape[2]) if hd == 1 else \
                    (q.shape[1], k.shape[1])
                key = (f"{_kind} {q.shape[0]}x{S}x{Sk} "
                       f"{'causal' if kw.get('causal', True) else 'full'}")
                calls[key] = calls.get(key, 0) + 1
                return _fn(q, k, *args, **kw)

            wrapped[name] = fn
            setattr(fops, name, counted)
        try:
            yield calls
        finally:
            for name, fn in wrapped.items():
                setattr(fops, name, fn)

    return tally()


def profile_train_step(bundle, state, batch, modules) -> dict:
    """One meta-step under torch.profiler: wall time, device time split
    into the forward kernels, T1 and T2 (the flash tangents, apart), the
    other tangent kernels (T3), the flash backward kernels, the SSD
    backward's kernels and their tangent's (SSD_BWD_NAMESPACES), the outer
    update
    and the rest; the chunked SSD backward and its jvp (their
    record_function ranges: CPU tensors only, so none on the card); the
    card's idle share; each kernel's launches by the wrappers' counters,
    and the flash tangent calls by shape (``tangent_calls``); peak
    memory."""
    from torch.profiler import ProfilerActivity, profile
    fops = next(m for m in modules if hasattr(m, "flash_attention_fwd_tangent"))
    state, _ = bundle.step_fn(state, batch)           # warm
    torch.cuda.synchronize()
    # the warm step's cached blocks back to the card: the qwen2 cut peaks
    # within 9 GB of its 80, and a fragmented cache runs it out of memory
    torch.cuda.empty_cache()
    for m in modules:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with tangent_calls(fops) as calls, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = bundle.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = all_counts(modules)
    peak = torch.cuda.max_memory_allocated()
    ranges = ("ssd_scan_chunked_bwd", "ssd_scan_chunked_bwd_jvp")
    split = dict(forward=0.0, flash_t1=0.0, flash_t2=0.0, tangent=0.0,
                 flash_backward=0.0, ssd_bwd=0.0, ssd_bwd_tangent=0.0,
                 outer=0.0, other=0.0)
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
            if is_ssd_bwd(key):
                split["ssd_bwd_tangent" if "::tangent_" in key
                      else "ssd_bwd"] += us
            elif "tangent_fwd_kernel" in key:
                split["flash_t1"] += us            # tf32 (f32), hop (bf16)
            elif "tangent_dq_kernel" in key or "tangent_dkv_kernel" in key:
                split["flash_t2"] += us            # tf32 (f32), hop (bf16)
            elif "jvpk" in key or "tangent" in key:
                split["tangent"] += us             # T3
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
               loss=float(metrics["loss"]), launches=launches,
               tangent_calls=calls)
    if busy:
        row.update(device_ms=busy / 1e3,
                   device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
                   split_ms={k: v / 1e3 for k, v in split.items()},
                   chunked_bwd_ms=in_ranges[ranges[0]] / 1e3,
                   chunked_bwd_jvp_ms=in_ranges[ranges[1]] / 1e3)
    else:
        row.update(device_ms="not measured")
    return row


def train_phase(name, cfg, args, shape, expect, log_flags, resume=False,
                mode="maml", per_step=None, profile=True, keep=True
                ) -> dict:
    """Meta-train ``cfg`` (the config ``args`` select) through
    ``launch.train.main`` in this process: 4 steps with ``resume``, else 2
    (``expect``: the kernels that must launch; ``per_step``: kernels that
    must launch exactly that many times a step), with every launch counter
    zeroed just before and read just after; the run's meta mode must be
    ``mode``; the run log must pass ``check_run_log.py`` with
    ``log_flags``; losses finite and the disagreement falling.  With
    ``resume``, a second run from the step-2 checkpoint alone must reach
    the uninterrupted step-4 loss.  Then, with ``profile``, one meta-step
    of the final state is profiled.  ``keep=False`` removes the run's
    directory (its checkpoints) at the end."""
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
    out = train.main(args + ["--steps", str(steps), "--run-log", log])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_counts(modules)
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in expect if not launches.get(k)]
    if missing:
        raise AssertionError(f"train {name}: kernels {missing} never "
                             f"launched: {launches}")
    wrong = {k: launches.get(k) for k, n in (per_step or {}).items()
             if launches.get(k) != n * steps}
    if wrong:
        raise AssertionError(f"train {name}: launches {wrong} in {steps} "
                             f"steps, expected {per_step} a step")
    records = [json.loads(line) for line in open(log)]
    trains = [r for r in records if r["kind"] == "train"]
    if not all(math.isfinite(r["loss"]) for r in trains):
        raise AssertionError(f"train {name}: non-finite loss {trains}")
    dis = [r["disagreement"] for r in trains]
    if not dis[-1] < dis[0]:
        raise AssertionError(f"train {name}: disagreement did not fall: "
                             f"{dis}")
    config = next(r for r in records if r["kind"] == "config")
    if config["mode"] != mode:
        raise AssertionError(f"train {name}: mode {config['mode']}, "
                             f"expected {mode}")
    row = dict(seconds=seconds, launches=launches, peak_run_gb=peak_run,
               losses=[r["loss"] for r in trains], disagreement=dis,
               step_time_s=[r["step_time_s"] for r in trains],
               log_check=check_run_log(log, *log_flags),
               evals=sum(r["kind"] == "eval" for r in records))
    if resume:
        # 2 steps that checkpoint at step 2 (one write), then 2 more
        # resumed from that checkpoint alone that write none (the chip
        # machine bounds what a call writes to disk: 45 GiB, deleted files
        # included, and deepseek's checkpoint is 17.4 GB)
        b = out["losses"][4]
        del out["state"]
        torch.cuda.empty_cache()
        ck = str(work / "ckpt")
        first = train.main(args + ["--steps", "2", "--ckpt-dir", ck,
                                   "--eval-every", "0",
                                   "--run-log", str(work / "ckpt.jsonl")])
        del first
        torch.cuda.empty_cache()
        log2 = str(work / "resumed.jsonl")
        out = train.main(args + ["--steps", "2", "--run-log", log2,
                                 "--ckpt-dir", ck, "--ckpt-every", "0"])
        files = sorted(os.listdir(os.path.join(ck, "seed0")))
        if files != ["ckpt_00000002.npz"]:
            raise AssertionError(f"train {name}: checkpoints {files}, "
                                 f"expected the step-2 one alone")
        a = out["losses"][4]
        if not abs(a - b) <= RESUME_RTOL * abs(b):
            raise AssertionError(f"train {name}: resumed step-4 loss {a} vs "
                                 f"{b} uninterrupted (rtol {RESUME_RTOL})")
        row.update(resumed_step4_loss=a, step4_loss=b,
                   resumed_log_check=check_run_log(log2, *log_flags))
    if (config["arch"], config["num_layers"]) != (cfg.name, cfg.num_layers):
        raise AssertionError(f"train {name}: ran {config['arch']} at "
                             f"{config['num_layers']} layers, expected "
                             f"{cfg.name} at {cfg.num_layers}")
    if not keep:
        shutil.rmtree(work, ignore_errors=True)
    if not profile:
        print(f"train {name}: {seconds:.1f} s for {steps} steps; "
              f"step_time_s {row['step_time_s']}; losses {row['losses']}; "
              f"disagreement {dis}; peak {peak_run:.2f} GB; launches "
              f"{launches}", flush=True)
        del out
        torch.cuda.empty_cache()
        return row
    # one meta-step of the final state under torch.profiler
    bundle = S.build_train(cfg, shape["name"], config["K"],
                           combine_override=config["combine_backend"],
                           device=DEVICE)
    src = train.make_train_source(cfg, INPUT_SHAPES[shape["name"]],
                                  bundle.K, bundle.T, bundle.tb)
    with bundle.make_pipeline(src, depth=0) as pipe:
        batch = next(pipe)
    # the profiled step takes the only reference to the final state (the
    # resumed run's, with ``resume``), so the state it replaces is freed
    # as it goes
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


def routed_leaves(model) -> set:
    """An MoE model's routed leaves: the router and the routed experts of
    its ``moe`` blocks (not the shared experts, not a dense FFN).  In
    bfloat16 the card and the CPU route a few tokens to other experts
    (route_flip_share), and one such token moves an expert's gradient by
    about 1/sqrt(tokens the expert takes): 9% at reduced mixtral's 128
    tokens an expert (PERF.md §6).  Those leaves are held leaf by leaf
    in float32 only."""
    return {f"segments/{si}/{j}/ffn/{name}"
            for si, seg in enumerate(model.plan)
            for j, desc in enumerate(seg.period) if desc.ffn == "moe"
            for name in ("router", "w1", "w2", "w3")}
CURV_AGREE = {torch.float32: 1e-2, torch.bfloat16: 0.3}
CURV_FLOOR = 0.5
LEAF_FLOOR = 1e-2


def is_cross_leaf(key: str) -> bool:
    """A leaf of the cross path: a cross block's projections or gate, or
    the vision projector."""
    return "/cross/" in key or key.endswith("/gate") or key == "vision_proj"


def cross_split(leaf_rel: dict, diff: dict, ref: dict) -> dict:
    """The largest relative error of the held leaves (``leaf_rel``) of the
    cross path and of the rest, with the cross leaf's name, and of the
    gates together (norm of the card's minus the CPU's gradient ``diff``
    over the CPU's ``ref``; a gate's gradient is a few numbers, often under
    the per-leaf floor); {} for a model without a cross path."""
    cross = {k: v for k, v in leaf_rel.items() if is_cross_leaf(k)}
    gates = [k for k in ref if k.endswith("/gate")]
    if not gates:
        return {}
    worst = max(cross, key=cross.get) if cross else None
    return dict(cross_leaf_rel=cross.get(worst), cross_worst_leaf=worst,
                rest_leaf_rel=max(v for k, v in leaf_rel.items()
                                  if not is_cross_leaf(k)),
                gates_rel=_norm(diff, gates) / _norm(ref, gates))


def _norm(d, keys=None):
    keys = list(d) if keys is None else keys
    return float(torch.sqrt(sum((d[k].double() ** 2).sum() for k in keys)))


def meta_grad_inputs(arch, seq, cfg=None, weights=None) -> tuple:
    """What both halves of train_agreement_phase differentiate: (cfg, its
    model, float32 CPU weights, support, query, the modality extras of
    support and query).  ``cfg``: ``arch`` cut to 2 layers unless given;
    ``weights``: a seed-0 init unless given."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_tasks import LMTaskSource
    from repro_torch.models.transformer import build_model
    if cfg is None:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
    model = build_model(cfg)
    p0 = weights if weights is not None else model.init(
        torch.Generator().manual_seed(0), torch.float32, device="cpu")
    ep = LMTaskSource(vocab_size=cfg.padded_vocab, seq_len=seq, K=1,
                      tasks_per_agent=1, task_batch=1, n_domains=4,
                      seed=0).sample(0)
    sup = {k: torch.from_numpy(v[0]) for k, v in ep.support.items()}
    qry = {k: torch.from_numpy(v[0]) for k, v in ep.query.items()}
    extras = [modality_inputs(cfg, (1, 1), seed) for seed in (5, 6)]
    return cfg, model, p0, sup, qry, extras


def meta_grads(inputs, dev, dtype, modes) -> dict:
    """{mode: (loss, float32 gradient leaves on ``dev``, seconds)} of one
    agent on ``inputs`` (``meta_grad_inputs``) on ``dev`` in ``dtype``."""
    from repro_torch.core import maml
    cfg, model, p0, sup, qry, extras = inputs
    p = {k: v.to(dev, dtype) for k, v in p0.items()}
    s, q = ({**{k: v.to(dev) for k, v in part.items()},
             **{k: v.to(dev, dtype) for k, v in extra.items()}}
            for part, extra in zip((sup, qry), extras))
    out = {}
    for mode in modes:
        t0 = time.perf_counter()
        loss, g = maml.multi_task_meta_grad(
            model.loss_fn, p, s, q, alpha=cfg.inner_lr, steps=1, mode=mode)
        out[mode] = (float(loss), {k: v.float() for k, v in g.items()},
                     time.perf_counter() - t0)
    return out


AGREE_DTYPES = (torch.float32, torch.bfloat16)
# A bfloat16 run that no standing limit holds (reduced jamba's: on the CPU
# its bf16 meta-gradient lies 75-165% from float64) is held against the
# CPU's float32 run through the CPU's own run in bfloat16: the card's bf16
# result may lie at most BF16_WITNESS times as far from the CPU's float32
# one as the CPU's bf16 result does.  Most of that distance is the
# weights' rounding to bf16, which both devices share, so the two are
# alike (jamba on the CPU: meta-gradients 0.75 and 0.79 from float32,
# 29 of 1024 routing choices; the card's bf16 meta-gradient 0.81 from the
# CPU's bf16, its routing 22 choices apart, NVIDIA H100 80GB HBM3,
# 700.00 W); a card-only fault in bfloat16 that moves the result as far
# again from float32 as rounding does fails.
BF16_WITNESS = 2.0


def cpu_meta_grads(arch, seq, cfg=None, modes=("maml", "fomaml"),
                   weights=None) -> dict:
    """The CPU half of train_agreement_phase in both dtypes, with its
    inputs: plain layers on the host, no CUDA call, so it can run while
    the kernels build (``build_phase``'s ``while_building``)."""
    t0 = time.perf_counter()
    inputs = meta_grad_inputs(arch, seq, cfg, weights)
    got = {dtype: meta_grads(inputs, "cpu", dtype, modes)
           for dtype in AGREE_DTYPES}
    print(f"train agreement {arch}: the CPU half took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(inputs=inputs, modes=modes, got=got)


def agree_cfg(arch, layers):
    """The config an agreement phase holds (its table's ``arch`` and
    ``layers``): cut to ``layers`` at full width, reduced where None;
    jamba at JAMBA_AGREE_LR."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    cfg = get_config(arch)
    cfg = cfg.reduced() if layers is None else S.cut_depth(cfg, layers)
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, inner_lr=JAMBA_AGREE_LR)
    return cfg


def agree_weights(cfg) -> dict:
    """The float32 CPU weights an agreement phase holds ``cfg`` on: a
    seed-1 init with every cross gate at GATE (at its zero init tanh(gate)
    = 0 and the cross path carries nothing)."""
    from repro_torch.models.transformer import build_model
    w = build_model(cfg).init(torch.Generator().manual_seed(1),
                              torch.float32, "cpu")
    for k in w:
        if k.endswith("/gate"):
            w[k].fill_(GATE)
    return w


def agree_cpu_halves(table, seq) -> dict:
    """The CPU halves (``cpu_meta_grads``) of an agreement phase's table of
    (arch, layers, modes) by config name: plain layers on the host, no
    CUDA call, so they run while the kernels build."""
    out = {}
    for arch, layers, modes in table:
        cfg = agree_cfg(arch, layers)
        out[cfg.name] = cpu_meta_grads(cfg.name, seq, cfg=cfg, modes=modes,
                                       weights=agree_weights(cfg))
    return out


def train_agreement_phase(half, loss_rtol) -> dict:
    """The meta-gradients of one agent on one task of one sequence on the
    card (kernels, tangent kernels) against ``half``, the CPU's (plain
    layers; ``cpu_meta_grads``, which gives the config, the weights and the
    modes), in the same dtype: the loss within the serving limit, the
    meta-gradient and its curvature part (maml - fomaml) within GRAD_AGREE
    / CURV_AGREE, the curvature at least CURV_FLOOR of the CPU's norm.  One
    mode (``("fomaml",)`` for a config that trains first-order) holds the
    loss and that mode's meta-gradient only.  A dtype without a loss limit
    in ``loss_rtol`` is held through the CPU's float32 run
    (``witnessed_grads``).  The encoder-decoder and vision families get
    random frames or patches (``modality_inputs``), and the largest leaf
    error of their cross path (``cross/*``, ``gate``, ``vision_proj``) is
    reported apart from the rest's (``cross_split``)."""
    inputs, modes = half["inputs"], half["modes"]
    arch, model = inputs[0].name, inputs[1]
    routed = routed_leaves(model)
    # kept past the float32 comparison only where bfloat16 needs it
    ref32 = (half["got"][torch.float32]
             if "card_bf16_vs_cpu_bf16" not in loss_rtol else None)
    rows = {}
    for dtype in AGREE_DTYPES:
        got = {}
        # both devices' gradients are compared on the card: the float64
        # norms over a full-width cut's leaves took tens of seconds on the
        # host
        for mode, (loss, g, sec) in half["got"].pop(dtype).items():
            got["cpu", mode] = (loss, {k: v.to(DEVICE) for k, v in g.items()},
                                sec)
        for mode, r in meta_grads(inputs, DEVICE, dtype, modes).items():
            got[DEVICE, mode] = r
        name = str(dtype)[6:]
        card, cpu = got[DEVICE, modes[0]], got["cpu", modes[0]]
        lk = "card_f32_vs_cpu_f32" if dtype == torch.float32 else \
            "card_bf16_vs_cpu_bf16"
        if lk not in loss_rtol:
            rows[name] = witnessed_grads(arch, name, got, ref32, modes)
            del got, card, cpu
            torch.cuda.empty_cache()
            continue
        loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        norms = {k: _norm(cpu[1], [k]) for k in cpu[1]}
        big = [k for k in norms if norms[k] >= LEAF_FLOOR * max(
            norms.values())]
        diff = {k: card[1][k] - cpu[1][k] for k in cpu[1]}
        grad_rel = _norm(diff) / _norm(cpu[1])
        leaf_rel = {k: _norm(diff, [k]) / norms[k] for k in big}
        # bfloat16 and an MoE model: the routed experts' and the router's
        # leaves are held through the norm over all leaves and the
        # routing-flip share (route_flip_share), not leaf by leaf
        held = [k for k in big if not (dtype == torch.bfloat16
                                       and k in routed)]
        grad_leaf = max(leaf_rel[k] for k in held)
        worst = sorted(leaf_rel, key=leaf_rel.get, reverse=True)[:3]
        split = cross_split(leaf_rel, diff, cpu[1])
        if len(modes) == 1:
            row = dict(mode=modes[0], loss_card=card[0], loss_cpu=cpu[0],
                       loss_rel=loss_rel, grad_rel=grad_rel,
                       grad_worst_leaf_rel=grad_leaf,
                       worst_leaves={k: leaf_rel[k] for k in worst},
                       card_s=card[2], cpu_s=cpu[2], **split)
            print(f"train agreement {arch} {name}: {json.dumps(row)}",
                  flush=True)
            if not (loss_rel <= loss_rtol[lk] and max(grad_rel, grad_leaf)
                    <= GRAD_AGREE[dtype]):
                raise AssertionError(
                    f"train agreement {arch} {name}: loss {loss_rel:.2e} "
                    f"(limit {loss_rtol[lk]}), {modes[0]} meta-gradient "
                    f"{grad_rel:.2e}/{grad_leaf:.2e} (limit "
                    f"{GRAD_AGREE[dtype]})")
            rows[name] = row
            del got, card, cpu, diff
            torch.cuda.empty_cache()
            continue
        curv = {d: {k: got[d, "maml"][1][k] - got[d, "fomaml"][1][k]
                    for k in card[1]} for d in (DEVICE, "cpu")}
        cnorms = {k: _norm(curv["cpu"], [k]) for k in curv["cpu"]}
        cbig = [k for k in cnorms if cnorms[k] >= LEAF_FLOOR * max(
            cnorms.values())]
        cdiff = {k: curv[DEVICE][k] - curv["cpu"][k] for k in cpu[1]}
        curv_rel = _norm(cdiff) / _norm(curv["cpu"])
        # routed leaves in bfloat16 as for the meta-gradient: through the
        # norm over all leaves (a hybrid model's maml has MoE blocks)
        curv_leaf = max(_norm(cdiff, [k]) / cnorms[k] for k in cbig
                        if not (dtype == torch.bfloat16 and k in routed))
        curv_ratio = _norm(curv[DEVICE]) / _norm(curv["cpu"])
        row = dict(loss_card=card[0], loss_cpu=cpu[0], loss_rel=loss_rel,
                   grad_rel=grad_rel, grad_worst_leaf_rel=grad_leaf,
                   curvature_rel=curv_rel, curvature_worst_leaf_rel=curv_leaf,
                   curvature_norm_ratio=curv_ratio,
                   curvature_share=_norm(curv["cpu"]) / _norm(cpu[1]),
                   card_s=card[2], cpu_s=cpu[2], **split)
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
        del got, card, cpu, diff, curv, cdiff
        torch.cuda.empty_cache()
    return rows


def witnessed_grads(arch, name, got, ref32, modes) -> dict:
    """The card's meta-gradients in a dtype without a standing limit, held
    against the CPU's float32 ones (``ref32``: {mode: (loss, gradient,
    seconds)}) within BF16_WITNESS times the distance of the CPU's own in
    that dtype; the losses and the distance to the CPU's run in that dtype
    reported; every value finite."""
    row, fails = {}, []
    for mode in modes:
        (lc, gc, _), (lh, gh, _) = got[DEVICE, mode], got["cpu", mode]
        l32 = ref32[mode][0]
        g32 = {k: v.to(DEVICE) for k, v in ref32[mode][1].items()}
        n32 = _norm(g32)
        card = _norm({k: gc[k] - g32[k] for k in g32}) / n32
        cpu = _norm({k: gh[k] - g32[k] for k in g32}) / n32
        r = row[mode] = dict(
            loss_card=lc, loss_cpu=lh, loss_cpu_f32=l32,
            loss_rel=abs(lc - lh) / abs(lh),
            card_loss_vs_cpu_f32=abs(lc - l32) / abs(l32),
            cpu_loss_vs_cpu_f32=abs(lh - l32) / abs(l32),
            grad_rel=_norm({k: gc[k] - gh[k] for k in gh}) / _norm(gh),
            card_grad_vs_cpu_f32=card, cpu_grad_vs_cpu_f32=cpu,
            grad_limit=BF16_WITNESS * cpu)
        del g32
        if not all(math.isfinite(v) for v in r.values()):
            fails.append(f"{mode}: not finite")
        elif not card <= BF16_WITNESS * cpu:
            fails.append(f"{mode} meta-gradient {card:.3e} from the CPU's "
                         f"float32 > {BF16_WITNESS} x the CPU's {name} "
                         f"{cpu:.3e}")
    print(f"train agreement {arch} {name} (against the CPU's float32): "
          f"{json.dumps(row)}", flush=True)
    if fails:
        raise AssertionError(f"train agreement {arch} {name}: "
                             + "; ".join(fails))
    return row


def meta_grad_split(inputs, dtype=torch.float32, mode="maml") -> dict:
    """One ``mode`` meta-gradient of ``inputs`` (``meta_grad_inputs``) on
    the card in ``dtype`` under torch.profiler, after a warm one: its wall
    and device time, and the device time and launches of the SSD scan's
    forward kernels, of T3's, of the backward's and of its tangent's
    (``ssd_role``), each share of the device time, and each SSD kernel's
    ms and launches.  It reads kernel names only, so
    scripts/profile_f32_meta_grad.py runs it on another commit's kernels
    too."""
    from torch.profiler import ProfilerActivity, profile
    meta_grads(inputs, DEVICE, dtype, (mode,))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        meta_grads(inputs, DEVICE, dtype, (mode,))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    roles = ("ssd_fwd", "ssd_t3", "ssd_bwd", "ssd_bwd_tangent")
    busy, split, counts, kernels = 0.0, dict.fromkeys(roles, 0.0), \
        dict.fromkeys(roles, 0), {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        busy += us
        role = ssd_role(evt.key)
        if role is not None:
            split[role] += us
            counts[role] += evt.count
            name = short_kernel(evt.key)
            k = kernels.setdefault(name, dict(ms=0.0, launches=0))
            k["ms"] += us / 1e3
            k["launches"] += evt.count
    row = dict(dtype=str(dtype)[6:], mode=mode, wall_s=wall)
    if not busy:
        return dict(row, device_ms="not measured")
    row.update(device_ms=busy / 1e3,
               device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
               **{f"{k}_ms": v / 1e3 for k, v in split.items()},
               **{f"{k}_launches": v for k, v in counts.items()},
               **{f"{k}_share": v / busy for k, v in split.items()},
               ssd_kernels=kernels)
    return row


# ---------------------------------------------------------------------------
# Phases 19-22: the MoE family -- deepseek-v2-lite-16b at full width,
# mixtral-8x22b at reduced width
# ---------------------------------------------------------------------------

# deepseek-v2-lite-16b at full width (d_model 2048, 16 MLA heads, kv_lora
# 512, 64 experts top-6 + 2 shared of 1408, vocab 102400) cut to
# DEEPSEEK_LAYERS of its 27 layers: the dense layer 0 and one MoE layer.
# The same cut serves, meta-trains and is held against the CPU.  Its eval
# adapts one task an agent: the harness vmaps K agents x tasks adapted
# copies of 2.17 GB, and 4 tasks ran the card out of memory beside the
# training state.
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 2
DEEPSEEK_SERVE_ARGS = ["--arch", DEEPSEEK, "--layers", str(DEEPSEEK_LAYERS),
                       *SERVE_ARGS[SERVE_ARGS.index("--batch"):]]
DEEPSEEK_TRAIN_SHAPE = QWEN_TRAIN_SHAPE
DEEPSEEK_TRAIN_ARGS = ["--arch", DEEPSEEK, "--shape",
                       DEEPSEEK_TRAIN_SHAPE["name"], "--layers",
                       str(DEEPSEEK_LAYERS), "--fused-outer",
                       "--steps-per-dispatch", "2", "--eval-every", "2",
                       "--eval-tasks", "1", "--eval-inner-steps", "1",
                       "--ckpt-every", "2", *TRAIN_COMMON]
# 2 steps of the grouped combine (``dif_combine``, one launch a step), no
# eval: the same cut, so its K=4 init is most of the run
DEEPSEEK_PALLAS_ARGS = ["--arch", DEEPSEEK, "--shape",
                        DEEPSEEK_TRAIN_SHAPE["name"], "--layers",
                        str(DEEPSEEK_LAYERS), "--combine", "pallas",
                        "--steps-per-dispatch", "1", *TRAIN_COMMON]
# The checkpoint and resume of deepseek's leaves (MLA, routed and shared
# experts, the dense first layer) and its momentum state, at reduced width
# (``--reduced``: the same blocks and leaf names, 128 wide): at the cut's
# full width each resume check wrote and read a 17.4 GB checkpoint, about
# 120 s of host time
DEEPSEEK_RESUME_ARGS = ["--arch", DEEPSEEK, "--reduced", "--shape",
                        DEEPSEEK_TRAIN_SHAPE["name"], "--fused-outer",
                        "--steps-per-dispatch", "2", "--eval-every", "2",
                        "--eval-tasks", "1", "--eval-inner-steps", "1",
                        "--ckpt-every", "2", *TRAIN_COMMON]
# MLA's attention route, fixed by the model's shapes (q/k head 192, v head
# 128): layers.mla_apply calls the plain attention by name.
MLA_ROUTE = ("plain attention (layers._plain_sdpa, the reference's "
             "_sdpa/_sdpa_chunked): q/k head qk_nope_dim + qk_rope_dim, v "
             "head v_head_dim; no TPU kernel takes two head dims")
# The MoE models' card-against-CPU limits (PERF.md, set before the first
# chip run): losses as mamba2's (MAMBA_AGREE_RTOL); the share of
# (token, choice) pairs whose expert differs between the card's and the
# CPU's routing of the same launch weights, over every MoE layer.  float32
# routes agree but for ties at the last bit; a bfloat16 activation one ulp
# apart can flip a near tie, which moves that token's output by O(1).
MOE_AGREE_RTOL = MAMBA_AGREE_RTOL
# one sequence of 128 tokens: at 64, deepseek's bf16 adapted support
# loss sat 1.36e-3 from the CPU's (limit 1e-3), a few tokens routed to
# other experts (5 of 384 pairs) weighing twice as much in the mean
MOE_AGREE_SEQ = 128
MOE_FLIP_LIMIT = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# Phase 21's configurations (arch, layers or None for reduced, modes):
# deepseek's cut and reduced mixtral, each in its own mode.
MOE_AGREE = ((DEEPSEEK, DEEPSEEK_LAYERS, ("fomaml",)),
             ("mixtral-8x22b", None, ("fomaml",)))
# moe_apply_einsum against moe_apply_sorted on the card under ample
# capacity, float32 with TF32 off: the same products, the k choices summed
# in another order.
MOE_DISPATCH_RTOL = 1e-5


def route_flip_share(cfg, seq: int, weights, witnessed=()) -> dict:
    """The share of (token, choice) pairs whose expert differs between the
    card's and the CPU's forward of one sequence on the same launch
    weights (float32 on the CPU), per dtype, over every MoE layer: a
    choice counts when its expert is not in the other device's top-k set
    of the token.  Held within MOE_FLIP_LIMIT, but in the dtypes
    ``witnessed``: there the card's choices that differ from the CPU's
    float32 ones may be at most BF16_WITNESS times as many as the CPU's own
    in that dtype."""
    from repro_torch.data.lm_tasks import LMTaskSource
    from repro_torch.models import layers
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    ep = LMTaskSource(vocab_size=cfg.padded_vocab, seq_len=seq, K=1,
                      tasks_per_agent=1, task_batch=1, n_domains=4,
                      seed=0).sample(0)
    batch = {k: torch.from_numpy(v[0, 0]) for k, v in ep.support.items()}
    dtypes = (torch.float32, torch.bfloat16)
    routes = {}
    for dtype in dtypes:
        for dev in (DEVICE, "cpu"):
            p = {k: v.to(dev, dtype) for k, v in weights.items()}
            with torch.no_grad(), layers.record_routes() as rec:
                model.forward(p, {k: v.to(dev) for k, v in batch.items()})
            routes[dtype, dev] = [r.cpu() for r in rec]
            del p

    def differ(a, b) -> tuple[int, int]:
        pairs = n = 0
        for x, y in zip(routes[a], routes[b]):
            hit = (x[..., :, None] == y[..., None, :]).any(-1)
            pairs += hit.numel()
            n += int((~hit).sum())
        return n, pairs

    out, fails = {}, []
    f32 = (torch.float32, "cpu")
    for dtype in dtypes:
        name = str(dtype)[6:]
        n, pairs = differ((dtype, DEVICE), (dtype, "cpu"))
        row = out[name] = dict(pairs=pairs, differ=n,
                               share=n / max(pairs, 1),
                               layers=len(routes[dtype, DEVICE]))
        if dtype in witnessed:
            card, _ = differ((dtype, DEVICE), f32)
            cpu, _ = differ((dtype, "cpu"), f32)
            row.update(card_vs_cpu_f32=card, cpu_vs_cpu_f32=cpu,
                       limit=BF16_WITNESS * cpu, witnessed=True)
            if not card <= BF16_WITNESS * cpu:
                fails.append(f"{name}: {card} of {pairs} (token, choice) "
                             f"pairs differ from the CPU's float32 routes, "
                             f"> {BF16_WITNESS} x the CPU's {name} {cpu}")
        else:
            row["limit"] = MOE_FLIP_LIMIT[dtype]
            if not row["share"] <= MOE_FLIP_LIMIT[dtype]:
                fails.append(f"{name}: {n} of {pairs} (token, choice) pairs "
                             f"differ (share {row['share']:.3e} > "
                             f"{MOE_FLIP_LIMIT[dtype]})")
    print(f"routing {cfg.name}: {json.dumps(out)}", flush=True)
    if fails:
        raise AssertionError(f"routing {cfg.name}: " + "; ".join(fails))
    return out


def moe_dispatch_check(cfg, B: int = 2, S: int = 128) -> dict:
    """``moe_apply_einsum`` (one group of S tokens) against
    ``moe_apply_sorted`` on the card at ``cfg``'s MoE layer width, float32,
    capacity ample (every pair kept on both paths); each path's time."""
    from repro_torch.models import layers
    from repro_torch.models.init import materialize
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
        cfg.num_experts), num_shared_experts=0)
    p = materialize(layers.moe_specs(cfg), torch.Generator().manual_seed(2),
                    torch.float32, DEVICE)
    x = torch.randn(B, S, cfg.d_model, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(3))
    with torch.no_grad():
        want = layers.moe_apply_sorted(p, cfg, x)
        got = layers.moe_apply_einsum(p, cfg, x, group_size=S)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        row = dict(arch=cfg.name, B=B, S=S, d=cfg.d_model,
                   experts=cfg.num_experts, k=cfg.experts_per_token,
                   hidden=cfg.moe_hidden, max_abs_err=err, scale=scale,
                   rtol=MOE_DISPATCH_RTOL,
                   sorted_ms=time_events(
                       lambda: layers.moe_apply_sorted(p, cfg, x), 5),
                   einsum_ms=time_events(
                       lambda: layers.moe_apply_einsum(p, cfg, x,
                                                       group_size=S), 5))
    print("moe dispatch", json.dumps(row), flush=True)
    if not (math.isfinite(err) and err <= MOE_DISPATCH_RTOL * scale):
        raise AssertionError(f"moe dispatch {cfg.name}: einsum vs sorted "
                             f"{err:.3e} > {MOE_DISPATCH_RTOL} x {scale:.3e}")
    del p, x, want, got
    torch.cuda.empty_cache()
    return row


def events_ms(fn):
    """(``fn()``, ms of that one eager call between CUDA events, host
    dispatch included)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def outer_kernels_at_leaves(ops, ref, cfg, agents: int) -> dict:
    """``fused_combine_update`` (momentum, ATC) and ``dif_combine`` over
    the leaves the meta-step hands them for ``cfg``: every leaf with the
    agent axis, bf16, the ring's Metropolis matrix.  Each is one launch,
    within TOL of its plain version leaf by leaf, timed (one call in a
    CUDA graph) beside the plain version (its one checking pass, leaf by
    leaf, between CUDA events) and the bound.  Memory-lean: at deepseek's 2-layer cut a
    leaf set is 8.7 GB."""
    from repro_torch.core import topology
    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    A = torch.as_tensor(topology.build_topology("ring", agents,
                                                "metropolis").matrix,
                        dtype=torch.float32, device=DEVICE)
    table = A[None].contiguous()
    shapes = {k: (agents,) + tuple(s.shape)
              for k, s in build_model(cfg).specs().items()}
    dtype = torch.bfloat16
    rand = lambda s: torch.randn(s, generator=gen, device=DEVICE).to(dtype)
    params = {k: rand(s) for k, s in shapes.items()}
    grads = {k: rand(s) for k, s in shapes.items()}
    mu = {k: rand(s) for k, s in shapes.items()}
    M = sum(x.numel() // agents for x in params.values())
    scale = torch.rand(agents, 1, generator=gen, device=DEVICE)
    hyper = dict(mode="atc", kind="momentum", lr=1e-3, step=3, every=1)
    fused = lambda ps, gs, ms: ops.fused_combine_update_leaves(
        table, scale, ps, gs, ms, None, **hyper)
    plain = lambda ps, gs, ms: ref.fused_update_leaves_ref(
        table, scale, ps, gs, ms, None, **hyper)
    rows = {}
    (w, m, _), launches = counted(ops, "fused_combine_update",
                                  lambda: fused(params, grads, mu),
                                  f"fused {cfg.name} leaves")
    err, plain_ms = 0.0, 0.0
    for k in shapes:
        (ww, wm, _), ms = events_ms(lambda: plain(
            {k: params[k]}, {k: grads[k]}, {k: mu[k]}))
        plain_ms += ms
        err = max(err, compare(w[k], ww[k], dtype, f"fused {k} w"),
                  compare(m[k], wm[k], dtype, f"fused {k} mu"))
        del ww, wm
    del w, m
    torch.cuda.empty_cache()
    rows["fused_combine_update"] = dict(
        what=f"{cfg.name} {cfg.num_layers}-layer leaves", kind="momentum",
        mode="atc", K=agents, leaves=len(shapes), columns=M,
        dtype="bfloat16", launches=launches, max_abs_err=err,
        tol=TOL[dtype], ms=time_ms(lambda: fused(params, grads, mu), 1,
                                   reps=3),
        plain_ms=plain_ms)
    rows["fused_combine_update"]["bound_ms"], \
        rows["fused_combine_update"]["bound_by"] = bound_ms(
            *fused_cost("momentum", "atc", agents, M, 2))
    del grads, mu
    torch.cuda.empty_cache()
    out, launches = counted(ops, "dif_combine",
                            lambda: ops.dif_combine_leaves(A, params),
                            f"dif_combine {cfg.name} leaves")
    err, plain_ms = 0.0, 0.0
    for k in shapes:
        want, ms = events_ms(lambda: ref.dif_combine_leaves_ref(
            A, {k: params[k]}))
        plain_ms += ms
        err = max(err, compare(out[k], want[k], dtype, f"dif_combine {k}"))
        del want
    del out
    torch.cuda.empty_cache()
    rows["dif_combine"] = dict(
        what=f"{cfg.name} {cfg.num_layers}-layer leaves", K=agents,
        leaves=len(shapes), columns=M, dtype="bfloat16", launches=launches,
        max_abs_err=err, tol=TOL[dtype],
        ms=time_ms(lambda: ops.dif_combine_leaves(A, params), 1, reps=3),
        plain_ms=plain_ms)
    rows["dif_combine"]["bound_ms"], rows["dif_combine"]["bound_by"] = \
        bound_ms(*combine_cost(agents, M, 2))
    for name, row in rows.items():
        print(f"check {name} at {cfg.name} leaves", json.dumps(row),
              flush=True)
    del params
    torch.cuda.empty_cache()
    return rows


def moe_phases(ops, ref, modules, cpu_halves) -> dict:
    """Phases 19-22: deepseek-v2-lite-16b served and meta-trained at full
    width cut to DEEPSEEK_LAYERS, the outer-update kernels at its leaves,
    and the MoE agreement checks (MOE_AGREE: deepseek's cut and reduced
    mixtral).  ``cpu_halves``: phase 21's CPU halves by name
    (``agree_cpu_halves(MOE_AGREE, MOE_AGREE_SEQ)``)."""
    from repro_torch.configs import get_config
    deepseek = dataclasses.replace(get_config(DEEPSEEK),
                                   num_layers=DEEPSEEK_LAYERS)
    t0, seconds = time.perf_counter(), {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
        print(f"moe: {name} took {seconds[name]:.1f} s", flush=True)

    counters = {"flash_attention_fwd": modules[1],
                "flash_attention_bwd": modules[1], "ssd_scan": modules[2]}
    # phase 19: serving; MLA runs the plain attention, so no flash or SSD
    # kernel may launch in the adapt dispatch
    print(f"deepseek serve: MLA attention route: {MLA_ROUTE}", flush=True)
    serve = serve_phase(DEEPSEEK_SERVE_ARGS, counters, lambda n, k: {})
    serve["attention_route"] = MLA_ROUTE
    lap("serve")
    # phase 20: meta-training, fused outer update one launch a step; then
    # 2 steps with ``--combine pallas``, one dif_combine launch a step; then
    # checkpoint and resume at reduced width (DEEPSEEK_RESUME_ARGS)
    train = train_phase(
        "deepseek", deepseek, DEEPSEEK_TRAIN_ARGS, DEEPSEEK_TRAIN_SHAPE,
        ("fused_combine_update",), ("--expect-fused", "--expect-outer-dtype",
                                    "bfloat16"),
        mode="fomaml", per_step={"fused_combine_update": 1},
        keep=False)
    lap("train")
    pallas = train_phase(
        "deepseek_pallas", deepseek, DEEPSEEK_PALLAS_ARGS,
        DEEPSEEK_TRAIN_SHAPE, ("dif_combine",),
        ("--expect-outer-dtype", "bfloat16", "--no-eval"), mode="fomaml",
        per_step={"dif_combine": 1}, profile=False, keep=False)
    lap("train_pallas")
    resume = train_phase(
        "deepseek_resume", get_config(DEEPSEEK).reduced(),
        DEEPSEEK_RESUME_ARGS, DEEPSEEK_TRAIN_SHAPE,
        ("fused_combine_update",), ("--expect-fused", "--expect-outer-dtype",
                                    "bfloat16"),
        resume=True, mode="fomaml", per_step={"fused_combine_update": 1},
        profile=False, keep=False)
    lap("train_resume")
    outer = outer_kernels_at_leaves(ops, ref, deepseek, agents=4)
    lap("outer_kernels")
    # phase 21: the 2-layer cut and reduced mixtral against the CPU (phase
    # 15's meta-gradient, the routing flips, phase 8's adapted losses), one
    # set of weights for the three checks
    agree = {}
    for arch, layers, _ in MOE_AGREE:
        cfg = agree_cfg(arch, layers)
        half = cpu_halves.pop(cfg.name)
        w = half["inputs"][2]
        agree[cfg.name] = dict(
            meta_gradient=train_agreement_phase(half, MOE_AGREE_RTOL),
            routing=route_flip_share(cfg, MOE_AGREE_SEQ, w),
            losses=agreement_phase(cfg, MOE_AGREE_RTOL, seq=MOE_AGREE_SEQ,
                                   task_batch=1, weights=w))
        del w
        lap(f"agreement {cfg.name}")
    # phase 22: the two dispatch paths on the card
    dispatch = moe_dispatch_check(deepseek)
    lap("dispatch")
    return dict(serve=serve, train=train, train_pallas=pallas,
                train_resume=resume, outer=outer, agreement=agree,
                dispatch=dispatch, seconds=seconds)


# ---------------------------------------------------------------------------
# Phases 23-26: the encoder-decoder and vision families -- whisper-large-v3
# at full width, llama-3.2-vision-90b at reduced width
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"
VISION = "llama-3.2-vision-90b"
# The flash kernels at the shapes these families give them, (B, S, S_k, H,
# KV, d), non-causal: whisper's encoder (1500 frames: 23 full key tiles of
# 64 and one of 28; 20 heads of 64), its decoder's cross-attention (256
# queries against the 1500 frames) and reduced llama-vision's
# cross-attention (64 queries, 4 heads, against 16 patches with 2 KV heads:
# fewer keys than one tile); and causal rows with S != S_k, which the
# models never make (query i sees keys 0..i).
ENCDEC_FLASH = {"whisper encoder": (4, 1500, 1500, 20, 20, 64, False),
                "whisper cross": (4, 256, 1500, 20, 20, 64, False),
                "vision cross": (2, 64, 16, 4, 2, 32, False),
                "causal S < S_k": (2, 192, 320, 4, 2, 64, True),
                "causal S > S_k": (2, 320, 192, 4, 2, 64, True)}
# the timed rows, at the serving batch (4 users x 4 sequences), bf16
ENCDEC_TIMED = ("whisper encoder", "whisper cross")
ENCDEC_SERVE_B = 16
# keys of whisper's last, partial key tile: zeroed in the kernel's input
# only, the check against the plain version must fail
RAGGED_KEYS = (1472, 1500)
# whisper serves at full width cut to WHISPER_SERVE_LAYERS encoder and as
# many decoder layers of its 32 + 32 (time limit), 128 + 128 tokens (under
# its 448 positions), and trains cut to WHISPER_TRAIN_LAYERS + as many
WHISPER_SERVE_LAYERS = 4
WHISPER_SERVE_ARGS = ["--arch", WHISPER, "--layers",
                      str(WHISPER_SERVE_LAYERS),
                      *SERVE_ARGS[SERVE_ARGS.index("--batch"):]]
WHISPER_TRAIN_LAYERS = 2
WHISPER_TRAIN_SHAPE = QWEN_TRAIN_SHAPE
WHISPER_TRAIN_ARGS = ["--arch", WHISPER, "--shape",
                      WHISPER_TRAIN_SHAPE["name"], "--layers",
                      str(WHISPER_TRAIN_LAYERS), "--fused-outer",
                      "--steps-per-dispatch", "2", "--eval-every", "2",
                      "--eval-tasks", "1", "--eval-inner-steps", "1",
                      "--ckpt-every", "2", *TRAIN_COMMON]
WHISPER_PALLAS_ARGS = ["--arch", WHISPER, "--shape",
                       WHISPER_TRAIN_SHAPE["name"], "--layers",
                       str(WHISPER_TRAIN_LAYERS), "--combine", "pallas",
                       "--steps-per-dispatch", "1", *TRAIN_COMMON]
# The card against the CPU (PERF.md, set before the first chip run):
# losses as mamba2's, meta-gradients GRAD_AGREE / CURV_AGREE; one sequence
# of 128 tokens (whisper: and its 1500 random frames), every gate 0.5.
# whisper is held cut to WHISPER_AGREE_LAYERS + as many layers: its CPU
# runs (the encoder over 1500 frames, through second order) are most of
# these phases' host time, and a second mode doubles them.
WHISPER_AGREE_LAYERS = 1
ENCDEC_AGREE_RTOL = MAMBA_AGREE_RTOL
ENCDEC_AGREE_SEQ = 128
GATE = 0.5
# Phase 26's configurations (arch, layers or None for reduced, modes):
# whisper in its mode and fomaml, so that the curvature part is held, the
# vision model in its mode.
ENCDEC_AGREE = ((WHISPER, WHISPER_AGREE_LAYERS, ("maml", "fomaml")),
                (VISION, None, ("fomaml",)))


def ragged_tile_fault(fops, fref, gen, dtype) -> dict:
    """whisper's encoder shape with keys and values RAGGED_KEYS zeroed in the
    kernels' input only: the forward's output and the backward's gradients
    must fail the check against the plain version on the true inputs, which
    shows that the last, partial key tile is read; the true inputs pass."""
    B, S, Sk, H, KV, d, causal = ENCDEC_FLASH["whisper encoder"]
    q, do = (randn_view(gen, (B, S, H, d), dtype) for _ in "qo")
    k, v = (randn_view(gen, (B, Sk, KV, d), dtype) for _ in "kv")
    lo, hi = RAGGED_KEYS
    cut = [t.clone() for t in (k, v)]
    for t in cut:
        t[:, lo:hi] = 0
    kw = dict(causal=causal, window=None)
    tol = FLASH_TOL[dtype]
    want, want_lse = fref.gqa_flash_fwd_ref(q, k, v, **kw)
    wants = fref.gqa_flash_bwd_ref(q, k, v, want, want_lse, do, **kw)
    row = {}
    for name, (kk, vv) in (("true", (k, v)), ("zeroed", cut)):
        out, lse = fops.gqa_flash_attention_fwd_lse(q, kk, vv, **kw)
        grads = fops.gqa_flash_attention_bwd(q, kk, vv, want, want_lse, do,
                                             **kw)
        torch.cuda.synchronize()
        flagged = {"out": outside(out, want, tol["fwd"], row_atol(want))[0]}
        flagged.update({f"d{n}": outside(g, w, tol["bwd"], row_atol(w))[0]
                        for g, w, n in zip(grads, wants, "qkv")})
        row[name] = flagged
    if any(row["true"].values()):
        raise AssertionError(f"ragged tile {dtype}: the true inputs fail "
                             f"the check: {row['true']}")
    if not (row["zeroed"]["out"] and row["zeroed"]["dq"]):
        raise AssertionError(f"ragged tile {dtype}: keys {lo}:{hi} zeroed "
                             f"in the kernels' input pass the check: "
                             f"{row['zeroed']}")
    row.update(dtype=str(dtype)[6:], keys=list(RAGGED_KEYS))
    print("ragged tile planted fault", json.dumps(row), flush=True)
    return row


def ragged_tangent_fault(fops, fref, gen) -> dict:
    """ragged_tile_fault for the bf16 tangent kernels: whisper's encoder
    shape with K, V, K' and V' zeroed at RAGGED_KEYS in T1's and T2's input
    only; o' and dq' must fail the check against the plain versions on the
    true inputs, which pass."""
    B, S, Sk, H, KV, d, causal = ENCDEC_FLASH["whisper encoder"]
    bf = torch.bfloat16
    q, tq, do, tdo = (randn_view(gen, (B, S, H, d), bf) for _ in range(4))
    k, v, tk, tv = (randn_view(gen, (B, Sk, KV, d), bf) for _ in range(4))
    kw = dict(causal=causal, window=None, heads_dim=2)
    out, lse = fref.gqa_flash_fwd_ref(q, k, v, causal=causal, window=None)
    want_to, want_tlse = fref.flash_fwd_tangent_ref(q, k, v, tq, tk, tv, **kw)
    wants = fref.flash_bwd_tangent_ref(q, k, v, out, lse, do, tq, tk, tv,
                                       want_to, want_tlse, tdo, **kw)
    lo, hi = RAGGED_KEYS
    cut = [t.clone() for t in (k, v, tk, tv)]
    for t in cut:
        t[:, lo:hi] = 0
    row = {}
    for name, (kk, vv, tkk, tvv) in (("true", (k, v, tk, tv)),
                                     ("zeroed", cut)):
        to, tlse = fops.flash_attention_fwd_tangent(q, kk, vv, lse, tq, tkk,
                                                    tvv, **kw)
        grads = fops.flash_attention_bwd_tangent(q, kk, vv, out, lse, do, tq,
                                                 tkk, tvv, want_to,
                                                 want_tlse, tdo, **kw)
        torch.cuda.synchronize()
        flagged = {"o'": tangent_outside(to, want_to)[0],
                   "lse'": tangent_outside(tlse, want_tlse)[0]}
        flagged.update({f"d{n}'": tangent_outside(g, w)[0]
                        for g, w, n in zip(grads, wants, "qkv")})
        row[name] = flagged
    if any(row["true"].values()):
        raise AssertionError(f"ragged tile, tangents: the true inputs fail "
                             f"the check: {row['true']}")
    if not (row["zeroed"]["o'"] and row["zeroed"]["dq'"]):
        raise AssertionError(f"ragged tile, tangents: keys {lo}:{hi} zeroed "
                             f"in the kernels' input pass the check: "
                             f"{row['zeroed']}")
    row.update(dtype="bfloat16", keys=list(RAGGED_KEYS))
    print("ragged tile planted fault, T1 and T2", json.dumps(row), flush=True)
    return row


# T1 and T2 in bf16 at whisper's training shapes, (S, S_k, causal): the
# encoder's 1500 frames, the cross-attention's 256 queries against them and
# the decoder's causal 256; 20 heads of 64.  Timed at the batch the
# training run's tangent calls have; the plain versions (float64 sums,
# seconds and tens of GB at 1500 frames) at TANGENT_PLAIN_B sequences, the
# kernels' first sequences held against them.
WHISPER_TANGENT = {"whisper encoder": (1500, 1500, False),
                   "whisper cross": (256, 1500, False),
                   "whisper decoder": (256, 256, True)}
TANGENT_PLAIN_B = 2


def tangent_batch(calls: dict, S, Sk, causal) -> int:
    """The batch of the T1 calls of one shape in ``tangent_calls``' tally;
    raises if the run made none."""
    mask = "causal" if causal else "full"
    batches = {int(key.split()[1].split("x")[0]) for key in calls
               if key.startswith("T1 ") and key.endswith(f"x{S}x{Sk} {mask}")}
    if len(batches) != 1:
        raise AssertionError(f"T1 calls of {S}x{Sk} {mask}: batches "
                             f"{batches} in {calls}")
    return batches.pop()


def whisper_tangent_rows(fops, fref, calls: dict) -> dict:
    """T1 and T2 (bf16) timed apart at WHISPER_TANGENT's shapes, at the
    training run's batch (``calls``: its profiled meta-step's tally), each
    beside its bounds (operations, and this design's hi/lo products) and
    the plain version's time at TANGENT_PLAIN_B sequences; the first
    sequences within TANGENT_TOL of the plain versions."""
    from repro_torch.kernels.flash_attention.ref import band_mask
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    bf, H, d = torch.bfloat16, 20, 64
    rows = {}
    for name, (S, Sk, causal) in WHISPER_TANGENT.items():
        B = tangent_batch(calls, S, Sk, causal)
        q, tq, do, tdo = (randn_view(gen, (B, S, H, d), bf) for _ in range(4))
        k, v, tk, tv = (randn_view(gen, (B, Sk, H, d), bf) for _ in range(4))
        kw = dict(causal=causal, window=None, heads_dim=2)
        out, lse = fops.gqa_flash_attention_fwd_lse(q, k, v, causal=causal)
        t1 = lambda: fops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk,
                                                      tv, **kw)
        to, tlse = t1()
        t2 = lambda: fops.flash_attention_bwd_tangent(
            q, k, v, out, lse, do, tq, tk, tv, to, tlse, tdo, **kw)
        grads = t2()
        b = min(B, TANGENT_PLAIN_B)
        first = lambda *ts: [t[:b] for t in ts]
        plain1 = lambda: fref.flash_fwd_tangent_ref(
            *first(q, k, v, tq, tk, tv), **kw)
        plain2 = lambda: fref.flash_bwd_tangent_ref(
            *first(q, k, v, out, lse, do, tq, tk, tv, to, tlse, tdo), **kw)
        what = f"{name} T1/T2 bf16 (first {b} of {B} sequences)"
        e1 = max(check_tangent(g, w, f"{what} {n}'") for g, w, n in
                 zip(first(to, tlse), plain1(), ("o", "lse")))
        e2 = max(check_tangent(g, w, f"{what} {n}'") for g, w, n in
                 zip(first(*grads), plain2(), ("dq", "dk", "dv")))
        pairs = int(band_mask(S, Sk, causal, None).sum())
        row = dict(B=B, S=S, Sk=Sk, H=H, KV=H, d=d, causal=causal,
                   dtype="bfloat16", plain_B=b, fwd_max_abs_err=e1,
                   bwd_max_abs_err=e2)
        for p, fn, plain in (("fwd", t1, plain1), ("bwd", t2, plain2)):
            nbytes, flops = flash_tangent_cost(B, H, H, S, d, 2, pairs,
                                               p == "bwd", Sk=Sk)
            row[f"{p}_ms"] = time_ms(fn, 5)
            row[f"{p}_plain_ms"] = time_events(plain, 2)
            row[f"{p}_bound_ms"], row[f"{p}_bound_by"] = bound_ms(
                nbytes, flops, BF16_FLOP_PER_S)
            row[f"{p}_design_bound_ms"] = bound_ms(
                nbytes, flash_tangent_design_flops(B, H, d, pairs,
                                                   p == "bwd"),
                BF16_FLOP_PER_S)[0]
        print(f"{name} tangents bf16 at B={B}: T1 {row['fwd_ms']:.4f} ms "
              f"(bound {row['fwd_bound_ms']:.4f} {row['fwd_bound_by']}, this "
              f"design {row['fwd_design_bound_ms']:.4f}, plain at B={b} "
              f"{row['fwd_plain_ms']:.3f}); T2 {row['bwd_ms']:.4f} ms (bound "
              f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']}, this design "
              f"{row['bwd_design_bound_ms']:.4f}, plain "
              f"{row['bwd_plain_ms']:.3f}); errs {e1:.2e} {e2:.2e}",
              flush=True)
        rows[name] = row
        del q, k, v, tq, tk, tv, do, tdo, out, lse, to, tlse, grads
        torch.cuda.empty_cache()
    return rows


def encdec_flash_phase(fops, fref) -> dict:
    """Phase 23: the flash forward, backward, T1 and T2 at the shapes of
    ENCDEC_FLASH in both dtypes against their plain versions; the encoder
    and cross rows timed at the serving batch in bf16 (bounds, SDPA); the
    ragged key tile's planted fault for the forward and backward and for
    the bf16 tangents.  (T1 and T2 are timed at whisper's training shapes
    after its training run, ``whisper_tangent_rows``.)"""
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    rows, tangents = {}, {}
    for name, (B, S, Sk, H, KV, d, causal) in ENCDEC_FLASH.items():
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{name} {str(dtype)[6:]}"
            rows[key] = check_gqa_flash(fops, fref, gen, B, S, H, KV, d,
                                        dtype, causal, None, timed=False,
                                        Sk=Sk)
            tangents[key] = check_flash_tangents(
                fops, fref, gen, 2, (B, S, H, KV, d), dtype, causal, None,
                Sk=Sk)
        torch.cuda.empty_cache()
    timed = {}
    for name in ENCDEC_TIMED:
        _, S, Sk, H, KV, d, causal = ENCDEC_FLASH[name]
        timed[name] = check_gqa_flash(fops, fref, gen, ENCDEC_SERVE_B, S, H,
                                      KV, d, torch.bfloat16, causal, None,
                                      n=10, Sk=Sk)
        t = timed[name]
        print(f"{name} flash bf16 at B={ENCDEC_SERVE_B}: forward "
              f"{t['fwd_ms']:.4f} ms (bound {t['fwd_bound_ms']:.4f} "
              f"{t['fwd_bound_by']}, SDPA {t['fwd_library_ms']:.4f}, plain "
              f"{t['fwd_plain_ms']:.3f}); backward {t['bwd_ms']:.4f} ms "
              f"(bound {t['bwd_bound_ms']:.4f} {t['bwd_bound_by']}, SDPA "
              f"{t['bwd_library_ms']:.4f}, plain {t['bwd_plain_ms']:.3f})",
              flush=True)
        torch.cuda.empty_cache()
    faults = {str(dt)[6:]: ragged_tile_fault(fops, fref, gen, dt)
              for dt in (torch.bfloat16, torch.float32)}
    faults["tangents bfloat16"] = ragged_tangent_fault(fops, fref, gen)
    torch.cuda.empty_cache()
    return dict(rows=rows, tangents=tangents, timed=timed,
                ragged_tile_faults=faults)


def tangent_encdec_summary(name, encdec) -> dict:
    """The kernels-line keys of T1 or T2 at whisper's training shapes (bf16,
    the training run's batch) and their launches in its training run."""
    p = "fwd" if name.endswith("fwd_tangent") else "bwd"
    out = {}
    for row_name, row in encdec["tangents"].items():
        out[row_name.replace(" ", "_")] = dict(
            shape={k: row[k] for k in ("B", "S", "Sk", "H", "KV", "d",
                                       "dtype", "causal")},
            **{k: row[f"{p}_{k}"] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "design_bound_ms")},
            plain_B=row["plain_B"], library_ms=None)
    out["whisper_train_launches"] = encdec["train"]["launches"][name]
    return out


def encdec_summary(name, flash, encdec) -> dict:
    """The kernels-line keys of one flash kernel at whisper's shapes: the
    timed encoder and cross rows (bf16, serving batch) and the launches of
    whisper's serve and training runs."""
    p = "fwd" if name.endswith("fwd") else "bwd"
    out = {}
    for row_name, row in flash["timed"].items():
        out[row_name.replace(" ", "_")] = dict(
            shape=dict(B=row["B"], S=row["S"], Sk=row["Sk"], H=row["H"],
                       KV=row["KV"], d=row["d"], dtype=row["dtype"],
                       causal=row["causal"]),
            max_abs_err=row[f"{p}_max_abs_err"], ms=row[f"{p}_ms"],
            plain_ms=row[f"{p}_plain_ms"], bound_ms=row[f"{p}_bound_ms"],
            bound_by=row[f"{p}_bound_by"],
            library_ms=row[f"{p}_library_ms"])
    out["whisper_serve_launches"] = encdec["serve"]["launches"][name]
    out["whisper_train_launches"] = encdec["train"]["launches"][name]
    return out


def encdec_phases(ops, ref, modules, cpu_halves) -> dict:
    """Phases 24-26: whisper-large-v3 served at full width cut to
    WHISPER_SERVE_LAYERS + as many, meta-trained cut to
    WHISPER_TRAIN_LAYERS + as many (``maml``, Adam, ``--fused-outer`` with
    eval, checkpoint and resume, then ``--combine pallas``), and its
    WHISPER_AGREE_LAYERS + as many cut and reduced llama-3.2-vision held
    against the CPU with random frames and patches and every gate at
    GATE (ENCDEC_AGREE).  ``cpu_halves``: phase 26's CPU halves by name
    (``agree_cpu_halves(ENCDEC_AGREE, ENCDEC_AGREE_SEQ)``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    t0, seconds = time.perf_counter(), {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
        print(f"encdec: {name} took {seconds[name]:.1f} s", flush=True)

    counters = {"flash_attention_fwd": modules[1],
                "flash_attention_bwd": modules[1], "ssd_scan": modules[2]}
    # phase 24: serving.  Each adapt step runs, a layer, the encoder's
    # self-attention, the decoder's and its cross-attention forward and
    # backward; decoding runs the encoder once more (the cross K/V)
    serve = serve_phase(
        WHISPER_SERVE_ARGS, counters,
        lambda n, k: {"flash_attention_fwd": 3 * n * k + n,
                      "flash_attention_bwd": 6 * n * k},
        replay=("profile", "roles"))
    # the adapt dispatch's launches by role, measured in a replay: each
    # role's forward once and its backward's two launches a layer and step
    n, k = serve["layers"], serve["adapt_steps"]
    roles = serve["dispatch_roles"]
    got = {r: (v["forward"], v["backward"]) for r, v in roles.items()}
    want = {r: (n * k, 2 * n * k) for r in ("encoder", "decoder", "cross")}
    if got != want:
        raise AssertionError(f"whisper serve: flash launches by role {roles}"
                             f", expected {want} (forward, backward)")
    print(f"whisper serve: the adapt dispatch's flash launches by role "
          f"(measured) {json.dumps(roles)}", flush=True)
    lap("serve")
    # phase 25: meta-training, exact MAML through T1/T2
    whisper = S.cut_depth(get_config(WHISPER), WHISPER_TRAIN_LAYERS)
    train = train_phase(
        "whisper", whisper, WHISPER_TRAIN_ARGS, WHISPER_TRAIN_SHAPE,
        ("flash_attention_fwd", "flash_attention_bwd",
         "flash_attention_fwd_tangent", "flash_attention_bwd_tangent",
         "fused_combine_update"),
        ("--expect-fused", "--expect-outer-dtype", "bfloat16"),
        resume=True, per_step={"fused_combine_update": 1}, keep=False)
    lap("train")
    # T1 and T2 apart at whisper's training shapes, at the batch of the
    # profiled meta-step's tangent calls
    from repro_torch.kernels.flash_attention import ref as fref
    tangents = whisper_tangent_rows(modules[1], fref,
                                    train["profile"]["tangent_calls"])
    lap("tangents")
    pallas = train_phase(
        "whisper_pallas", whisper, WHISPER_PALLAS_ARGS, WHISPER_TRAIN_SHAPE,
        ("dif_combine", "flash_attention_fwd", "flash_attention_bwd"),
        ("--expect-outer-dtype", "bfloat16", "--no-eval"),
        per_step={"dif_combine": 1}, profile=False, keep=False)
    lap("train_pallas")
    # phase 26: the card against the CPU, random frames and patches, gates
    # at GATE (ENCDEC_AGREE)
    agree = {}
    for arch, layers, _ in ENCDEC_AGREE:
        cfg = agree_cfg(arch, layers)
        half = cpu_halves.pop(cfg.name)
        w = half["inputs"][2]
        agree[cfg.name] = dict(meta_gradient=train_agreement_phase(
            half, ENCDEC_AGREE_RTOL))
        if arch == VISION:
            agree[cfg.name]["losses"] = agreement_phase(
                cfg, ENCDEC_AGREE_RTOL, seq=ENCDEC_AGREE_SEQ, task_batch=1,
                weights=w)
        del w
        lap(f"agreement {cfg.name}")
    return dict(serve=serve, train=train, train_pallas=pallas,
                agreement=agree, tangents=tangents, seconds=seconds)


# ---------------------------------------------------------------------------
# Phases 27-30: the last five configurations -- qwen2-7b served at full
# width, the five held against the CPU at reduced width, jamba's hybrid
# through the entry points at reduced width
# ---------------------------------------------------------------------------

QWEN7 = "qwen2-7b"
JAMBA = "jamba-1.5-large-398b"
NEW_ARCHS = (QWEN7, "qwen2-7b-swa", "codeqwen1.5-7b", "command-r-35b", JAMBA)
# The new configurations' attention at full width in the model's layout,
# bf16, causal: (B, S, H, KV, d, window).  qwen2-7b at the serving shape
# (28 query heads over 4 KV heads), codeqwen's full MHA, command-r's 64
# over 8, and one qwen2-7b KV group at 10240 tokens under the real window
# of 8192, so the band crosses many key tiles (its plain version's
# 7 x 10240^2 float32 scores are 2.9 GB).
NEW_FLASH = {"qwen2-7b serving": (16, 256, 28, 4, 128, None),
             "codeqwen1.5-7b": (16, 256, 32, 32, 128, None),
             "command-r-35b": (16, 256, 64, 8, 128, None),
             "qwen2-7b-swa window 8192": (1, 10240, 7, 1, 128, 8192)}
# qwen2-7b at full width (d_model 3584, 28/4 heads of 128, d_ff 18944,
# vocab 152064) cut to 2 of its 28 layers: 1.556 B parameters, bf16; phase
# 7's arguments.
QWEN7_SERVE_LAYERS = 2
QWEN7_SERVE_ARGS = ["--arch", QWEN7, "--layers", str(QWEN7_SERVE_LAYERS),
                    *SERVE_ARGS[SERVE_ARGS.index("--batch"):]]
# Phases 8 and 15 at reduced width: one sequence of 128 tokens (twice
# qwen2-7b-swa's reduced window of 64; four of jamba's SSD chunks of 32),
# mamba2's limits (the MoE models' too).
NEW_AGREE_SEQ = 128
NEW_AGREE_RTOL = MAMBA_AGREE_RTOL
# Reduced jamba is held in float32 at an inner step of lr 1e-5 for its
# config's 1e-2.  On a fresh init its gradient norm is 112 (92 of it the
# 0.02-scale embedding's, through the first norm), and a step of 1e-2
# lands where float32 itself lies far from float64: on the CPU (seed 1,
# these 128 tokens) the meta-gradient 1.0e-2 and the adapted support loss
# 3.9e-3 from a float64 run (seeds 0-2: 0.65-9.3%), past any limit that
# could tell a kernel's fault from rounding.  At 1e-5: 8.0e-5 (maml),
# 7.6e-5 (fomaml), the curvature part 2.5e-4, the adapted loss 9.3e-7,
# inside phase 15's and phase 8's float32 limits.  bfloat16 lies 75-165%
# from float64 on the meta-gradient at either lr, so jamba's bfloat16
# meta-gradients and routing are held through the CPU's float32 run
# (BF16_WITNESS) and its bfloat16 losses reported: behind the Mamba
# blocks a bf16 forward routes 2.8% of (token, choice) pairs otherwise
# than a float32 one on the CPU, and the card's bf16 2.15% otherwise than
# the CPU's (NVIDIA H100 80GB HBM3, 700.00 W), past phase 21's 2%.
JAMBA_AGREE_LR = 1e-5
JAMBA_AGREE_RTOL = {k: v for k, v in NEW_AGREE_RTOL.items() if "f32" in k}
# Phase 29's configurations (arch, layers or None for reduced, modes).
NEW_AGREE = tuple((arch, None, ("maml", "fomaml")) for arch in NEW_ARCHS)


# Reduced jamba (one period: attention + MLP, then seven Mamba blocks, MoE
# on every other one) through launch/serve.py (float32, as a reduced
# config serves: the float32 flash, SSD scan and SSD backward kernels) and
# launch/train.py (bfloat16: fomaml, SGD, the fused outer update, eval,
# checkpoint and resume).
JAMBA_SERVE_ARGS = ["--arch", JAMBA, "--reduced", "--batch", "4",
                    "--prompt-len", "64", "--gen", "64", "--adapt-steps",
                    "2", "--users", "4", "--rounds", "2", "--seed", "0"]
JAMBA_TRAIN_SHAPE = dict(name="chip_train_128", seq=128, batch=16)
JAMBA_TRAIN_ARGS = ["--arch", JAMBA, "--reduced", "--shape",
                    JAMBA_TRAIN_SHAPE["name"], "--fused-outer",
                    "--steps-per-dispatch", "2", "--eval-every", "2",
                    "--eval-tasks", "4", "--eval-inner-steps", "1",
                    "--ckpt-every", "2", *TRAIN_COMMON]
# The kernels one maml meta-gradient of a hybrid model must launch: T1 and
# T2 in its attention block, T3 and the SSD backward's tangent in its Mamba
# blocks, beside the forward and backward kernels.
HYBRID_MAML_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                       "flash_attention_fwd_tangent",
                       "flash_attention_bwd_tangent", "ssd_scan",
                       "ssd_scan_tangent", "ssd_scan_bwd",
                       "ssd_scan_bwd_tangent")


def new_flash_phase(fops, fref) -> dict:
    """Phase 27: the flash forward and backward at NEW_FLASH's shapes, bf16,
    against ``attention_ref``'s autograd and the plain backward, timed
    beside their bounds and SDPA's times (``check_gqa_flash``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    rows = {}
    for name, (B, S, H, KV, d, window) in NEW_FLASH.items():
        rows[name] = check_gqa_flash(fops, fref, gen, B, S, H, KV, d,
                                     torch.bfloat16, True, window,
                                     n=3 if S > 1024 else 10)
        torch.cuda.empty_cache()
    return rows


def hybrid_serve_expect(cfg):
    """The launches of one float32 adapt dispatch of ``cfg``'s hybrid plan
    (``serve_phase``'s ``expect``): a layer of attention a period, the
    other ``attn_every - 1`` Mamba, a forward and a backward each a step."""
    def expect(layers, steps):
        attn = layers // cfg.attn_every * steps
        mamba = layers * steps - attn
        return {"flash_attention_fwd": attn,
                "flash_attention_bwd": 2 * attn,
                "ssd_scan": mamba, **{p: mamba for p in SSD_F32_PASSES},
                "ssd_scan_bwd": mamba,
                **{p: mamba for p in SSD_BWD_KERNELS}}
    return expect


def new_configs_phases(modules, cpu_halves) -> dict:
    """Phases 28-30: qwen2-7b served at full width cut to
    QWEN7_SERVE_LAYERS; the five new configurations at reduced width held
    against the CPU (phases 8 and 15; jamba also in maml, and its routing
    flips); reduced jamba served and meta-trained through the entry
    points.  ``cpu_halves``: phase 29's CPU halves by name
    (``agree_cpu_halves(NEW_AGREE, NEW_AGREE_SEQ)``)."""
    from repro_torch.configs import get_config
    t0, seconds = time.perf_counter(), {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
        print(f"new configs: {name} took {seconds[name]:.1f} s", flush=True)

    counters = {"flash_attention_fwd": modules[1],
                "flash_attention_bwd": modules[1], "ssd_scan": modules[2]}
    # phase 28: qwen2-7b at full width; per layer and adapt step one flash
    # forward launch and the backward's two
    serve = serve_phase(QWEN7_SERVE_ARGS, counters, lambda n, k: {
        "flash_attention_fwd": n * k, "flash_attention_bwd": 2 * n * k})
    lap("qwen2-7b serve")
    # phase 29: each new configuration at reduced width against the CPU;
    # jamba's maml meta-gradient runs the tangent kernels in one hybrid
    # model
    agree = {}
    for arch, layers, _ in NEW_AGREE:
        cfg = agree_cfg(arch, layers)
        rtol = JAMBA_AGREE_RTOL if arch == JAMBA else NEW_AGREE_RTOL
        half = cpu_halves.pop(cfg.name)
        w = half["inputs"][2]
        for m in modules:
            m.reset_launch_counts()
        row = dict(meta_gradient=train_agreement_phase(half, rtol))
        if arch == JAMBA:
            launched = all_counts(modules)
            missing = [k for k in HYBRID_MAML_KERNELS if not launched.get(k)]
            if missing:
                raise AssertionError(f"agreement {arch}: kernels {missing} "
                                     f"never launched in the maml "
                                     f"meta-gradients: {launched}")
            row["meta_gradient_launches"] = {
                k: launched[k] for k in HYBRID_MAML_KERNELS}
            row["routing"] = route_flip_share(cfg, NEW_AGREE_SEQ, w,
                                              witnessed=(torch.bfloat16,))
        row["losses"] = agreement_phase(cfg, rtol, seq=NEW_AGREE_SEQ,
                                        task_batch=1, weights=w)
        agree[arch] = row
        del w
        lap(f"agreement {arch}")
    # phase 30: reduced jamba through launch/serve.py and launch/train.py
    jamba = get_config(JAMBA).reduced()
    jamba_serve = serve_phase(JAMBA_SERVE_ARGS, counters,
                              hybrid_serve_expect(jamba))
    lap("jamba serve")
    jamba_train = train_phase(
        "jamba", jamba, JAMBA_TRAIN_ARGS, JAMBA_TRAIN_SHAPE,
        ("flash_attention_fwd", "flash_attention_bwd", "ssd_scan",
         *SSD_PASSES, "ssd_scan_bwd", *SSD_BWD_KERNELS,
         "fused_combine_update"),
        ("--expect-fused", "--expect-outer-dtype", "bfloat16"),
        resume=True, mode="fomaml",
        per_step={"fused_combine_update": outer_launches_per_step(jamba)},
        profile=False, keep=False)
    lap("jamba train")
    return dict(serve=serve, agreement=agree, jamba_serve=jamba_serve,
                jamba_train=jamba_train, seconds=seconds)


def outer_launches_per_step(cfg) -> int:
    """The fused outer update's launches a step over ``cfg``'s leaves, one
    dtype group: the kernel takes up to MAX_LEAVES leaves a launch (reduced
    jamba's 142 leaves take three)."""
    from repro_torch.kernels.dif_combine import ops
    from repro_torch.models.transformer import build_model
    return math.ceil(len(build_model(cfg).specs()) / ops.MAX_LEAVES)


def new_flash_summary(name, rows) -> dict:
    """The kernels-line keys of one flash kernel at NEW_FLASH's shapes."""
    phase = "fwd" if name == "flash_attention_fwd" else "bwd"
    return {"new_config_shapes": {
        shape: {k: row.get(f"{phase}_{k}") for k in
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "max_abs_err")} | dict(B=row["B"], S=row["S"], H=row["H"],
                                        KV=row["KV"], d=row["d"],
                                        window=row["window"])
        for shape, row in rows.items()}}


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
          f"kernels it replaced {T2_F32_SIMT_MS} ms (PERF.md)", flush=True)
    print(f"lm-100m f32 T1 (3xTF32): {tangent['fwd_ms']:.4f} ms; bounds "
          f"{tangent['fwd_bound_ms']:.4f} ms (float32 rate, "
          f"{tangent['fwd_bound_by']}), {tangent['fwd_tf32_bound_ms']:.4f} "
          f"ms (three TF32 products, {tangent['fwd_tf32_bound_by']}) and "
          f"{tangent['fwd_bytes_bound_ms']:.4f} ms (bytes); the CUDA-core "
          f"kernel it replaced {T1_F32_SIMT_MS} ms (PERF.md)", flush=True)
    split = profile.get("split_ms", {})
    print(f"lm-100m profiled meta-step, device ms: forward "
          f"{split.get('forward')}, T1 {split.get('flash_t1')}, T2 "
          f"{split.get('flash_t2')}, flash "
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
# wgmma (HGMMA) in the bf16 kernels (hop), T3's bf16 passes (t3) and the
# SSD backward's and its tangent's bf16 kernels (hbw), mma.sync on TF32
# (HMMA) in the float32 flash forward, backward, T1 and T2 (tf32), the SSD
# scan's float32 passes (tfs) and the SSD backward's and its tangent's
# float32 kernels (tbw).
TENSOR_OPS = {"hop": "HGMMA", "t3": "HGMMA", "tf32": "HMMA", "hbw": "HGMMA",
              "tbw": "HMMA", "tfs": "HMMA"}


def kernel_symbol(text: str) -> str | None:
    """"namespace::kernel<template args>" of the first mangled kernel symbol
    of namespace hop, tf32, tfs, t3, jvpk, hbw, tbw or ssd in ``text``;
    None for none."""
    for k in re.finditer(r"(\d)(hop|tf32|tfs|t3|jvpk|hbw|tbw|ssd)\d+"
                         r"([a-z_]+?)"
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
    the float32 (3xTF32) forward, dQ, dK/dV, T1 and T2 kernels, the SSD
    chunk-state and
    chunk-output kernels, T3's tangent chunk-state and chunk-output
    kernels, the SSD backward's and its tangent's bf16 state, gram and
    chunk kernels and its float32 tangent's (the state passings, finish
    and reduce kernels are elementwise)."""
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


def build_phase(libraries, while_building=None):
    """Compile every CUDA source at once (one nvcc each) and load them.
    ``while_building()`` runs in this thread meanwhile (nvcc runs in
    processes of its own), and its result is returned."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(lib.build)
                   for name, lib in libraries.items()}
        extra = while_building() if while_building is not None else None
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
    return extra


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

    # the CPU halves of phases 15, 21, 26 and 29 (plain layers, no kernel)
    # while nvcc runs: they are most of those phases' host time, and the
    # host is idle but for one nvcc after the first 30 s of the build
    cpu_halves = build_phase(
        {"dif_combine": ops, "flash_attention": fops, "ssd_scan": sops,
         "ssd_bwd": sops.BWD_LIB},
        while_building=lambda: {
            "qwen2-1.5b": cpu_meta_grads("qwen2-1.5b", QWEN_AGREE_SEQ),
            "mamba2-130m": cpu_meta_grads("mamba2-130m",
                                          MAMBA_AGREE_SEQ),
            **agree_cpu_halves(MOE_AGREE, MOE_AGREE_SEQ),
            **agree_cpu_halves(ENCDEC_AGREE, ENCDEC_AGREE_SEQ),
            **agree_cpu_halves(NEW_AGREE, NEW_AGREE_SEQ)})
    hgmma = hgmma_phase({
        "flash_attention": (fops.build()["path"],
                            ("hop::fwd_kernel", "hop::dq_kernel",
                             "hop::dkv_kernel", "hop::tangent_fwd_kernel",
                             "hop::tangent_dq_kernel",
                             "hop::tangent_dkv_kernel", "tf32::fwd_kernel",
                             "tf32::dq_kernel", "tf32::dkv_kernel",
                             "tf32::tangent_fwd_kernel",
                             "tf32::tangent_dq_kernel",
                             "tf32::tangent_dkv_kernel")),
        "ssd_scan": (sops.build()["path"],
                     ("hop::chunk_state_kernel", "hop::chunk_scan_kernel",
                      "tfs::chunk_state_kernel", "tfs::chunk_scan_kernel",
                      "t3::tangent_state_kernel",
                      "t3::tangent_scan_kernel")),
        "ssd_bwd": (sops.BWD_LIB.build()["path"],
                    ("hbw::state_kernel", "hbw::gram_kernel",
                     "hbw::chunk_kernel", "hbw::tangent_state_kernel",
                     "hbw::tangent_gram_kernel",
                     "hbw::tangent_chunk_kernel",
                     "tbw::state_kernel", "tbw::gram_kernel",
                     "tbw::chunk_kernel",
                     "tbw::tangent_state_kernel",
                     "tbw::tangent_gram_kernel",
                     "tbw::tangent_chunk_kernel"))})
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
    # phase 23 beside phase 6: SDPA's backward is timed by torch.profiler,
    # whose sessions miss kernels once the training phases have profiled
    encdec_flash = encdec_flash_phase(fops, fref)
    stamp("encdec flash")
    # phase 27 there too, for the same reason
    new_flash = new_flash_phase(fops, fref)
    stamp("new config flash")
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
    mamba_half = cpu_halves.pop("mamba2-130m")
    train_agreement = {
        "qwen2-1.5b": train_agreement_phase(cpu_halves.pop("qwen2-1.5b"),
                                            AGREE_RTOL),
        "mamba2-130m": train_agreement_phase(mamba_half, MAMBA_AGREE_RTOL)}
    # where the float32 meta-gradient's device time goes: the SSD
    # backward's kernels and their tangent's
    mamba_f32_split = meta_grad_split(mamba_half["inputs"], torch.float32)
    del mamba_half
    print("mamba2 2-layer cut, one float32 maml meta-gradient on the card "
          f"(device ms of {mamba_f32_split.get('device_ms')}, launches, "
          "share): " + "; ".join(
              f"{role} {mamba_f32_split.get(role + '_ms')}, "
              f"{mamba_f32_split.get(role + '_launches')}, "
              f"{mamba_f32_split.get(role + '_share')}"
              for role in ("ssd_fwd", "ssd_t3", "ssd_bwd",
                           "ssd_bwd_tangent"))
          + f"; {json.dumps(mamba_f32_split.get('ssd_kernels'))}",
          flush=True)
    train_agreement["mamba2-130m"]["float32_meta_grad_split"] = \
        mamba_f32_split
    stamp("training agreement")
    # phases 19-22, before phase 5 for the same reason as phase 6
    moe = moe_phases(ops, ref, (ops, fops, sops), cpu_halves)
    stamp("moe")
    # phases 24-26, before phase 5 for the same reason as phase 6
    encdec = encdec_phases(ops, ref, (ops, fops, sops), cpu_halves)
    stamp("encdec")
    # phases 28-30, before phase 5 for the same reason as phase 6
    new_configs = new_configs_phases((ops, fops, sops), cpu_halves)
    stamp("new configs")
    profile = profile_phase("fused", steps=20)
    stamp("profile")
    counters = {"flash_attention_fwd": fops, "flash_attention_bwd": fops,
                "ssd_scan": sops, **{k: sops for k in SSD_PASSES}}
    # per layer and step: one flash forward launch, and the backward's two
    # (dK/dV and dQ); one bf16 SSD scan call, a launch of each of its three
    # kernels, and one call of its backward, a launch of each of its six
    serve_row = serve_phase(SERVE_ARGS, counters, lambda n, k: {
        "flash_attention_fwd": n * k, "flash_attention_bwd": 2 * n * k})
    stamp("serve")
    agreement = agreement_phase(task_batch=1)
    # the float32 backward (3xTF32) at the shape this phase's f32 adaptation
    # gave it until the encoder-decoder phases came in (2 sequences of 256;
    # one since): qwen2's 12 / 2 heads of 128
    agreement["flash_f32"] = check_gqa_flash(
        fops, fref, torch.Generator(device=DEVICE).manual_seed(12), 2, 256,
        12, 2, 128, torch.float32, True, None, n=5)
    stamp("agreement")
    ssd_main, ssd_rows, continuity, ssd_passes, ssd_pass_rows, ssd_f32, \
        ssd_bwd = ssd_phase(sops, sref, layers)
    stamp("ssd")
    mamba_row = serve_phase(MAMBA_SERVE_ARGS, counters,
                            lambda n, k: {"ssd_scan": n * k,
                                          **{p: n * k for p in SSD_PASSES},
                                          "ssd_scan_bwd": n * k,
                                          **{p: n * k for p in
                                             SSD_BWD_KERNELS}},
                            replay=("profile",))
    stamp("mamba2 serve")
    mamba_agreement = agreement_phase(
        dataclasses.replace(get_config("mamba2-130m"), num_layers=2),
        MAMBA_AGREE_RTOL, seq=1024, task_batch=1)

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
         "qwen2_layer": kern["qwen2"]["dif_combine"],
         "deepseek_leaves": moe["outer"]["dif_combine"],
         "deepseek_pallas_run_launches":
             moe["train_pallas"]["launches"]["dif_combine"],
         "whisper_pallas_run_launches":
             encdec["train_pallas"]["launches"]["dif_combine"]},
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
         "deepseek_leaves": moe["outer"]["fused_combine_update"],
         "deepseek_run_launches":
             moe["train"]["launches"]["fused_combine_update"],
         "capture": kern["capture"]},
        *(flash_summary(name, flash_main, serve_row, flash_rows, flash_gqa,
                        flash_gqa_rows, flash_calls)
          for name in ("flash_attention_fwd", "flash_attention_bwd")),
        *ssd_summary(ssd_main, ssd_rows, continuity, ssd_passes,
                     ssd_pass_rows, ssd_f32, ssd_calls, mamba_row,
                     mamba_f32_split),
        *tangent_summary(tangent, train_rows),
        *ssd_bwd_summary(ssd_bwd, tangent["bwd_tangent"], train_rows,
                         mamba_row, mamba_f32_split),
    ], "ms_per_step": ms_per_step, "train": train_rows,
        "fewshot": fewshot["rows"], "lm100m": lm100m,
        "serve_adapted": adapted_serve,
        "train_agreement": train_agreement, "profile": profile, "serve": serve_row,
        "agreement": agreement, "mamba2_serve": mamba_row,
        "mamba2_agreement": mamba_agreement, "moe": moe, "hgmma": hgmma,
        "flash_kernels_per_call": flash_calls,
        "ssd_bwd_kernels_per_call": bwd_calls,
        "phase_end_seconds": stamps,
        "seconds": time.perf_counter() - t_start}
    for entry in summary["kernels"]:
        if entry["name"] in ("flash_attention_fwd", "flash_attention_bwd"):
            entry.update(encdec_summary(entry["name"], encdec_flash, encdec))
            entry.update(new_flash_summary(entry["name"], new_flash))
        if entry["name"] in ("flash_attention_fwd_tangent",
                             "flash_attention_bwd_tangent"):
            entry.update(tangent_encdec_summary(entry["name"], encdec))
    summary.update(encdec_flash=encdec_flash, encdec=encdec,
                   new_flash=new_flash, new_configs=new_configs)
    paths_summary(summary["kernels"], fewshot, lm100m)
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
