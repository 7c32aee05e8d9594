#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:

1. device   -- a CUDA card must be present; prints its name and power limit.
2. build    -- compiles the CUDA kernels of ``kernels/dif_combine/csrc`` with
               nvcc for sm_90a and prints the build seconds.
3. kernels  -- holds ``dif_combine`` and ``fused_combine_update`` against
               their plain PyTorch versions on the card: at the shapes the
               training step gives them (the sine MLP's leaves, K=6, padded
               as the step pads them) and at K=6, M=2^24 in float32 and
               bfloat16, the fused kernel across optimizer kind x mix mode x
               gate x schedule length.  Each check prints its largest error
               against the stated tolerance, the kernel's time, the plain
               version's, the least time the card could take (bound) and,
               for the combine, one PyTorch matmul's time as a yardstick.
4. main path -- runs ``python -m repro_torch.launch.quickstart`` (K=6 agents
               on the paper's Fig. 2a graph, ATC, exact MAML, Adam) for 300
               steps with ``--backend dense``, ``pallas`` and ``fused`` from
               one init and one episode stream, and 5 steps on the CPU as a
               reference.  Losses must be finite and fall, disagreement stay
               small, the backends agree step by step, and each kernel's
               launch counter, zeroed just before its run, show its launches.
5. profile  -- device time per step of the fused training step
               (torch.profiler), to show where a step's time goes.

The last two lines of standard output are the kernels' numbers and the
device, as JSON.  Without a CUDA card the script exits 1 before any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
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
REPLACES = {"dif_combine": "src/repro/kernels/dif_combine/dif_combine.py:94",
            "fused_combine_update":
                "src/repro/kernels/dif_combine/dif_combine.py:174"}


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def compare(got, want, dtype, what: str) -> float:
    """Largest |got - want|; raises unless within TOL[dtype]."""
    err = (got.float() - want.float()).abs()
    limit = TOL[dtype]["atol"] + TOL[dtype]["rtol"] * want.float().abs()
    bad = int((err > limit).sum())
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: {bad} elements outside "
                             f"{TOL[dtype]} (max abs err "
                             f"{float(err.max()):.3e})")
    return float(err.max())


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import SINE_MLP
    from repro_torch.core import diffusion, topology
    from repro_torch.kernels.dif_combine import ops, ref
    from repro_torch.launch import quickstart
    from repro_torch.models import SineMLP

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    info = ops.build()
    print(f"build: {info['seconds']:.2f} s (compiled={info['compiled']}) "
          f"-> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    paper_A = topology.build_topology("paper", K, "metropolis").matrix
    main_combine, fused_step, n_leaves, large = kernels_phase(
        ops, ref, diffusion, SineMLP, SINE_MLP, paper_A)
    launches, ms_per_step = main_path_phase(quickstart, ops,
                                            len(main_combine), n_leaves)
    profile = profile_phase("fused")

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
    ], "ms_per_step": ms_per_step, "profile": profile,
        "seconds": time.perf_counter() - t_start}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
