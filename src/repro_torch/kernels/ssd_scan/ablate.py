"""Where the bf16 SSD kernels' time goes, on the card: builds copies of
``csrc/ssd_scan.cu`` with one part of a kernel removed (or one choice
changed, such as the heads a block takes) and times the pass that kernel
runs at the serving shape with each copy, the unchanged source among them,
in one process.

  PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.ablate

A copy that removes a part gives wrong outputs, except where the part only
adds precision: each copy of the chunk-output kernel also reports how many
elements of its y fall outside the bf16 check of ``chip_smoke.py`` (its
SSD_TOL[bfloat16] plus 2^-8 of the row's largest |value|) against the
plain version, so a copy that drops the lo half of M or of the entering
state shows whether that check would reject it.  The copies are made by
exact replacements of the source's text, and one that no longer matches
the source raises.  Each builds into ``build/kernels/`` like the kernels
themselves, all at once.  Prints the card, then one JSON line of ms per
pass and copy (the median of 7 replays of 20 calls captured in a CUDA
graph) and the chunk-output copies' elements outside the check.
"""
from __future__ import annotations

import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import chunk_scan_ref

# The serving path's scan: 4 users x 4 sequences of 1024 tokens, 24 heads of
# head dim 64, state 128, one B/C group, chunk 256.
SHAPE = dict(B=16, L=1024, H=24, P=64, N=128, G=1, chunk=256)

# chip_smoke.py's bf16 check of y: rtol, and atol as a share of the row's
# largest |value|
Y_RTOL, Y_ROW_ATOL = 1.6e-2, 2.0 ** -8

_ZEROED = """    }
    // (the first chunk has no entering state: its first product below"""

# pass -> copy -> [(text of the source, its replacement)]
VARIANTS = {
    "ssd_chunk_scan": {
        "as built": [],
        "no M x products": [(
            """        wgmma_ss_mn(y, desc(sM + kk * 32), db, entering || kt + kk > 0);
        wgmma_ss_mn(y, desc(sM + kRegion + kk * 32), db, 1);""", "")],
        "no entering-state products": [(
            """      mma_abt<NH>(y, sC, sIn, false);
      mma_abt<NH>(y, sC, sIn + BT, true);""", "")],
        "entering state without its lo half": [(
            "      mma_abt<NH>(y, sC, sIn + BT, true);\n", "")],
        "M without its lo half": [(
            "        wgmma_ss_mn(y, desc(sM + kRegion + kk * 32), db, 1);\n",
            "")],
        "no decay exponentials": [(
            """      float m0 = cb[e] * exp2_approx(sq[r] - s2.x);
      float m1 = cb[e + 1] * exp2_approx(sq[r] - s2.y);""",
            """      float m0 = cb[e] * s2.x;
      float m1 = cb[e + 1] * s2.y;""")],
        "no staging of M": [(
            """      stage_tile(sM, hi, t);
      stage_tile(sM + kRegion, lo, t);""", """      keep(hi);
      keep(lo);""")],
        "y zeroed by other instructions (ptxas serializes wgmma)": [
            (_ZEROED, """    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) y[e] = 0.f;
    }
    // (the first chunk has no entering state: its first product below"""),
            ("db, entering || kt + kk > 0);", "db, 1);")],
    },
    "ssd_chunk_state": {
        "as built": [],
        "no store of S": [("""          if (n < a.N)
            *reinterpret_cast<float2*>(out + p * a.N + n) = make_float2(""",
                           """          if (n < 0)
            *reinterpret_cast<float2*>(out + p * a.N + n) = make_float2(""")],
        "no products": [(
            "      mma_rs<NH>(acc, hi[kt & 1], lo[kt & 1], sB + kt * BT, "
            "kt > 0);\n", "")],
    },
}


def _heads(const: str, built: int, sizes) -> dict:
    """Copies whose blocks take each of ``sizes`` heads of a group: the
    kernel's constant ``const`` (``built`` as built) set to each."""
    return {f"{k} heads a block": [(f"constexpr int {const} = {built};",
                                    f"constexpr int {const} = {k};")]
            for k in sizes}


VARIANTS["ssd_chunk_state"].update(_heads("kStateHeads", 6, (1, 2, 3, 4)))
VARIANTS["ssd_chunk_scan"].update(_heads("kScanHeads", 4,
                                         (2, 3, 6, 8, 12, 24)))


def time_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Median device ms of one ``fn()``: ``n`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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
    return statistics.median(times)


def y_outside(y: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``y`` outside chip_smoke.py's bf16 check of ``want``."""
    want = want.float()
    err = (y.float() - want).abs()
    limit = Y_RTOL * want.abs() + Y_ROW_ATOL * want.abs().amax(
        -1, keepdim=True)
    return int((~(err <= limit)).sum())


def variant_libraries() -> dict:
    """(pass, copy) -> a built CudaLibrary of that copy of the source."""
    source = ops.SOURCE.read_text()
    out = BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, copies in VARIANTS.items():
        for copy, edits in copies.items():
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise ValueError(f"{name} / {copy}: the source no longer "
                                     f"holds {old[:60]!r} once")
                text = text.replace(old, new)
            path = out / f"{name}_{len(libs)}.cu"
            path.write_text(text)
            libs[name, copy] = CudaLibrary(Path(path), path.stem,
                                           ops._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    libs = variant_libraries()
    m, c = SHAPE, SHAPE["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(m["B"], m["L"], m["H"], m["P"], generator=gen,
                    device="cuda").bfloat16()
    dt = (0.5 * torch.nn.functional.softplus(torch.randn(
        m["B"], m["L"], m["H"], generator=gen, device="cuda"))
          ).bfloat16().float()
    A = -torch.exp(0.3 * torch.randn(m["H"], generator=gen, device="cuda"))
    Bm, Cm = (0.3 * torch.randn(m["B"], m["L"], m["G"], m["N"],
                                generator=gen, device="cuda").bfloat16()
              for _ in "BC")
    S, seg = ops.ssd_chunk_state(x, dt, A, Bm, chunk=c)
    hi, lo, _ = ops.ssd_state_pass(S, seg, chunk=c)
    yr = chunk_scan_ref(x, dt, seg, Bm, Cm, hi.float() + lo.float(), c)
    run = {"ssd_chunk_state": lambda: ops.ssd_chunk_state(x, dt, A, Bm,
                                                          chunk=c),
           "ssd_chunk_scan": lambda: ops.ssd_chunk_scan(
               x, dt, seg, Bm, Cm, hi, lo, chunk=c)}
    built, row, outside = ops._LIB, {}, {}
    try:
        for (name, copy), lib in libs.items():
            ops._LIB = lib
            row.setdefault(name, {})[copy] = time_ms(run[name])
            if name == "ssd_chunk_scan":
                outside[copy] = y_outside(run[name](), yr)
    finally:
        ops._LIB = built
    row["ssd_chunk_scan y elements outside the bf16 check"] = outside
    row["ssd_state_pass"] = {"as built": time_ms(
        lambda: ops.ssd_state_pass(S, seg, chunk=c))}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
