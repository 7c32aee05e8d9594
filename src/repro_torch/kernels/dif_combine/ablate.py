"""What bounds the outer-update kernels at large M, on the card: builds
copies of ``csrc/dif_combine.cu`` with one part removed or one choice
changed (the ring's depth, the global stores, the mix, the tile width) and
times ``dif_combine`` and the adam/atc ``fused_combine_update`` with each
copy, the unchanged source among them, in one process, at K=6, M=2^24 in
float32 and bfloat16.  Beside them, as the yardstick of what a stream that
reads and writes reaches on the card, a device copy (``Tensor.copy_``) of
phi, and of w, mu and nu (the fused update's bytes less g's read).

  PYTHONPATH=src python -m repro_torch.kernels.dif_combine.ablate

A copy that removes a part gives wrong outputs; only times are read.  The
copies are made by exact replacements of the source's text, and one that
no longer matches the source raises.  Each builds into ``build/kernels/``
like the kernels themselves, all at once.  Prints the card, then one JSON
line of ms per kernel, dtype and copy (the median of 7 replays of 3 calls
captured in a CUDA graph) beside each kernel's byte bound.
"""
from __future__ import annotations

import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary
from repro_torch.kernels.dif_combine import ops

K, M = 6, 1 << 24
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory

_STORE = "      store_vec<O, V>(dst + (long long)k * m, acc[r]);\n"
# never true for these inputs: the stores stay in the program but none runs
_NO_STORE = ("      if (acc[r][0] == 1234.5f)\n"
             "        store_vec<O, V>(dst + (long long)k * m, acc[r]);\n")
_MOMENT_STORES = """    store_vec<float, V>(reinterpret_cast<float*>(mu_out), m);
    store_vec<float, V>(nu_out, n);
"""

# copy -> [(text of the source, its replacement)]
VARIANTS = {
    "as built (2 ring stages)": [],
    **{f"{n} ring stage{'s' if n > 1 else ''}": [(
        "constexpr int kStages = 2;", f"constexpr int kStages = {n};")]
       for n in (1, 3, 4)},
    "no global stores": [
        (_STORE, _NO_STORE),
        (_MOMENT_STORES, "    if (m[0] == 1234.5f) {\n" + _MOMENT_STORES
         + "    }\n")],
    "no mix (last row copied)": [(
        "          acc[r][v] = __fadd_rn(acc[r][v], "
        "__fmul_rn(a[r], x[v]));", "          acc[r][v] = x[v];")],
    # 256-column tiles: 1 KB row segments in f32 (4 KB as built)
    "256-column tiles": [
        ("                             kThreads * 16 / (int)sizeof(P));",
         "                             256);"),
        ("ring_for(fixed, column, mix_tiles<MODE>() * K * 4, 1024);",
         "ring_for(fixed, column, mix_tiles<MODE>() * K * 4, 256);")],
}


def time_ms(fn, n: int = 3, reps: int = 7) -> float:
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


def variant_libraries() -> dict:
    """copy -> a built CudaLibrary of that copy of the source."""
    source = ops.SOURCE.read_text()
    out = BUILD_DIR / "ablate_dif_combine"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for copy, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{copy}: the source no longer holds "
                                 f"{old[:60]!r} once")
            text = text.replace(old, new)
        path = out / f"dif_combine_{len(libs)}.cu"
        path.write_text(text)
        libs[copy] = CudaLibrary(Path(path), path.stem, ops._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    return libs


def run() -> dict:
    """ms of each copy for each (kernel, dtype), and the byte bounds."""
    libs = variant_libraries()
    gen = torch.Generator(device="cuda").manual_seed(5)
    A = torch.rand(K, K, generator=gen, device="cuda")
    table = A[None].contiguous()
    sel = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    ctl = torch.tensor([[1.0, 0.271, 0.0199]], device="cuda")
    scale = torch.ones(K, 1, device="cuda")
    row, bounds = {}, {}
    built = ops._LIB
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        size = torch.finfo(dtype).bits // 8
        phi = torch.randn(K, M, generator=gen, device="cuda").to(dtype)
        w, g = (torch.randn(K, M, generator=gen, device="cuda").to(dtype)
                for _ in "wg")
        mu = 0.1 * torch.randn(K, M, generator=gen, device="cuda")
        nu = 0.01 * torch.rand(K, M, generator=gen, device="cuda")
        runs = {
            "dif_combine": (lambda: ops.dif_combine(A, phi),
                            2 * K * M * size),
            "fused_combine_update adam/atc": (
                lambda: ops.fused_combine_update(table, sel, ctl, scale, w,
                                                 g, mu, nu, lr=1e-3),
                K * M * (3 * size + 16))}
        out = [torch.empty_like(x) for x in (phi, w, mu, nu)]
        row.setdefault(f"device copy {dt}", {}).update({
            "phi": time_ms(lambda: out[0].copy_(phi)),
            "w, mu, nu": time_ms(lambda: [o.copy_(x) for o, x in zip(
                out[1:], (w, mu, nu))])})
        del out
        try:
            for copy, lib in libs.items():
                ops._LIB = lib
                for name, (fn, _) in runs.items():
                    row.setdefault(f"{name} {dt}", {})[copy] = time_ms(fn)
        finally:
            ops._LIB = built
        for name, (_, nbytes) in runs.items():
            bounds[f"{name} {dt}"] = 1e3 * nbytes / HBM_BYTES_PER_S
        del phi, w, g, mu, nu
        torch.cuda.empty_cache()
    return {"ms": row, "bound_ms": bounds, "K": K, "M": M}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
