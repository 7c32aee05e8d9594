"""The SSD scan's backward and its tangent, this tree's kernels against
another commit's, on one CUDA card, each launch's device time apart.

  python scripts/ablate_ssd_bwd.py [OTHER_SOURCE ...]

Builds this tree's ``src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu``
(through ``ops.BWD_LIB``) and each ``OTHER_SOURCE`` given: another
commit's ``ssd_bwd.cu`` whose C entry runs the float32 backward and its
tangent as its passes (state, pass, then gram where that commit's route
has one, chunk, finish, reduce; ``git show
<commit>:src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu >
build/parent_ssd_bwd.cu``, with any header it includes beside it), all at
once into ``build/kernels/``.  Then, on
the same inputs, for the mamba2 training shape (``chip_smoke.SSD_TRAIN``,
A per sequence) and the serving shape (``chip_smoke.SSD_MAIN``), in
bfloat16 and float32: ``ssd_scan_bwd`` and ``ssd_scan_bwd_tangent``, this
tree's and, in float32, each other source's in turn (this tree, the
others, then again in the reverse order), each call's time
(``chip_smoke.time_ms``),
each launch's device time from torch.profiler (by kernel name, per call),
and each launch's bound (``chip_smoke.ssd_bwd_cost``).  Every copy's
results are held against the plain passes composed (SSD_BWD_TOL).  Then
copies of this tree's source with one part of the bfloat16 chunk kernel
removed (VARIANTS; a copy whose text no longer matches raises), whose
chunk launch alone is timed at both shapes, backward and tangent, beside
the unchanged source's: what each part costs (a copy gives wrong results;
only its time is read).  Prints the card, one line per source, shape and
call, then one JSON line.  Run by hand; ``chip_smoke.py`` does not run it.
"""
import ctypes
import json
import re
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

from repro_torch.kernels.build import (  # noqa: E402
    BUILD_DIR, CudaLibrary, local_headers)
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402

THIS = "this tree"
SHAPES = {"train": (cs.SSD_TRAIN, True), "serve": (cs.SSD_MAIN, False)}
# copy -> [(pattern in the chunk kernel's source, its replacement)]
VARIANTS = {
    "as built": [],
    # M, Z and the R sums of each pair (the planes keep stale values)
    "no per-element work": [
        (r"for \(int i = 0; i < kE / 4; \+\+i\) \{",
         "for (int i = 0; i < 0; ++i) {")],
    # dC's partial sums neither read from nor written to dCh
    "no dC read-modify-write": [
        (r"\n            v = \*reinterpret_cast<const float2\*>"
         r"\(dCh \+ dc_at\(q, n\)\);", "\n            v = v;"),
        (r"          if \(q < cs && n < N\)\n            \*reinterpret_cast"
         r"<float2\*>\(dCh \+ dc_at\(q, n\)\) =\n",
         "          if (q < 0)\n"
         "            *reinterpret_cast<float2*>(dCh) =\n")],
    "no dC products": [(r"\n          tmn\(dC, sPL[^\n]*", "")],
    "no dx, dB products": [(r"\n          amn\(d[xB], sPL[^\n]*", "")],
    "no entering-state term": [
        (r"for \(int qt = nt - 1; qt >= 0; --qt\) \{",
         "for (int qt = -1; qt >= 0; --qt) {")],
    "no D products": [
        (r"\n      abt\(D, base[^\n]*|\n        abt\(Dt, base[^\n]*", "")],
}


def _declare_other(lib: ctypes.CDLL) -> None:
    lib.repro_ssd_bwd_slots.argtypes = []
    lib.repro_ssd_bwd_slots.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_bwd_launch.argtypes = [i, i, i, p, p, p]
    lib.repro_ssd_bwd_launch.restype = i


def build(others) -> tuple[dict, dict]:
    """(the sources to compare: this tree's and ``others``; the copies of
    this tree's with one part removed), all built at once."""
    libs = {THIS: ops.BWD_LIB}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the copies below include this tree's headers (an other source's own
    # headers are found beside it, in its directory)
    for header in local_headers(ops.BWD_SOURCE):
        shutil.copy(header, BUILD_DIR / header.name)
    for i, path in enumerate(others):
        copy = Path(path).resolve().parent / f"ssd_bwd_other_{i}.cu"
        copy.write_text(Path(path).read_text())
        libs[str(path)] = CudaLibrary(copy, f"ssd_bwd_other_{i}",
                                      _declare_other)
    src = ops.BWD_SOURCE.read_text()
    copies = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for pattern, new in subs:
            text, n = re.subn(pattern, new, text)
            if not n:
                raise RuntimeError(f"copy {name!r}: the source no longer "
                                   f"matches {pattern!r}")
        copy = BUILD_DIR / f"ssd_bwd_part_{i}.cu"
        copy.write_text(text)
        copies[name] = CudaLibrary(copy, f"ssd_bwd_part_{i}",
                                   ops._declare_bwd)
    every = {**libs, **{f"copy {k}": v for k, v in copies.items()}}
    with ThreadPoolExecutor(len(every)) as pool:
        for name, info in zip(every, pool.map(lambda l: l.build(),
                                              every.values())):
            print(f"build {name}: {info['seconds']:.1f} s", flush=True)
    return libs, copies


def part_times(copies, args, targs, chunk) -> dict:
    """{copy: {"bwd", "tangent": ms}}: the chunk launch alone of each
    copy, on the planes the launches before it filled."""
    gs = args[6]
    S, Lc, seg = ops.ssd_bwd_state(*args[:6], chunk=chunk)
    s_in, gO, sg = ops.ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk)
    st = ops.ssd_bwd_tangent_state(*args[:6], *targs[:6], chunk=chunk)
    ps = ops.ssd_bwd_tangent_pass(*st, gs, targs[6], chunk=chunk)
    built, out = ops.BWD_LIB, {}
    try:
        for name, lib in copies.items():
            ops.BWD_LIB = lib
            out[name] = {}
            for tangent in (False, True):
                calls, _ = ops._chunk_launches(
                    *args[:6], seg, s_in, gO, sg, chunk,
                    (*targs[:6], st[5], ps[1], ps[3], ps[5]) if tangent
                    else None)
                calls["ssd_bwd_gram"]()
                out[name]["tangent" if tangent else "bwd"] = cs.time_ms(
                    calls["ssd_bwd_chunk"], 5)
    finally:
        ops.BWD_LIB = built
    return out


def other_passes(lib, args, targs, chunk, tangent):
    """One call of another commit's float32 backward (``tangent``: its
    tangent) through its C entry: state, pass, gram (where its entry takes
    pass 5 for this call: it refuses it before any launch otherwise),
    chunk, finish, reduce, each tensor's value and tangent planes in the
    slots of ``ops._BWD_TENSORS`` (the first ``repro_ssd_bwd_slots() / 2``
    of them), as that commit's wrappers allocated them."""
    x, dt, A, Bg, Cg, gy, gs = args
    B, L, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    nc = L // chunk
    names = ops._BWD_TENSORS[:lib.lib.repro_ssd_bwd_slots() // 2]
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=x.device)
    shapes = {"seg": (B, H, L), "S": (B, nc, H, P, N), "Lc": (B, nc, H, P, N),
              "s_in": (B, nc, H, P, N), "gO": (B, nc, H, P, N),
              "sg": (B, H, nc), "dBh": (B, L, H, N), "dCh": (B, L, H, N),
              "ddd": (B, H, L), "dsk": (B, H, L), "dsq": (B, H, L),
              "tk": (B, H, L), "dAp": (B, nc, H), "ddt": (B, L, H),
              "dA": tuple(A.shape),
              "gram": (B * nc, G, *ops._gram_tiles(x.dtype, chunk))}
    given = dict(zip(("x", "dt", "A", "B", "C", "gy", "gs"), args))
    tgiven = dict(zip(("x", "dt", "A", "B", "C", "gy", "gs"),
                      targs if tangent else [None] * 7))
    out = {"dx": torch.empty_like(x), "dB": torch.empty_like(Bg),
           "dC": torch.empty_like(Cg)}
    planes = []
    for name in names:
        if name in given:
            pair = (given[name], tgiven[name])
        elif name in out:
            t = torch.empty_like(out[name])
            pair = (None, t) if tangent else (t, None)
            out[name] = t
        elif name in ("ddt", "dA"):
            t = f32(*shapes[name])
            pair = (None, t) if tangent else (t, None)
            out[name] = t
        else:
            pair = (f32(*shapes[name]),
                    f32(*shapes[name]) if tangent else None)
        planes.extend(pair)
    ptrs = (ctypes.c_void_p * len(planes))(
        *[t.data_ptr() if t is not None else None for t in planes])
    dims = (ctypes.c_longlong * 10)(
        B, L, H, P, G, N, chunk, A.stride(0) if A.ndim == 2 else 0,
        targs[2].stride(0) if tangent and targs[2].ndim == 2 else 0,
        int(A.ndim == 2))
    dtype = ops._DTYPES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    for p in (0, 1, 5, 2, 3, 4):
        err = lib.lib.repro_ssd_bwd_launch(p, int(tangent), dtype, ptrs, dims,
                                           stream)
        if err and p == 5:
            continue                     # no gram kernel in that route
        if err:
            raise RuntimeError(f"pass {p} of {lib.source} failed: {err}")
    return tuple(out[k] for k in ("dx", "ddt", "dA", "dB", "dC"))


def per_launch(fn, n: int = 3) -> dict:
    """{kernel: device ms of its launches in one ``fn()``}, from
    torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = e.key.split("(")[0].replace("void ", "")
        out[name] = dict(ms=us / 1e3 / n, launches=e.count / n)
    return out


def run(name, lib, args, targs, chunk, tangent):
    if name == THIS:
        if tangent:
            return lambda: ops.ssd_scan_bwd_tangent(*args, *targs,
                                                    chunk=chunk)
        return lambda: ops.ssd_scan_bwd(*args, chunk=chunk)
    return lambda: other_passes(lib, args, targs, chunk, tangent)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_ssd_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    libs, copies = build(sys.argv[1:])
    order = list(libs) + list(reversed(libs))
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, (s, per_seq) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            args, targs = cs.ssd_bwd_inputs(
                gen, s["B"], s["L"], s["H"], s["P"], s["N"], s["G"], dtype,
                per_seq, tangents=True)
            chunk = s["chunk"]
            for tangent in (False, True):
                call = "ssd_scan_bwd_tangent" if tangent else "ssd_scan_bwd"
                key = f"{shape} {str(dtype)[6:]} {call}"
                want = (cs.bwd_tangent_plain(sref, args, targs, chunk)
                        if tangent else cs.bwd_plain(sref, args, chunk))
                costs = cs.ssd_bwd_cost(s["B"], s["L"], s["H"], s["P"],
                                        s["N"], s["G"], chunk,
                                        args[0].element_size(), tangent)
                rate = cs.BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
                    cs.FP32_FLOP_PER_S
                # another commit's passes: its float32 route
                names = [n for n in libs
                         if n == THIS or dtype == torch.float32]
                rows = {n: {"ms": [], "launches": []} for n in names}
                for name in [n for n in order if n in names]:
                    fn = run(name, libs[name], args, targs, chunk, tangent)
                    cs.check_bwd_grads(fn(), want, f"{key} {name}")
                    n = 2 if tangent and dtype == torch.float32 else 5
                    rows[name]["ms"].append(cs.time_ms(fn, n, reps=5))
                    rows[name]["launches"].append(per_launch(fn))
                res[key] = {}
                for name, r in rows.items():
                    kernels = {}
                    for k in r["launches"][0]:
                        kernels[k] = dict(
                            ms=statistics.mean(d[k]["ms"]
                                               for d in r["launches"]),
                            launches=r["launches"][0][k]["launches"])
                    res[key][name] = dict(ms=r["ms"],
                                          ms_median=statistics.median(
                                              r["ms"]),
                                          kernels=kernels)
                    print(key, name, json.dumps(res[key][name]), flush=True)
                res[key]["bounds_ms"] = {
                    k: cs.bound_ms(b, f, cs.FP32_FLOP_PER_S if k == "pass"
                                   else rate)
                    for k, (b, f) in costs.items()}
                print(key, "bounds", json.dumps(res[key]["bounds_ms"]),
                      flush=True)
            if dtype == torch.bfloat16:
                key = f"{shape} chunk kernel, parts removed"
                res[key] = part_times(copies, args, targs, s["chunk"])
                for name, row in res[key].items():
                    print(key, name, json.dumps(row), flush=True)
            del args, targs, want
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
