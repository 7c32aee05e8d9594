"""The SSD scan's float32 forward, this tree's kernels against another
commit's, on one CUDA card.

  python scripts/ablate_ssd_scan_f32.py OTHER_SOURCE

Builds this tree's ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``
(through ``ops._LIB``: the float32 route's three passes) and
``OTHER_SOURCE``, another commit's ``ssd_scan.cu`` whose C entry
``repro_ssd_scan`` runs the float32 scan in one launch (``git show
<commit>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu >
build/parent_ssd_scan.cu``), at once into ``build/kernels/``.  Then, on
the same float32 inputs (``chip_smoke.ssd_inputs``), at the serving shape
(``chip_smoke.SSD_MAIN``), the mamba2 training shape
(``chip_smoke.SSD_TRAIN``, A per sequence) and one 512-token sequence of
the same width (what the float32 meta-gradient of mamba2's 2-layer cut
gives the scan): each source's call held against the per-step recurrence
(``chip_smoke.SSD_TOL``), timed in turns (this tree, the other, the
other, this tree; ``chip_smoke.time_ms``), each launch's device time from
torch.profiler, and the bounds (``chip_smoke.ssd_cost``: the float32
rate's, three TF32 products', the bytes').  Prints the card, one line per
shape and source, then one JSON line.  Run by hand; ``chip_smoke.py``
does not run it.
"""
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

from repro_torch.kernels.build import CudaLibrary  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402

THIS, OTHER = "this tree", "other"
SHAPES = {"serve": (cs.SSD_MAIN, False), "train": (cs.SSD_TRAIN, True),
          "one sequence": (dict(cs.SSD_TRAIN, B=1), False)}


def _declare_other(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_scan.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.repro_ssd_scan.restype = i


def other_call(lib, x, dt, A, Bm, Cm, chunk):
    """One float32 scan through the other source's one-launch entry (A
    expanded to (B, H), as its wrapper did)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    A = A.expand(B, H).contiguous()
    y = torch.empty_like(x)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    err = lib.lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, L, H, P, G, N,
        chunk, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{lib.source}: launch failed with {err}")
    return y, state


def per_launch(fn, n: int = 3) -> dict:
    """{kernel: device ms and launches a call}, from torch.profiler over
    ``n`` calls."""
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
        out[e.key.split("(")[0].replace("void ", "")[:70]] = dict(
            ms=us / 1e3 / n, launches=e.count / n)
    return out


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("ablate_ssd_scan_f32: needs a CUDA card and OTHER_SOURCE",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    other = CudaLibrary(Path(sys.argv[1]), "ssd_scan_other", _declare_other)
    cs.build_phase({"ssd_scan": ops, "ssd_scan_other": other})
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    for shape, (s, per_seq) in SHAPES.items():
        B, L, H, P, N, G, chunk = (s[k] for k in ("B", "L", "H", "P", "N",
                                                  "G", "chunk"))
        x, dt, A, Bm, Cm = cs.ssd_inputs(gen, B, L, H, P, N, G,
                                         torch.float32)
        if per_seq:
            A = A * (0.5 + torch.rand(B, 1, generator=gen, device="cuda"))
        rep = H // G
        yr, sr = sref.ssd_scan_ref(x, dt, A, Bm.repeat_interleave(rep, 2),
                                   Cm.repeat_interleave(rep, 2))
        calls = {THIS: lambda: ops.ssd_scan_kernel(x, dt, A, Bm, Cm,
                                                   chunk=chunk),
                 OTHER: lambda: other_call(other, x, dt, A, Bm, Cm, chunk)}
        row = {}
        for name, fn in calls.items():
            y, st = fn()
            torch.cuda.synchronize()
            what = f"{shape} {name}"
            row[name] = dict(
                y_max_abs_err=cs.compare(y, yr, torch.float32, what + " y",
                                         cs.SSD_TOL[torch.float32]),
                state_max_abs_err=cs.compare(st, sr, torch.float32,
                                             what + " state",
                                             cs.SSD_TOL[torch.float32]),
                ms=[])
        for name in (THIS, OTHER, OTHER, THIS):
            row[name]["ms"].append(cs.time_ms(calls[name], 10, reps=5))
        for name, fn in calls.items():
            row[name]["ms_median"] = statistics.median(row[name]["ms"])
            row[name]["kernels"] = per_launch(fn)
            print(shape, name, json.dumps(row[name]), flush=True)
        nbytes, flops = cs.ssd_cost(B, L, H, P, N, G, chunk, 4)
        row["bounds_ms"] = dict(
            float32_rate=cs.bound_ms(nbytes, flops, cs.FP32_FLOP_PER_S),
            three_tf32=cs.bound_ms(nbytes, 3 * flops, cs.TF32_FLOP_PER_S),
            bytes=1e3 * nbytes / cs.HBM_BYTES_PER_S)
        row["shape"] = dict(s, per_sequence_A=per_seq)
        print(shape, "bounds", json.dumps(row["bounds_ms"]), flush=True)
        res[shape] = row
        del x, dt, A, Bm, Cm, yr, sr
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
