"""Where the flash-attention tangents' time goes, whether the bf16 ones'
lo halves are needed, and what the float32 T1 and T2 take, on one CUDA
card.

  python scripts/ablate_flash_tangents.py [OTHER_SOURCE ...]

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` with one part removed, the unchanged source among
them, and each ``OTHER_SOURCE`` given (another commit's
``flash_attention.cu``, whose C entries take the same arguments), all at
once into ``build/kernels/``.  With each copy, in one process:

- chip_smoke.shared_mean_tangents: T1 and T2 on values sharing a mean,
  the elements of each output outside TANGENT_TOL of the plain versions
  (the copy without the lo-half products should have some, the source
  none);
- T1, T2's dq' launch and T2's dk'/dv' launch timed apart
  (chip_smoke.time_ms) at whisper-large-v3's training shapes, B = 16 and 8
  (encoder 1500 x 1500, cross 256 x 1500, decoder causal 256 x 256, 20
  heads of 64), and qwen2-1.5b's (16, 256, 12 heads on 2 KV heads, 128,
  causal), in bfloat16; and in float32 at lm-100m's (16, 256, 8 heads on
  4, 64, causal) and qwen2-1.5b's shapes (with another commit's source
  given, its float32 T1 beside this one's).

A copy that removes a part gives wrong outputs; only its time is read
beside its shared-mean counts.  The copies are exact replacements of the
source's text (one that no longer matches raises).  Prints the card, one
line per copy and shape, then one JSON line.  To compare two commits,
``git show <commit>:<path of flash_attention.cu> > build/other.cu`` and
pass that file.
"""
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402

# copy -> [(text of the source, its replacement)]
VARIANTS = {
    "as built": [],
    # the products of the lo halves of P, P ⊙ S', P', dS and dS'
    "no lo-half products": [
        ("      wgmma_rs128(flat, lo[kk], db);\n", ""),
        ("      wgmma_rs(acc[0], lo[kk], db);\n", "")],
    # the lo halves' conversions (lo = hi), their products kept
    "no lo-half conversions": [(
        "      lo[kk][j] = pack_bf16(a - __uint_as_float(h << 16),\n"
        "                            b - __uint_as_float(h & 0xffff0000u));\n",
        "      lo[kk][j] = h;\n")],
    # exp2 of the logits
    "no exp2": [("    s[e] = exp2_approx(x);\n  }\n}\n",
                 "    s[e] = x * 1e-3f;\n  }\n}\n")],
    # the float32 T1 at d <= 64 one block an SM (all 255 registers) rather
    # than two (128, some spilled)
    "f32 T1 one block an SM": [(
        "__global__ void __launch_bounds__(kThreadsT, D <= 64 ? 2 : 1)\n"
        "tangent_fwd_kernel",
        "__global__ void __launch_bounds__(kThreadsT, 1)\n"
        "tangent_fwd_kernel")],
}
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = {**{f"{name} B{B}": (B, S, Sk, 20, 20, 64, causal, BF16)
             for B in (16, 8)
             for name, (S, Sk, causal) in cs.WHISPER_TANGENT.items()},
          "qwen2": (16, 256, 256, 12, 2, 128, True, BF16),
          "lm-100m f32": (16, 256, 256, 8, 4, 64, True, F32),
          "qwen2 f32": (16, 256, 256, 12, 2, 128, True, F32)}


def copies(others) -> dict:
    src = ops.SOURCE.read_text()
    texts = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"copy {name!r}: the source no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        texts[name] = text
    texts.update({str(p): Path(p).read_text() for p in others})
    libs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for i, (name, text) in enumerate(texts.items()):
        path = BUILD_DIR / f"flash_ablate_{i}.cu"
        path.write_text(text)
        libs[name] = CudaLibrary(path, f"flash_ablate_{i}", ops._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        for name, info in zip(libs, pool.map(lambda l: l.build(),
                                             libs.values())):
            print(f"build {name}: {info['seconds']:.1f} s", flush=True)
    return libs


def time_parts(libs, gen, B, S, Sk, H, KV, d, causal, dtype) -> dict:
    """{copy: {"T1", "dq", "dkv": ms}} at one shape and dtype, each the
    median of two chip_smoke.time_ms readings."""
    def draw(s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)
    q, tq, do, tdo = (draw((B, S, H, d)) for _ in range(4))
    k, v, tk, tv = (draw((B, Sk, KV, d)) for _ in range(4))
    ops._LIB = libs["as built"]
    o, lse = ops.gqa_flash_attention_fwd_lse(q, k, v, causal=causal)
    kw = dict(causal=causal, window=None, heads_dim=2)
    to, tlse = ops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk, tv, **kw)
    tdq, tdk, tdv = (torch.empty_like(t) for t in (q, k, v))
    dsum, tdsum = (torch.empty(B, H, S, device="cuda") for _ in "DD")
    strides = ops._view_strides(2, q=q, k=k, v=v, o=o, dout=do, tq=tq, tk=tk,
                                tv=tv, to=to, tdout=tdo, tdq=tdq, tdk=tdk,
                                tdv=tdv)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, tq, tk, tv, to, tdo,
                                   tlse, dsum, tdsum, tdq, tdk, tdv)]

    def part(lib, p):
        err = lib.lib.repro_flash_bwd_tangent(
            *ptrs, strides, B, H, KV, S, Sk, d, d ** -0.5, int(causal), 0, p,
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"T2 part {p} failed with {err}")

    out = {}
    for name, lib in libs.items():
        ops._LIB = lib
        part(lib, 0)                          # D and D' for part 1
        n = 2 if S * Sk * B > 1 << 24 else 5
        times = {"T1": [], "dq": [], "dkv": []}
        for _ in range(2):
            times["T1"].append(cs.time_ms(
                lambda: ops.flash_attention_fwd_tangent(q, k, v, lse, tq, tk,
                                                        tv, **kw), n))
            times["dq"].append(cs.time_ms(lambda: part(lib, 0), n))
            times["dkv"].append(cs.time_ms(lambda: part(lib, 1), n))
        out[name] = {p: statistics.median(t) for p, t in times.items()}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_flash_tangents: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    libs = copies(sys.argv[1:])
    built = ops._LIB
    res = {"shared_mean": {}, "ms": {}}
    try:
        for name, lib in libs.items():
            ops._LIB = lib
            res["shared_mean"][name] = cs.shared_mean_tangents(ops, fref)
            print("shared mean", name, json.dumps(res["shared_mean"][name]),
                  flush=True)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for shape, dims in SHAPES.items():
            res["ms"][shape] = time_parts(libs, gen, *dims)
            for name, row in res["ms"][shape].items():
                print(shape, name, json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    finally:
        ops._LIB = built
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
