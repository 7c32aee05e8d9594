"""The float32 flash-attention backward's route to its Hopper kernels
(namespace ``tf32`` of ``csrc/flash_attention.cu``), on the CPU.

* The kernels' arithmetic, modelled in PyTorch (``ref.split_tf32``,
  ``ref.tf32_matmul``): every product as three TF32 products.  Through that
  model the attention gradients stay within the float32 backward tolerance
  of a float64 backward; one TF32 product a product would not.
* What the wrapper hands the kernel entry: a fake library records the
  launches, so the model layout's backward is seen to pass the caller's
  unexpanded K/V (by data pointer and strides), never to expand heads,
  and to get dK/dV back as (B, S, KV, d).
The kernels themselves run in test_torch_cuda.py and chip_smoke.py."""
import contextlib
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

# chip_smoke.py's FLASH_TOL[float32]["bwd"]: the kernels' gradients against
# autograd and the plain version.
BWD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mask(S, causal, window):
    return ref.band_mask(S, S, causal, window)


def _bwd_f64(q, k, v, do, causal, window, scale):
    """The backward in float64 from float32 inputs: (dq, dk, dv, out,
    lse), out and lse rounded to float32 as the forward kernel stores
    them."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    s = torch.where(_mask(q.shape[2], causal, window),
                    qd @ kd.transpose(-1, -2) * scale, ref.NEG_INF)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = p @ vd
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (dod * out).sum(-1, keepdim=True)) * scale
    return (ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod,
            out.float(), lse.float())


def _bwd_model(q, k, v, out, lse, do, causal, window, scale, products):
    """The float32 backward kernels' arithmetic: S, dP, dQ, dK and dV each
    through ``tf32_matmul`` (``products`` TF32 products a product), P, dS,
    lse and D = rowsum(dO ⊙ O) in float32."""
    mm = lambda a, b: ref.tf32_matmul(a, b, products)
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(torch.where(_mask(q.shape[2], causal, window), s,
                              ref.NEG_INF) - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (do * out).sum(-1, keepdim=True)) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _outside(got, want):
    err = (got.double() - want).abs()
    return int((err > BWD_TOL["atol"] + BWD_TOL["rtol"] * want.abs()).sum())


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)],
                         ids=["causal", "full", "window64"])
@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_gradients_meet_the_float32_tolerance(d, causal, window):
    """dq, dk and dv through the 3×TF32 model within the float32 backward
    tolerance (1e-4) of a float64 backward at head dims 64 and 128 (the
    lm-100m and qwen2 widths); one TF32 product a product, printed beside
    it, leaves elements outside — why the kernels take three."""
    rng = np.random.default_rng(d + 7 * (window or 0) + causal)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 2, 256, d)).astype(np.float32))
        for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    *want, out, lse = _bwd_f64(q, k, v, do, causal, window, scale)
    three = _bwd_model(q, k, v, out, lse, do, causal, window, scale, 3)
    one = _bwd_model(q, k, v, out, lse, do, causal, window, scale, 1)
    err = lambda gs: max(float((g.double() - w).abs().max())
                         for g, w in zip(gs, want))
    bad3 = [_outside(g, w) for g, w in zip(three, want)]
    bad1 = [_outside(g, w) for g, w in zip(one, want)]
    print(f"d={d} causal={causal} window={window}: 3xTF32 max abs err "
          f"{err(three):.2e} ({sum(bad3)} outside {BWD_TOL}); one TF32 "
          f"product {err(one):.2e} ({sum(bad1)} outside)")
    assert bad3 == [0, 0, 0]
    assert sum(bad1) > 0 and err(one) > 10 * err(three)


def test_split_tf32_rounds_to_nearest_and_keeps_21_bits():
    """hi has no bits below TF32's 10-bit mantissa and is x rounded to
    nearest (within half a TF32 ulp, 2^-11 relative); hi + lo is within
    2^-21 of x, relative, over many magnitudes and both signs."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.uniform(-20, 20, 1 << 16)
                          ).astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((hi.double() + lo.double() - xd).abs()
            <= 2.0 ** -21 * xd.abs()).all()
    assert torch.equal(ref.tf32_round(-x), -ref.tf32_round(x))


class _FakeLib:
    """Records each call of the float32 backward's C entry: the pointer
    arguments, the strides array and the scalars."""

    def __init__(self):
        self.calls = []

    def repro_flash_bwd_f32(self, *args):
        ptrs, strides, rest = args[:10], args[10], args[11:]
        self.calls.append(dict(ptrs=ptrs, strides=list(strides)[:24],
                               rest=rest))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' CUDA route on CPU tensors: the route forced to the
    kernels, the library replaced by a recorder, the stream and device
    context stubbed; repeat_interleave raises if anything expands heads."""
    lib = _FakeLib()
    monkeypatch.setattr(ops, "_route", lambda name, q: "cuda")
    monkeypatch.setattr(ops, "_LIB", types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_expansion(*args, **kw):
        raise AssertionError("the float32 backward expanded K/V heads")

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", no_expansion)
    monkeypatch.setattr(torch, "repeat_interleave", no_expansion)
    return lib


def _bsh(t, heads_dim):
    sb, s1, s2, _ = t.stride()
    return [sb, s2, s1] if heads_dim == 1 else [sb, s1, s2]


def test_model_layout_backward_hands_the_kernel_unexpanded_kv(fake_launch):
    """``gqa_flash_attention_bwd`` in float32: two launches (dQ with D,
    then dK/dV), each given q, k, v, out and dO by their own data pointers
    and (b, s, h) strides — K/V with their 2 KV heads, not 4 — and dK/dV
    allocated as (B, S, KV, d)."""
    B, S, H, KV, d = 2, 64, 4, 2, 32
    gen = torch.Generator().manual_seed(0)
    q, out, do = (torch.randn(B, S, H, d, generator=gen) for _ in range(3))
    k, v = (torch.randn(B, S, KV, d, generator=gen) for _ in "kv")
    lse = torch.randn(B, H, S, generator=gen)
    before = ops.launch_counts["flash_attention_bwd"]
    dq, dk, dv = ops.gqa_flash_attention_bwd(q, k, v, out, lse, do)
    assert ops.launch_counts["flash_attention_bwd"] == before + 2
    assert dq.shape == (B, S, H, d)
    assert dk.shape == dv.shape == (B, S, KV, d)
    calls = fake_launch.calls
    assert [c["rest"][-3] for c in calls] == [0, 1]      # dQ, then dK/dV
    for c in calls:
        ptrs = c["ptrs"]
        assert ptrs[:6] == tuple(t.data_ptr() for t in (q, k, v, out, do,
                                                        lse))
        assert ptrs[7:] == tuple(t.data_ptr() for t in (dq, dk, dv))
        views = (q, k, v, out, do, dq, dk, dv)
        assert c["strides"] == sum((_bsh(t, 2) for t in views), [])
        assert c["rest"][:6] == (B, H, KV, S, S, d)
        assert c["rest"][-2] == 1                        # 16-byte tiles


def test_heads_first_backward_reads_views_in_place(fake_launch):
    """``flash_attention_bwd`` in float32 on (B, H, S, d) views of (B, S,
    H, d) tensors (the forward's transposed output, as the autograd
    Function saves it): the same pointers, the views' own strides, no
    contiguous copy; an odd row stride turns the 16-byte tiles off."""
    B, S, H, d = 1, 48, 2, 16
    gen = torch.Generator().manual_seed(1)
    q, k, v, out, do = (torch.randn(B, S, H, d, generator=gen
                                    ).transpose(1, 2) for _ in range(5))
    lse = torch.randn(B, H, S, generator=gen)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=False, window=8)
    assert dq.shape == dk.shape == dv.shape == (B, H, S, d)
    c = fake_launch.calls[-1]
    assert c["ptrs"][:5] == tuple(t.data_ptr() for t in (q, k, v, out, do))
    assert c["strides"][:15] == sum((_bsh(t, 1) for t in
                                     (q, k, v, out, do)), [])
    assert c["rest"][7:11] == (0, 8, 1, 1)   # causal, window, part, vec
    odd = torch.randn(B, S, H, d + 1, generator=gen)[..., :d].transpose(1, 2)
    ops.flash_attention_bwd(odd, k, v, out, lse, do)
    assert fake_launch.calls[-1]["rest"][10] == 0       # element by element
