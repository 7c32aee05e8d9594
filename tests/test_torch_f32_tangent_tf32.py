"""The float32 tangents on the tensor cores, modelled on the CPU: T1
(namespace ``tf32`` of ``flash_attention/csrc/flash_attention.cu``) and the
SSD backward's tangent (namespace ``tbw`` of ``ssd_scan/csrc/ssd_bwd.cu``),
every product as three TF32 products (``ref.split_tf32``: hi = tf32(x)
rounded to nearest, lo = x - hi as the tensor core reads it).

* T1's arithmetic (S, S', P V, (P ⊙ S') V and P V' through
  ``ref.tf32_matmul``; P = exp(S - lse), P ⊙ S', lse' and o' = O' - lse' O
  in float32; o recomputed as P V, as the kernel does) stays within the
  float32 tangent tolerance of ``torch.func.jvp`` of a float64 forward at
  lm-100m's head dim, causal and windowed, on N(0, 1) inputs and on inputs
  sharing a mean (chip_smoke.py's SHARED_MEAN construction).
* The SSD backward's tangent: the backward's passes with every einsum
  through three TF32 products and ``torch.func.jvp`` of that (a product's
  tangent is A' B + A B', each product three TF32 products, as the kernels
  form them) stay within ``SSD_BWD_TOL[float32]`` of the same passes in
  float64, at two chunks and two groups and where seg falls past 88 within
  a chunk (dA there within STEEP_DA_REL).  The float64 passes are held
  against ``ref.tangent_bwd_chunk_ref`` (float32) first.
* One TF32 product a product (hi · hi) falls outside those tolerances:
  the three products are needed.
The kernels themselves run in test_torch_cuda.py and chip_smoke.py."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd_scan import ref as sref
from torch_tf32_model import bwd_model

# chip_smoke.py's TANGENT_TOL[float32] and SSD_BWD_TOL[float32]: within
# 1e-4 of the output's largest |value|
TANGENT_REL = 1e-4
SSD_REL = 1e-4
# dA where seg falls past 88 within a chunk: a sum of row and column sums
# that nearly cancel (test_torch_ssd_bwd.py's limit)
STEEP_DA_REL = 1e-4
# chip_smoke.py's shared-mean construction: values sharing a mean, keys a
# direction
V_MEAN, K_DIRECTION = 4.0, 1.0
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# T1
# ---------------------------------------------------------------------------

def _t1_inputs(d, shared_mean, seed):
    """q, k, v and their tangents (1, 2, 256, d) float32, drawn with numpy;
    with ``shared_mean`` the values share a mean of V_MEAN and the keys a
    direction, so that o' = O' - lse' O is a difference of large sums."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.standard_normal(s)
    q, k, v, tq, tk, tv = (draw(1, 2, 256, d) for _ in range(6))
    if shared_mean:
        k, v = k + K_DIRECTION * draw(d), v + V_MEAN
    return tuple(torch.from_numpy(t.astype(np.float32))
                 for t in (q, k, v, tq, tk, tv))


def _fwd64(q, k, v, causal, window, scale):
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window)
    s = torch.where(mask, q @ k.transpose(-1, -2) * scale, fref.NEG_INF)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v, lse


def _t1_model(q, k, v, lse, tq, tk, tv, causal, window, scale, products):
    """T1's kernel arithmetic on float32 inputs: S, S', P V, (P ⊙ S') V and
    P V' through ``tf32_matmul``; P from the saved lse; the tangent logit 0
    on the pairs the band excludes."""
    mm = lambda a, b: fref.tf32_matmul(a, b, products)
    t = lambda x: x.transpose(-1, -2)
    mask = fref.band_mask(q.shape[2], k.shape[2], causal, window)
    p = torch.exp(torch.where(mask, mm(q, t(k)) * scale, fref.NEG_INF)
                  - lse[..., None])
    ps = p * torch.where(mask, (mm(tq, t(k)) + mm(q, t(tk))) * scale, 0.0)
    tlse = ps.sum(-1)
    o = mm(p, v)
    return mm(ps, v) + mm(p, tv) - tlse[..., None] * o, tlse


def _t1_outside(d, causal, window, shared_mean, products):
    """(elements outside TANGENT_REL of o' and lse', largest error relative
    to the largest |value|) of T1's model against the float64 jvp."""
    inputs = _t1_inputs(d, shared_mean, 7 * d + causal + (window or 0)
                        + 100 * shared_mean)
    scale = 1.0 / math.sqrt(d)
    q, k, v, tq, tk, tv = (x.double() for x in inputs)
    (_, lse), want = torch.func.jvp(
        lambda q, k, v: _fwd64(q, k, v, causal, window, scale), (q, k, v),
        (tq, tk, tv))
    got = _t1_model(*inputs[:3], lse.float(), *inputs[3:], causal, window,
                    scale, products)
    bad, rel = 0, 0.0
    for g, w in zip(got, want):
        err = (g.double() - w).abs()
        bad += int((err > TANGENT_REL * w.abs().max()).sum())
        rel = max(rel, float(err.max() / w.abs().max()))
    return bad, rel


T1_CASES = [(64, True, None, False), (64, True, 64, False),
            (64, True, None, True), (64, False, None, True)]
T1_IDS = ["causal", "window64", "causal-shared-mean", "full-shared-mean"]


@pytest.mark.parametrize("d,causal,window,shared_mean", T1_CASES,
                         ids=T1_IDS)
def test_t1_3xtf32_meets_the_float32_tangent_tolerance(d, causal, window,
                                                       shared_mean):
    """o' and lse' through T1's 3×TF32 model within 1e-4 of the largest
    |value| of the float64 jvp, at lm-100m's head dim (64)."""
    bad, rel = _t1_outside(d, causal, window, shared_mean, 3)
    assert bad == 0, (bad, rel)


# ---------------------------------------------------------------------------
# the SSD backward's tangent
# ---------------------------------------------------------------------------

# (B, L, H, P, N, G, chunk, steep dt): two chunks and two groups; seg
# falling by about 250 within each of two chunks
SSD_SHAPES = [(2, 256, 4, 16, 32, 2, 128, None),
              (1, 512, 2, 16, 32, 1, 256, 4.0)]
SSD_IDS = ["groups-two-chunks", "steep-seg"]


def _ssd_case(shape):
    """float32 inputs (A per sequence), cotangents and tangents, drawn with
    numpy."""
    B, L, H, P, N, G, chunk, steep = shape
    rng = np.random.default_rng(3)
    draw = lambda *s: rng.standard_normal(s)
    x = draw(B, L, H, P)
    dt = 0.5 * np.log1p(np.exp(draw(B, L, H)))
    if steep is not None:
        dt = np.full_like(dt, steep)
    A = -np.exp(0.3 * draw(H)) * (0.5 + rng.random((B, 1)))
    Bm, Cm = (0.3 * draw(B, L, G, N) for _ in "BC")
    gy, gs = draw(B, L, H, P), draw(B, H, P, N)
    args = [x, dt, A, Bm, Cm, gy, gs]
    targs = [draw(*t.shape) for t in args]
    f32 = lambda ts: [torch.from_numpy(t.astype(np.float32)) for t in ts]
    return f32(args), f32(targs), chunk, steep is not None


def _ssd_tangent(args, targs, chunk, products):
    dtype = torch.float64 if products is None else torch.float32
    cast = lambda ts: tuple(t.to(dtype) for t in ts)
    return torch.func.jvp(lambda *a: bwd_model(*a, chunk, products),
                          cast(args), cast(targs))[1]


def _ssd_outside(got, want, steep):
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rel = STEEP_DA_REL if steep and name == "dA" else SSD_REL
        out[name] = int(((g.double() - w.double()).abs()
                         > rel * w.double().abs().max()).sum())
    return out


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=SSD_IDS)
def test_ssd_tangent_float64_passes_match_the_plain_version(shape):
    """The model's passes in float64 (the yardstick below) against the
    plain tangent, ``ref.tangent_bwd_chunk_ref`` after its state and pass
    passes, in float32: within SSD_BWD_TOL[float32]."""
    args, targs, chunk, steep = _ssd_case(shape)
    want = _ssd_tangent(args, targs, chunk, None)
    S, tS, Lc, tLc, seg, tseg = sref.tangent_bwd_state_ref(
        *args[:6], *targs[:6], chunk)
    s_in, ts_in, gO, tgO, sg, tsg = sref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, args[6], targs[6], chunk)
    plain = sref.tangent_bwd_chunk_ref(*args[:6], seg, s_in, gO, sg,
                                       *targs[:6], tseg, ts_in, tgO, tsg,
                                       chunk)
    outside = _ssd_outside(plain, want, steep)
    assert not any(outside.values()), outside


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=SSD_IDS)
def test_ssd_tangent_3xtf32_meets_the_float32_tolerance(shape):
    """dx', ddt', dA', dB', dC' through the 3×TF32 model within
    SSD_BWD_TOL[float32] of the float64 passes (dA' within STEEP_DA_REL
    where seg falls steeply)."""
    args, targs, chunk, steep = _ssd_case(shape)
    want = _ssd_tangent(args, targs, chunk, None)
    got = _ssd_tangent(args, targs, chunk, 3)
    outside = _ssd_outside(got, want, steep)
    assert not any(outside.values()), outside


def test_one_tf32_product_falls_outside():
    """With one TF32 product a product (hi · hi) the models leave elements
    outside the float32 tolerances, for T1 and for the SSD tangent: the
    kernels need the three."""
    t1 = {i: _t1_outside(*case, 1)[0] for i, case in zip(T1_IDS, T1_CASES)}
    ssd = {}
    for i, shape in zip(SSD_IDS, SSD_SHAPES):
        args, targs, chunk, steep = _ssd_case(shape)
        ssd[i] = _ssd_outside(_ssd_tangent(args, targs, chunk, 1),
                              _ssd_tangent(args, targs, chunk, None), steep)
    print("one TF32 product, outside:", t1, ssd)
    assert sum(t1.values()) > 0, t1
    assert sum(sum(o.values()) for o in ssd.values()) > 0, ssd
