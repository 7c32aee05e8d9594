"""The float32 SSD scan and its backward on the tensor cores, modelled on
the CPU: the forward's three passes (namespace ``tfs`` of
``ssd_scan/csrc/ssd_scan.cu``) and the backward's (namespace ``tbw`` of
``ssd_bwd.cu``), every product as three TF32 products
(``torch_tf32_model``: ``ref.split_tf32``, hi = tf32(x) rounded to
nearest, lo = x - hi as the tensor core reads it).

* The forward (y and the final state) stays within chip_smoke.py's
  ``SSD_TOL[float32]`` of the same passes in float64, and the backward
  (dx, ddt, dA, dB, dC) within ``SSD_BWD_TOL[float32]``, dA within
  ``STEEP_DA_REL`` where seg falls past 88 within a chunk: at two chunks
  and two groups, a ragged chunk (L = chunk = 100, P = 8, N = 16) and seg
  falling by about 250 within each of two chunks.  The float64 passes are
  held against the plain versions (``ref``'s passes, float32) first.
* One TF32 product a product (hi · hi) leaves elements of the forward and
  of the backward outside those tolerances (the test prints how many): the
  kernels need the three.
The kernels themselves run in test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ref as sref
from torch_tf32_model import bwd_model, fwd_model

# chip_smoke.py's SSD_TOL[float32] (elementwise against the per-step
# recurrence), SSD_BWD_TOL[float32] (1e-4 of the gradient's largest
# |value|) and STEEP_DA_REL (dA where seg falls past 88 within a chunk: a
# sum of row and column sums that nearly cancel)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_REL = 1e-4
STEEP_DA_REL = 1e-3
NAMES = ("dx", "ddt", "dA", "dB", "dC")
# (B, L, H, P, N, G, chunk, steep dt): two chunks and two groups; one
# ragged chunk of 100 rows; seg falling by about 250 within each of two
# chunks
SHAPES = [(2, 256, 4, 16, 32, 2, 128, None),
          (2, 100, 4, 8, 16, 2, 100, None),
          (1, 512, 2, 16, 32, 1, 256, 4.0)]
IDS = ["groups-two-chunks", "ragged-100", "steep-seg"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(shape):
    """float32 inputs (A per sequence) and cotangents, drawn with numpy
    (chip_smoke.py's distributions)."""
    B, L, H, P, N, G, chunk, steep = shape
    rng = np.random.default_rng(5)
    draw = lambda *s: rng.standard_normal(s)
    x = draw(B, L, H, P)
    dt = 0.5 * np.log1p(np.exp(draw(B, L, H)))
    if steep is not None:
        dt = np.full_like(dt, steep)
    A = -np.exp(0.3 * draw(H)) * (0.5 + rng.random((B, 1)))
    Bm, Cm = (0.3 * draw(B, L, G, N) for _ in "BC")
    gy, gs = draw(B, L, H, P), draw(B, H, P, N)
    args = [torch.from_numpy(t.astype(np.float32))
            for t in (x, dt, A, Bm, Cm, gy, gs)]
    return args, chunk, steep is not None


def _f64(ts):
    return [t.double() for t in ts]


def _fwd_outside(got, want):
    """Elements of y and of the state outside FWD_TOL."""
    return {name: int(((g.double() - w).abs()
                       > FWD_TOL["atol"] + FWD_TOL["rtol"] * w.abs()).sum())
            for name, g, w in zip(("y", "state"), got, want)}


def _bwd_outside(got, want, steep):
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rel = STEEP_DA_REL if steep and name == "dA" else BWD_REL
        out[name] = int(((g.double() - w).abs() > rel * w.abs().max()).sum())
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_float64_passes_match_the_plain_versions(shape):
    """The models' passes in float64 (the yardsticks below) against the
    plain versions in float32: the forward against ``chunk_state_ref``,
    ``state_pass_ref`` and ``chunk_scan_ref`` composed, the backward
    against ``bwd_chunk_ref`` after its state and pass passes."""
    args, chunk, steep = _case(shape)
    x, dt, A, Bm, Cm, gy, gs = args
    S, seg = sref.chunk_state_ref(x, dt, A, Bm, chunk)
    s_in, state = sref.state_pass_ref(S, seg, chunk)
    y = sref.chunk_scan_ref(x, dt, seg, Bm, Cm, s_in, chunk)
    fwd = fwd_model(*_f64(args[:5]), chunk, None)
    assert _fwd_outside((y, state), fwd) == {"y": 0, "state": 0}
    S, Lc, seg = sref.bwd_state_ref(*args[:6], chunk)
    s_in, gO, sg = sref.bwd_state_pass_ref(S, Lc, seg, gs, chunk)
    plain = sref.bwd_chunk_ref(*args[:6], seg, s_in, gO, sg, chunk)
    outside = _bwd_outside(plain, bwd_model(*_f64(args), chunk, None),
                           steep)
    assert not any(outside.values()), outside


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_3xtf32_meets_the_float32_tolerances(shape):
    """The forward through the 3×TF32 model within SSD_TOL[float32] of the
    float64 passes, the backward within SSD_BWD_TOL[float32] (dA within
    STEEP_DA_REL where seg falls steeply)."""
    args, chunk, steep = _case(shape)
    fwd = _fwd_outside(fwd_model(*args[:5], chunk, 3),
                       fwd_model(*_f64(args[:5]), chunk, None))
    assert fwd == {"y": 0, "state": 0}, fwd
    bwd = _bwd_outside(bwd_model(*args, chunk, 3),
                       bwd_model(*_f64(args), chunk, None), steep)
    assert not any(bwd.values()), bwd


def test_one_tf32_product_falls_outside():
    """With one TF32 product a product (hi · hi) the models leave elements
    of the forward and of the backward outside the float32 tolerances: the
    kernels need the three."""
    fwd, bwd = {}, {}
    for i, shape in zip(IDS, SHAPES):
        args, chunk, steep = _case(shape)
        fwd[i] = _fwd_outside(fwd_model(*args[:5], chunk, 1),
                              fwd_model(*_f64(args[:5]), chunk, None))
        bwd[i] = _bwd_outside(bwd_model(*args, chunk, 1),
                              bwd_model(*_f64(args), chunk, None), steep)
    print("one TF32 product, elements outside:", fwd, bwd)
    assert all(sum(o.values()) > 0 for o in fwd.values()), fwd
    assert all(sum(o.values()) > 0 for o in bwd.values()), bwd
