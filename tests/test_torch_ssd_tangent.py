"""T3, the SSD scan's forward-mode tangent, as the three passes of its
bfloat16 kernels (tangent chunk states, tangent state passing, tangent chunk
outputs): their plain versions composed, and the kernel wrappers composed on
CPU tensors (the plain versions, with the entering states handed over as
hi/lo bf16 planes, as the kernels hand them over), against
``ssd_scan_tangent_ref`` and ``jax.jvp`` of the JAX package's per-step
``ssd_scan_ref`` on the same numpy inputs.  The kernels themselves are held
against these plain versions in test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels.ssd_scan import ops, ref

# float32: the same tangent summed in another order (chunked against the
# per-step recurrence), within 1e-5 of each result's largest |value|.
# bfloat16 (the kernels' route: y' rounded to bf16, the entering states
# carried as hi/lo pairs): chip_smoke.py's TANGENT_TOL, one bf16 rounding of
# the element (rtol) plus 2^-8 of the result's largest |value|.
F32_REL = 1e-5
BF16_RTOL, BF16_REL = 1.6e-2, 2.0 ** -8
GRID = [(128, 32), (256, 64), (256, 128)]     # tests/test_kernels.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B=2, L=128, H=4, P=16, N=32, G=1, per_sequence_A=False):
    """tests/test_kernels.py's distributions and standard normal tangents,
    drawn with numpy: (x, dt, A, B, C) and (x', dt', A', B', C')."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P))
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3)
    if per_sequence_A:
        A = A[None] * (0.5 + rng.random((B, 1)))
    Bm, Cm = (rng.standard_normal((B, L, G, N)) * 0.3 for _ in "BC")
    primals = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    tangents = [rng.standard_normal(a.shape).astype(np.float32)
                for a in primals]
    return primals, tangents


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _compose(primals, tangents, chunk, through_wrappers):
    """T3's three passes composed: the plain versions in float32, or the
    kernel wrappers (bf16 x, B, C and tangents; hi/lo planes)."""
    x, dt, A, Bm, Cm = primals
    tx, tdt, tA, tB, tC = tangents
    if through_wrappers:
        S, tS, seg, tseg = ops.ssd_tangent_state(x, dt, A, Bm, tx, tdt, tA,
                                                 tB, chunk=chunk)
        hi, lo, thi, tlo, tstate = ops.ssd_tangent_pass(S, tS, seg, tseg,
                                                        chunk=chunk)
        return ops.ssd_tangent_scan(x, dt, seg, Bm, Cm, tx, tdt, tseg, tB,
                                    tC, hi, lo, thi, tlo,
                                    chunk=chunk), tstate
    S, tS, seg, tseg = ref.tangent_state_ref(x, dt, A, Bm, tx, tdt, tA, tB,
                                             chunk)
    s_in, ts_in, tstate = ref.tangent_pass_ref(S, tS, seg, tseg, chunk)
    return ref.tangent_scan_ref(x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC,
                                s_in, ts_in, chunk), tstate


def _torch_args(primals, tangents, dtype):
    """x, B, C and their tangents in ``dtype``; dt, A and theirs float32
    (dt rounded to ``dtype`` first, as the model hands it over)."""
    cast = [dtype, torch.float32, torch.float32, dtype, dtype]
    p = [_t(a, c) for a, c in zip(primals, cast)]
    p[1] = p[1].to(dtype).float()
    return p, [_t(a, c) for a, c in zip(tangents, cast)]


def _jax_jvp(primals, tangents, H):
    """jax.jvp of the reference's per-step scan, B and C repeated to heads
    as its ops.ssd_scan does."""
    def scan(x, dt, A, Bm, Cm):
        rep = lambda a: jnp.repeat(a, H // a.shape[2], axis=2)
        return jax_ssd_scan_ref(x, dt, A, rep(Bm), rep(Cm))

    _, (ty, ts) = jax.jvp(scan, tuple(map(jnp.asarray, primals)),
                          tuple(map(jnp.asarray, tangents)))
    return np.asarray(ty), np.asarray(ts)


def assert_tangent_close(got, want, dtype=torch.float32):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        limit = BF16_RTOL * np.abs(want) + BF16_REL * np.abs(want).max()
    else:
        limit = F32_REL * np.abs(want).max()
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= limit).all(), (f"{int((err > limit).sum())} elements "
                                  f"outside; max abs err {err.max():.3e}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32-plain", "bfloat16-wrappers"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L,chunk", GRID)
def test_tangent_passes_compose_to_the_reference(L, chunk, G, dtype):
    """tests/test_kernels.py's grid with one or two B/C groups for H = 4:
    the composed passes against ``ssd_scan_tangent_ref`` and ``jax.jvp`` of
    the per-step reference.  float32 composes the plain versions; bfloat16 goes through
    the kernel wrappers, hi/lo planes and all, against the reference on the
    same bf16 inputs."""
    primals, tangents = _inputs(L + chunk + G, L=L, G=G)
    p, t = _torch_args(primals, tangents, dtype)
    y, s = _compose(p, t, chunk, through_wrappers=dtype == torch.bfloat16)
    assert y.dtype == dtype and s.dtype == torch.float32
    wy, ws = ref.ssd_scan_tangent_ref(*p, *t)
    assert_tangent_close(y, wy.to(dtype).float(), dtype)
    assert_tangent_close(s, ws)
    if dtype == torch.float32:
        jy, js = _jax_jvp(primals, tangents, 4)
        assert_tangent_close(y, jy)
        assert_tangent_close(s, js)


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
def test_tangent_passes_with_A_per_sequence_and_a_ragged_chunk(
        through_wrappers):
    """A per sequence (B, H), as ``vmap`` over users folds it, with A' per
    sequence too; chunks of 48 (not a multiple of 64), narrow heads (P = 8,
    N = 16) and two groups."""
    primals, tangents = _inputs(31, B=3, L=96, H=4, P=8, N=16, G=2,
                                per_sequence_A=True)
    p, t = _torch_args(primals, tangents, torch.float32)
    y, s = _compose(p, t, 48, through_wrappers)
    jy, js = _jax_jvp(primals, tangents, 4)
    if through_wrappers:        # float32 inputs, hi/lo planes: 16 bits
        assert_tangent_close(y, jy, torch.bfloat16)
    else:
        assert_tangent_close(y, jy)
    assert_tangent_close(s, js)


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
def test_tangent_passes_stay_finite_where_seg_falls_past_88(
        through_wrappers):
    """dt near 1 and A = -1 over chunks of 256: seg falls by about 250
    within a chunk, so exp(seg_q) exp(-seg_k) and exp of the unmasked
    differences overflow.  The passes take exp of masked differences: y'
    and the state's tangent are finite and equal the reference's."""
    primals, tangents = _inputs(32, B=1, L=512, H=2, P=8, N=16)
    rng = np.random.default_rng(33)
    primals[1] = (0.9 + 0.2 * rng.random((1, 512, 2))).astype(np.float32)
    primals[2] = -np.ones(2, np.float32)
    seg = np.cumsum(primals[1][0, :256, 0] * primals[2][0])
    assert seg[0] - seg[-1] > 88
    p, t = _torch_args(primals, tangents, torch.float32)
    y, s = _compose(p, t, 256, through_wrappers)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jy, js = _jax_jvp(primals, tangents, 2)
    assert_tangent_close(y, jy, torch.bfloat16 if through_wrappers
                         else torch.float32)
    assert_tangent_close(s, js)


@pytest.mark.parametrize("through_wrappers", [False, True],
                         ids=["plain", "wrappers"])
def test_tangent_passes_on_one_chunk(through_wrappers):
    """A sequence no longer than the chunk (100 rows, not a multiple of
    16): no state enters it, so every entering plane is empty."""
    primals, tangents = _inputs(34, B=2, L=100, H=4, P=16, N=32, G=2)
    p, t = _torch_args(primals, tangents, torch.float32)
    y, s = _compose(p, t, 100, through_wrappers)
    jy, js = _jax_jvp(primals, tangents, 4)
    assert_tangent_close(y, jy, torch.bfloat16 if through_wrappers
                         else torch.float32)
    assert_tangent_close(s, js)


def test_tangent_passes_carry_the_forward_passes():
    """The primal plane of each tangent pass is the forward pass's own:
    S and seg of pass 1 equal ``chunk_state_ref``'s, and the entering
    states of pass 2 ``state_pass_ref``'s."""
    primals, tangents = _inputs(35, L=128)
    p, t = _torch_args(primals, tangents, torch.float32)
    x, dt, A, Bm, _ = p
    S, tS, seg, tseg = ref.tangent_state_ref(x, dt, A, Bm, t[0], t[1], t[2],
                                             t[3], 32)
    S0, seg0 = ref.chunk_state_ref(x, dt, A, Bm, 32)
    assert torch.equal(S, S0) and torch.equal(seg, seg0)
    s_in, _, _ = ref.tangent_pass_ref(S, tS, seg, tseg, 32)
    s_in0, _ = ref.state_pass_ref(S, seg, 32)
    assert torch.equal(s_in, s_in0)


def test_tangent_pass_wrappers_check_their_shapes():
    primals, tangents = _inputs(36, L=64)
    p, t = _torch_args(primals, tangents, torch.float32)
    x, dt, A, Bm, Cm = p
    tx, tdt, tA, tB, tC = t
    S, tS, seg, tseg = ops.ssd_tangent_state(x, dt, A, Bm, tx, tdt, tA, tB,
                                             chunk=32)
    assert S.shape == tS.shape == (2, 2, 4, 16, 32)
    assert seg.shape == tseg.shape == (2, 4, 64)
    hi, lo, thi, tlo, tstate = ops.ssd_tangent_pass(S, tS, seg, tseg,
                                                    chunk=32)
    assert all(a.shape == (2, 1, 4, 16, 32) and a.dtype == torch.bfloat16
               for a in (hi, lo, thi, tlo))
    assert tstate.shape == (2, 4, 16, 32)
    with pytest.raises(ValueError, match="do not fit S"):
        ops.ssd_tangent_pass(S, tS, seg[:, :, :32], tseg, chunk=32)
    with pytest.raises(ValueError, match="do not fit x"):
        ops.ssd_tangent_scan(x, dt, seg, Bm, Cm, tx, tdt, tseg[:, :, :32],
                             tB, tC, hi, lo, thi, tlo, chunk=32)
    with pytest.raises(ValueError, match="do not fit x"):
        ops.ssd_tangent_scan(x, dt, seg, Bm, Cm, tx, tdt, tseg, tB, tC, hi,
                             lo, thi[:, :0], tlo, chunk=32)
