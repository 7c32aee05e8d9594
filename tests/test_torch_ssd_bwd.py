"""The SSD scan's backward (kernel ``ssd_scan_bwd``) and the backward's
forward-mode tangent (kernel ``ssd_scan_bwd_tangent``) as the three passes
of their kernels (chunk states and state cotangents, the states and
cotangents carried across chunks, each chunk's gradients): the plain
versions composed, and the kernel wrappers on CPU tensors (the plain
versions), against ``jax.vjp`` of the JAX package's per-step
``ssd_scan_ref`` (and ``jax.jvp`` of that ``jax.vjp``) and against the
port's chunked VJP (``chunked.ssd_scan_vjp`` and ``torch.func.jvp`` of it)
on the same numpy inputs.  The kernels themselves are held against these
plain versions in test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.layers import ssd_scan as jax_chunked_scan
from repro_torch.kernels.ssd_scan import chunked, ops, ref

# float32: the same gradients summed in another order (chunked against the
# per-step recurrence), within 1e-5 of each result's largest |value|;
# bfloat16 inputs (dx, dB and dC rounded to bf16): one bf16 rounding of the
# element (rtol) plus 2^-8 of the result's largest |value|
# (test_torch_ssd_tangent.py's limits).
F32_REL = 1e-5
BF16_RTOL, BF16_REL = 1.6e-2, 2.0 ** -8
# Where seg falls by about 250 within a chunk, dA and its tangent within
# 1e-4 of their largest |value|: the chunked form takes differences of seg
# values near -250 in float32 (about 1.5e-5 of rounding in each exponent)
# and dA sums 512 such rows.  Against a float64 per-step VJP the passes
# are 5.2e-5 (dA) and 8.1e-4 (dA', 1.5e-5 of its largest |value|) off
# there; the port's chunked VJP 5.1e-4 and 4.3e-3.
STEEP_DA_REL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B=2, L=128, H=4, P=16, N=32, G=1, per_sequence_A=False,
            zero_gs=False):
    """tests/test_kernels.py's distributions, standard normal cotangents gy
    and gs (gs zero with ``zero_gs``) and standard normal tangents of all
    seven, drawn with numpy: (x, dt, A, B, C, gy, gs) and their tangents."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P))
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3)
    if per_sequence_A:
        A = A[None] * (0.5 + rng.random((B, 1)))
    Bm, Cm = (rng.standard_normal((B, L, G, N)) * 0.3 for _ in "BC")
    gy = rng.standard_normal((B, L, H, P))
    gs = rng.standard_normal((B, H, P, N)) * (0.0 if zero_gs else 1.0)
    primals = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, gy, gs)]
    tangents = [rng.standard_normal(a.shape).astype(np.float32)
                for a in primals]
    return primals, tangents


def _torch(arrays, dtype=torch.float32):
    """x, B, C, gy (and their tangents) in ``dtype``; dt, A, gs float32,
    dt rounded to ``dtype`` first, as the model hands it over."""
    cast = [dtype, torch.float32, torch.float32, dtype, dtype, dtype,
            torch.float32]
    out = [torch.from_numpy(np.array(a)).to(c) for a, c in zip(arrays, cast)]
    out[1] = out[1].to(dtype).float()
    return out


def _jax_vjp(primals, H):
    """``jax.vjp`` of the reference's per-step scan (B and C repeated to
    heads, their gradients summed back over each group) for the
    cotangents (gy, gs): (dx, ddt, dA, dB, dC)."""
    def scan(x, dt, A, Bm, Cm):
        rep = lambda a: jnp.repeat(a, H // a.shape[2], axis=2)
        return jax_ssd_scan_ref(x, dt, A, rep(Bm), rep(Cm))

    _, fn = jax.vjp(scan, *map(jnp.asarray, primals[:5]))
    return [np.asarray(g) for g in fn((jnp.asarray(primals[5]),
                                       jnp.asarray(primals[6])))]


def _jax_jvp_of_vjp(primals, tangents, H):
    """``jax.jvp`` of :func:`_jax_vjp` (forward over reverse): the tangents
    of the five gradients."""
    def grads(*args):
        def scan(x, dt, A, Bm, Cm):
            rep = lambda a: jnp.repeat(a, H // a.shape[2], axis=2)
            return jax_ssd_scan_ref(x, dt, A, rep(Bm), rep(Cm))

        _, fn = jax.vjp(scan, *args[:5])
        return fn((args[5], args[6]))

    _, out = jax.jvp(grads, tuple(map(jnp.asarray, primals)),
                     tuple(map(jnp.asarray, tangents)))
    return [np.asarray(g) for g in out]


def _compose(p, chunk, through_wrappers=False):
    """The backward's three passes composed: plain versions or wrappers."""
    x, dt, A, Bm, Cm, gy, gs = p
    if through_wrappers:
        S, Lc, seg = ops.ssd_bwd_state(x, dt, A, Bm, Cm, gy, chunk=chunk)
        s_in, gO, sg = ops.ssd_bwd_pass(S, Lc, seg, gs, chunk=chunk)
        return ops.ssd_bwd_chunk(x, dt, A, Bm, Cm, gy, seg, s_in, gO, sg,
                                 chunk=chunk)
    S, Lc, seg = ref.bwd_state_ref(x, dt, A, Bm, Cm, gy, chunk)
    s_in, gO, sg = ref.bwd_state_pass_ref(S, Lc, seg, gs, chunk)
    return ref.bwd_chunk_ref(x, dt, A, Bm, Cm, gy, seg, s_in, gO, sg, chunk)


def _compose_tangent(p, t, chunk, through_wrappers=False):
    """The tangent's three passes composed: plain versions or wrappers."""
    x, dt, A, Bm, Cm, gy, gs = p
    tx, tdt, tA, tB, tC, tgy, tgs = t
    if through_wrappers:
        S, tS, Lc, tLc, seg, tseg = ops.ssd_bwd_tangent_state(
            x, dt, A, Bm, Cm, gy, tx, tdt, tA, tB, tC, tgy, chunk=chunk)
        s_in, ts_in, gO, tgO, sg, tsg = ops.ssd_bwd_tangent_pass(
            S, tS, Lc, tLc, seg, tseg, gs, tgs, chunk=chunk)
        return ops.ssd_bwd_tangent_chunk(
            x, dt, A, Bm, Cm, gy, seg, s_in, gO, sg, tx, tdt, tA, tB, tC,
            tgy, tseg, ts_in, tgO, tsg, chunk=chunk)
    S, tS, Lc, tLc, seg, tseg = ref.tangent_bwd_state_ref(
        x, dt, A, Bm, Cm, gy, tx, tdt, tA, tB, tC, tgy, chunk)
    s_in, ts_in, gO, tgO, sg, tsg = ref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, gs, tgs, chunk)
    return ref.tangent_bwd_chunk_ref(x, dt, A, Bm, Cm, gy, seg, s_in, gO, sg,
                                     tx, tdt, tA, tB, tC, tgy, tseg, ts_in,
                                     tgO, tsg, chunk)


def outside(got, want, dtype=torch.float32) -> tuple[int, float]:
    """(elements of ``got`` outside the limit of ``dtype`` around
    ``want``, non-finite ones included; the largest |got - want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want.detach().float().numpy()
                      if isinstance(want, torch.Tensor) else want, np.float32)
    if dtype == torch.bfloat16:
        limit = BF16_RTOL * np.abs(want) + BF16_REL * np.abs(want).max()
    else:
        limit = F32_REL * np.abs(want).max()
    err = np.abs(got - want)
    return (int((~(err <= limit)).sum()),
            float(err.max()) if err.size else 0.0)


def assert_close(got, want, dtype=torch.float32, dA_rel=None):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        if name == "dA" and dA_rel is not None:
            err = float(np.abs(g.float().numpy() - w).max())
            assert err <= dA_rel * np.abs(w).max(), (name, err)
            continue
        bad, err = outside(g, w, dtype)
        assert bad == 0, (f"{name}: {bad} elements outside; max abs err "
                          f"{err:.3e}")


# (L, chunk, G, A per sequence): tests/test_kernels.py's grid rows with one
# or two B/C groups for H = 4, A (H,) or per sequence (B, H)
CASES = [(L, chunk, G, per_seq) for L, chunk in ((128, 32), (256, 64))
         for G in (1, 2) for per_seq in (False, True)]


def _case_id(case):
    L, chunk, G, per_seq = case
    return f"L{L}-c{chunk}-G{G}-{'A_per_seq' if per_seq else 'A_shared'}"


@pytest.mark.parametrize("case", CASES, ids=map(_case_id, CASES))
def test_backward_passes_compose_to_the_references(case):
    """The composed plain passes against ``jax.vjp`` of the per-step
    reference and against the chunked VJP, float32."""
    L, chunk, G, per_seq = case
    primals, _ = _inputs(L + chunk + G + per_seq, L=L, G=G,
                         per_sequence_A=per_seq)
    p = _torch(primals)
    got = _compose(p, chunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert tuple(got[2].shape) == tuple(p[2].shape)
    assert_close(got, _jax_vjp(primals, 4))
    assert_close(got, chunked.ssd_scan_vjp(*p, chunk))


EDGES = [("ragged-48", 3, 96, 4, 8, 16, 2, 48),
         ("one-chunk-100", 2, 100, 4, 16, 32, 2, 100)]


@pytest.mark.parametrize("zero_gs", [False, True], ids=["gs", "gs-zero"])
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_backward_on_ragged_and_single_chunks(edge, zero_gs):
    """Chunks of 48 rows (not a multiple of 16 or 64) with narrow heads,
    A per sequence and two groups; one chunk of 100 rows (no state enters
    it); the final state's cotangent zero or not."""
    _, B, L, H, P, N, G, chunk = edge
    primals, _ = _inputs(40 + L + zero_gs, B=B, L=L, H=H, P=P, N=N, G=G,
                         per_sequence_A=chunk == 48, zero_gs=zero_gs)
    p = _torch(primals)
    got = _compose(p, chunk)
    assert_close(got, _jax_vjp(primals, H))
    assert_close(got, chunked.ssd_scan_vjp(*p, chunk))


def _steep(seed):
    """dt near 1 and A = -1 over chunks of 256: seg falls by about 250
    within a chunk."""
    primals, tangents = _inputs(seed, B=1, L=512, H=2, P=8, N=16)
    rng = np.random.default_rng(seed + 1)
    primals[1] = (0.9 + 0.2 * rng.random((1, 512, 2))).astype(np.float32)
    primals[2] = -np.ones(2, np.float32)
    seg = np.cumsum(primals[1][0, :256, 0] * primals[2][0])
    assert seg[0] - seg[-1] > 88
    return primals, tangents


def test_backward_stays_finite_where_seg_falls_past_88():
    """Where seg falls by more than 88 within a chunk, the reference's jnp
    chunked scan has NaN gradients for dt and A (it masks after the
    exponential); the passes mask before it, stay finite and equal the
    per-step reference's gradient (dA within STEEP_DA_REL)."""
    primals, _ = _steep(50)
    p = _torch(primals)
    got = _compose(p, 256)
    assert all(torch.isfinite(g).all() for g in got)
    assert_close(got, _jax_vjp(primals, 2), dA_rel=STEEP_DA_REL)

    def loss(x, dt, A):
        y, s = jax_chunked_scan(x, dt, A, *map(jnp.asarray, primals[3:5]),
                                256)
        return jnp.sum(y * primals[5]) + jnp.sum(s * primals[6])

    _, ddt, dA = jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, primals[:3]))
    assert np.isnan(np.asarray(ddt)).any() and np.isnan(np.asarray(dA)).any()


TANGENT_CASES = [(128, 32, G, per_seq) for G in (1, 2)
                 for per_seq in (False, True)]


@pytest.mark.parametrize("case", TANGENT_CASES,
                         ids=map(_case_id, TANGENT_CASES))
def test_tangent_passes_compose_to_the_references(case):
    """The composed plain tangent passes against ``jax.jvp`` of
    ``jax.vjp`` of the per-step reference (forward over reverse) and
    against ``torch.func.jvp`` of the chunked VJP, float32."""
    L, chunk, G, per_seq = case
    primals, tangents = _inputs(60 + G + per_seq, L=L, G=G,
                                per_sequence_A=per_seq)
    p, t = _torch(primals), _torch(tangents)
    got = _compose_tangent(p, t, chunk)
    assert_close(got, _jax_jvp_of_vjp(primals, tangents, 4))
    want = torch.func.jvp(lambda *a: chunked.ssd_scan_vjp(*a, chunk),
                          tuple(p), tuple(t))[1]
    assert_close(got, want)


@pytest.mark.parametrize("zero_gs", [False, True], ids=["gs", "gs-zero"])
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_tangent_on_ragged_and_single_chunks(edge, zero_gs):
    _, B, L, H, P, N, G, chunk = edge
    primals, tangents = _inputs(70 + L + zero_gs, B=B, L=L, H=H, P=P, N=N,
                                G=G, per_sequence_A=chunk == 48,
                                zero_gs=zero_gs)
    got = _compose_tangent(_torch(primals), _torch(tangents), chunk)
    assert_close(got, _jax_jvp_of_vjp(primals, tangents, H))


def test_tangent_stays_finite_where_seg_falls_past_88():
    primals, tangents = _steep(80)
    got = _compose_tangent(_torch(primals), _torch(tangents), 256)
    assert all(torch.isfinite(g).all() for g in got)
    assert_close(got, _jax_jvp_of_vjp(primals, tangents, 2),
                 dA_rel=STEEP_DA_REL)


@pytest.mark.parametrize("G", [1, 2])
def test_wrappers_in_bfloat16_against_the_reference(G):
    """bf16 x, B, C and gy through the wrappers (on CPU tensors, the plain
    versions): the backward and its tangent against the per-step reference
    on the same bf16-rounded inputs, within the bf16 limits."""
    primals, tangents = _inputs(90 + G, L=128, G=G, per_sequence_A=True)
    p, t = _torch(primals, torch.bfloat16), _torch(tangents, torch.bfloat16)
    rounded = [a.float().numpy() for a in p]
    got = ops.ssd_scan_bwd(*p, chunk=32)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    assert_close(got, _jax_vjp(rounded, 4), torch.bfloat16)
    tg = ops.ssd_scan_bwd_tangent(*p, *t, chunk=32)
    assert [g.dtype for g in tg] == [g.dtype for g in got]
    assert_close(tg, _jax_jvp_of_vjp(rounded, [a.float().numpy() for a in t],
                                     4), torch.bfloat16)


def test_composites_and_pass_wrappers_agree():
    """On CPU tensors ``ssd_scan_bwd`` and ``ssd_scan_bwd_tangent`` compose
    the pass wrappers, which are the plain versions; the autograd pairing
    (``_chunked_vjp``) keeps the chunked VJP and counts no launch."""
    primals, tangents = _inputs(100, L=64, G=2, per_sequence_A=True)
    p, t = _torch(primals), _torch(tangents)
    ops.reset_launch_counts()
    for a, b in zip(ops.ssd_scan_bwd(*p, chunk=32),
                    _compose(p, 32, through_wrappers=True)):
        assert torch.equal(a, b)
    for a, b in zip(ops.ssd_scan_bwd_tangent(*p, *t, chunk=32),
                    _compose_tangent(p, t, 32, through_wrappers=True)):
        assert torch.equal(a, b)
    for a, b in zip(ops._chunked_vjp(*p, 32),
                    chunked.ssd_scan_vjp(*p, 32)):
        assert torch.equal(a, b)
    assert not any(ops.launch_counts.values())


def test_tangent_passes_carry_the_backward_passes():
    """The value planes of the tangent's passes are the backward's own."""
    primals, tangents = _inputs(101, L=64)
    p, t = _torch(primals), _torch(tangents)
    S, tS, Lc, tLc, seg, tseg = ref.tangent_bwd_state_ref(*p[:6], *t[:6], 32)
    for a, b in zip((S, Lc, seg), ref.bwd_state_ref(*p[:6], 32)):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    s_in, _, gO, _, sg, _ = ref.tangent_bwd_state_pass_ref(
        S, tS, Lc, tLc, seg, tseg, p[6], t[6], 32)
    for a, b in zip((s_in, gO, sg), ref.bwd_state_pass_ref(S, Lc, seg, p[6],
                                                           32)):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def _by_chunk_dA(p, chunk, drop=None):
    """dA as the sum of each chunk's own term (the plain pass 3 on one
    chunk at a time), leaving out chunk ``drop``."""
    x, dt, A, Bm, Cm, gy, gs = p
    S, Lc, seg = ref.bwd_state_ref(x, dt, A, Bm, Cm, gy, chunk)
    s_in, gO, sg = ref.bwd_state_pass_ref(S, Lc, seg, gs, chunk)
    total = torch.zeros_like(A)
    for c in range(x.shape[1] // chunk):
        if c == drop:
            continue
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + ref.bwd_chunk_ref(
            x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], gy[:, sl],
            seg[:, :, sl].contiguous(), s_in[:, c:c + 1], gO[:, c:c + 1],
            sg[:, :, c:c + 1], chunk)[2]
    return total


FAULTS = ("state cotangent not carried", "dA without one chunk",
          "dB not summed over a group")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_backward_faults_fail_the_check(fault):
    """Each planted fault (as chip_smoke.py plants them in the kernels'
    outputs) falls outside the float32 limit of the reference's gradient;
    the chunk-by-chunk dA with no chunk dropped stays inside."""
    primals, _ = _inputs(110, L=128, H=4, G=2, per_sequence_A=True)
    p = _torch(primals)
    want = _jax_vjp(primals, 4)
    x, dt, A, Bm, Cm, gy, gs = p
    if fault == "dA without one chunk":
        assert outside(_by_chunk_dA(p, 32), want[2])[0] == 0
        bad, which = _by_chunk_dA(p, 32, drop=1), 2
    elif fault == "dB not summed over a group":
        first = torch.zeros(4, dtype=torch.bool)
        first[::2] = True                    # the first head of each group
        keep = lambda t, dim: t * first.view([-1 if i == dim else 1 for i in
                                              range(t.ndim)])
        bad, which = _compose([x, dt, A, Bm, Cm, keep(gy, 2),
                               keep(gs, 1)], 32)[3], 3
    else:
        S, Lc, seg = ref.bwd_state_ref(*p[:6], 32)
        s_in, gO, sg = ref.bwd_state_pass_ref(S, Lc, seg, gs, 32)
        gO = torch.cat([torch.zeros_like(gO[:, :-1]), gO[:, -1:]], 1)
        bad, which = ref.bwd_chunk_ref(*p[:6], seg, s_in, gO,
                                       (s_in * gO).sum((-2, -1)).transpose(
                                           1, 2), 32)[0], 0
    assert outside(bad, want[which])[0] > 0


def test_backward_wrappers_check_their_shapes_and_device():
    primals, tangents = _inputs(120, L=64)
    p, t = _torch(primals), _torch(tangents)
    x, dt, A, Bm, Cm, gy, gs = p
    S, Lc, seg = ops.ssd_bwd_state(x, dt, A, Bm, Cm, gy, chunk=32)
    assert S.shape == Lc.shape == (2, 2, 4, 16, 32)
    assert seg.shape == (2, 4, 64)
    s_in, gO, sg = ops.ssd_bwd_pass(S, Lc, seg, gs, chunk=32)
    assert s_in.shape == gO.shape == S.shape and sg.shape == (2, 4, 2)
    dx, ddt, dA, dB, dC = ops.ssd_bwd_chunk(x, dt, A, Bm, Cm, gy, seg, s_in,
                                            gO, sg, chunk=32)
    assert (dx.shape, ddt.shape, dA.shape, dB.shape, dC.shape) == (
        x.shape, dt.shape, A.shape, Bm.shape, Cm.shape)
    with pytest.raises(ValueError, match="gy"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, gy[:, :32], gs, chunk=32)
    with pytest.raises(ValueError, match="gs"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gs[..., :16], chunk=32)
    with pytest.raises(ValueError, match="do not fit S"):
        ops.ssd_bwd_pass(S, Lc, seg[:, :, :32], gs, chunk=32)
    with pytest.raises(ValueError, match="do not fit x"):
        ops.ssd_bwd_chunk(x, dt, A, Bm, Cm, gy, seg, s_in[:, :1], gO, sg,
                          chunk=32)
    with pytest.raises(ValueError, match="A'"):
        ops.ssd_scan_bwd_tangent(*p, *t[:2], t[2][:2], *t[3:], chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gs, chunk=48)
    meta = [a.to("meta") for a in p]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd_scan_bwd(*meta, chunk=32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd_scan_bwd_tangent(*meta, *meta, chunk=32)
