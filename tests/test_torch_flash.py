"""The flash-attention kernels' plain versions and their autograd pairing,
against the JAX package's Pallas kernels run in interpret mode.

On CPU tensors the port's wrappers compute with the plain versions inside
the same ``torch.autograd.Function`` the card runs, so its autograd and
``torch.func`` plumbing (``vmap`` over ``grad``, the serving tier's batched
adaptation) is exercised here.  The CUDA kernels themselves are held
against these plain versions in test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_fwd_lse as jax_fwd_lse)
from repro.kernels.flash_attention.flash_bwd import (
    flash_attention_bwd as jax_bwd)
from repro.kernels.flash_attention.ops import (
    gqa_flash_attention as jax_gqa)
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.fold import fold

# float32 throughout: the same products summed in another order (blocked
# online softmax against one softmax), a few ulps of values of order 1.
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
MASKS = [(True, None), (False, None), (True, 16)]
IDS = ["causal", "full", "window16"]
B, H, S, D = 1, 2, 64, 32
BLOCK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(4)]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module", params=list(zip(MASKS, IDS)),
                ids=IDS)
def case(request):
    """One mask: numpy inputs and the Pallas kernels' outputs on them."""
    (causal, window), name = request.param
    q, k, v, do = _inputs(IDS.index(name))
    kw = dict(causal=causal, window=window, block_q=BLOCK, block_k=BLOCK,
              interpret=True)
    out, lse = jax_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    grads = jax_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                    lse[..., 0], jnp.asarray(do), **kw)
    return dict(causal=causal, window=window, q=q, k=k, v=v, do=do,
                out=np.asarray(out), lse=np.asarray(lse),
                grads=[np.asarray(g) for g in grads])


def test_attention_ref_matches_pallas_forward(case):
    got = ref.attention_ref(_t(case["q"]), _t(case["k"]), _t(case["v"]),
                            causal=case["causal"], window=case["window"])
    np.testing.assert_allclose(got.numpy(), case["out"], **FWD_TOL)


def test_fwd_lse_matches_pallas_forward(case):
    """The wrapper on CPU tensors: out and the per-row logsumexp, with the
    JAX package's (B, H, S, 1) lse layout; no kernel launch is counted."""
    before = dict(ops.launch_counts)
    out, lse = ops.flash_attention_fwd_lse(
        _t(case["q"]), _t(case["k"]), _t(case["v"]), causal=case["causal"],
        window=case["window"])
    assert tuple(lse.shape) == (B, H, S, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), case["out"], **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), case["lse"], **FWD_TOL)
    assert ops.launch_counts == before


def test_bwd_matches_pallas_backward(case):
    q, k, v, do = (_t(case[n]) for n in ("q", "k", "v", "do"))
    lse = _t(case["lse"])[..., 0]
    got = ops.flash_attention_bwd(q, k, v, _t(case["out"]), lse, do,
                                  causal=case["causal"],
                                  window=case["window"])
    for g, want in zip(got, case["grads"]):
        np.testing.assert_allclose(g.numpy(), want, **BWD_TOL)


def test_function_gradient_matches_pallas_and_ref_autograd(case):
    """The ``flash_attention`` Function under plain autograd: forward as
    the Pallas kernel, gradients as the Pallas backward and as autograd
    through ``attention_ref``."""
    kw = dict(causal=case["causal"], window=case["window"])
    leaves = [_t(case[n]).requires_grad_() for n in ("q", "k", "v")]
    out = ops.flash_attention(*leaves, **kw)
    out.backward(_t(case["do"]))
    np.testing.assert_allclose(out.detach().numpy(), case["out"], **FWD_TOL)
    plain = [_t(case[n]).requires_grad_() for n in ("q", "k", "v")]
    ref.attention_ref(*plain, **kw).backward(_t(case["do"]))
    for got, p, want in zip(leaves, plain, case["grads"]):
        np.testing.assert_allclose(got.grad.numpy(), want, **BWD_TOL)
        np.testing.assert_allclose(got.grad.numpy(), p.grad.numpy(),
                                   **BWD_TOL)


@pytest.mark.parametrize("mapped", ["all", "q_only"])
def test_vmap_over_grad_through_the_function(mapped):
    """``torch.func.vmap(torch.func.grad(...))`` through the Function (its
    vmap rule folds the mapped dim into the batch, for the forward and for
    the backward) equals per-element autograd through ``attention_ref``,
    with mapped and unmapped inputs."""
    rng = np.random.default_rng(7)
    N = 3
    xs = _t(rng.standard_normal((N, B, H, S, D)))
    q, k, v = (_t(a) for a in _inputs(11)[:3])

    def loss(fn, q, k, v, x):
        return (fn(q * x, k, v) ** 2).sum()

    flash = lambda q, k, v: ops.flash_attention(q, k, v, True, 16)
    plain = lambda q, k, v: ref.attention_ref(q, k, v, causal=True,
                                              window=16)
    if mapped == "all":
        ks, vs = (_t(rng.standard_normal((N, B, H, S, D))) for _ in "kv")
        in_dims = (None, 0, 0, 0)
    else:
        ks, vs = k, v
        in_dims = (None, None, None, 0)
    got = torch.func.vmap(torch.func.grad(
        lambda *a: loss(flash, *a), argnums=(0, 1, 2)),
        in_dims=in_dims)(q, ks, vs, xs)
    for i in range(N):
        leaves = [t.clone().requires_grad_() for t in
                  (q, ks[i] if mapped == "all" else k,
                   vs[i] if mapped == "all" else v)]
        loss(plain, *leaves, xs[i]).backward()
        for g, leaf in zip(got, leaves):
            np.testing.assert_allclose(g[i].numpy(), leaf.grad.numpy(),
                                       **BWD_TOL)


def test_kernels_see_folded_plain_tensors_under_vmap_of_grad(monkeypatch):
    """What the card needs: under ``vmap(grad(...))`` the wrappers are
    called with plain tensors (a raw-pointer launch cannot read a batched
    or grad-tracking one) whose batch holds the mapped dim folded in."""
    from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor
    seen = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            seen.append((name, tuple(ts[0].shape),
                         any(is_batchedtensor(t) or is_gradtrackingtensor(t)
                             for t in ts)))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "_fwd", spy("fwd", ops._fwd))
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        spy("bwd", ops.flash_attention_bwd))
    q, k, v = (_t(a) for a in _inputs(9)[:3])
    xs = _t(np.random.default_rng(9).standard_normal((3, B, H, S, D)))
    torch.func.vmap(torch.func.grad(
        lambda q, x: (ops.flash_attention(q * x, k, v) ** 2).sum()),
        in_dims=(None, 0))(q, xs)
    assert seen == [("fwd", (3 * B, H, S, D), False),
                    ("bwd", (3 * B, H, S, D), False)]


def test_gqa_wrapper_expands_heads_in_model_layout():
    """(B, S, H, d) queries with (B, S, KV, d) keys/values: the JAX
    package's GQA wrapper semantics."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, 2, D)).astype(np.float32)
            for _ in "kv")
    got = ops.gqa_flash_attention(_t(q), _t(k), _t(v), causal=True)
    kk, vv = (np.repeat(a, 2, axis=2) for a in (k, v))
    want = ref.attention_ref(*(_t(a).transpose(1, 2) for a in (q, kk, vv)),
                             causal=True).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_second_order_and_bad_shapes_raise():
    q, k, v = (_t(a) for a in _inputs(5)[:3])
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.func.grad(lambda q: torch.func.grad(
            lambda q: ops.flash_attention(q, k, v).pow(2).sum())(q).sum())(q)
    with pytest.raises(ValueError, match="expand GQA heads"):
        ops.flash_attention(q, k[:, :1], v[:, :1])
    out, lse = ops.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match=r"lse has shape \(1, 2, 64, 1\)"):
        ops.flash_attention_bwd(q, k, v, out, lse, out)


# The model layout with KV heads not expanded: q (B, S, H, d), k/v (B, S,
# KV, d), against the JAX package's GQA wrapper (Pallas forward in interpret
# mode, its recompute backward), which expands the heads and so sums each
# KV head's gradient over its query heads.
GQA_GROUPS = [(4, 2), (4, 1)]


@pytest.fixture(scope="module", params=[(g, m) for g in GQA_GROUPS
                                        for m in zip(MASKS, IDS)],
                ids=[f"H{h}KV{kv}-{name}" for h, kv in GQA_GROUPS
                     for name in IDS])
def gqa_case(request):
    (H, KV), ((causal, window), name) = request.param
    rng = np.random.default_rng(100 + 10 * KV + IDS.index(name))
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in "qo")
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in "kv")
    out, vjp = jax.vjp(
        lambda q, k, v: jax_gqa(q, k, v, causal=causal, window=window,
                                block_q=BLOCK, block_k=BLOCK,
                                interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    return dict(causal=causal, window=window, q=q, k=k, v=v, do=do,
                out=np.asarray(out), grads=[np.asarray(g) for g in grads])


def test_gqa_forward_matches_pallas_with_unexpanded_kv(gqa_case):
    """The model-layout Function on (B, S, KV, d) K/V; the plain version
    it runs on CPU tensors launches nothing."""
    before = dict(ops.launch_counts)
    got = ops.gqa_flash_attention(
        _t(gqa_case["q"]), _t(gqa_case["k"]), _t(gqa_case["v"]),
        causal=gqa_case["causal"], window=gqa_case["window"])
    assert got.shape == gqa_case["q"].shape
    np.testing.assert_allclose(got.numpy(), gqa_case["out"], **FWD_TOL)
    assert ops.launch_counts == before


def test_gqa_gradients_match_pallas_summed_per_kv_head(gqa_case):
    """dq (B, S, H, d), dk and dv (B, S, KV, d), each KV head's summed
    over its query heads, as the reference's expansion gives them."""
    leaves = [_t(gqa_case[n]).requires_grad_() for n in ("q", "k", "v")]
    out = ops.gqa_flash_attention(*leaves, causal=gqa_case["causal"],
                                  window=gqa_case["window"])
    out.backward(_t(gqa_case["do"]))
    for leaf, want in zip(leaves, gqa_case["grads"]):
        assert leaf.grad.shape == want.shape
        np.testing.assert_allclose(leaf.grad.numpy(), want, **BWD_TOL)


def test_gqa_kernels_see_folded_unexpanded_tensors_under_vmap_of_grad(
        monkeypatch):
    """Under ``vmap(grad(...))`` the model-layout wrappers get plain
    tensors with the mapped dim folded into the batch, and K/V with their KV
    heads, not H; the folded batch is a view of the mapped tensor."""
    from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor
    seen = []

    def spy(name, fn):
        def wrapped(q, k, v, *args, **kw):
            ts = [q, k, v] + [a for a in args if isinstance(a, torch.Tensor)]
            seen.append((name, tuple(q.shape), tuple(k.shape),
                         any(is_batchedtensor(t) or is_gradtrackingtensor(t)
                             for t in ts)))
            return fn(q, k, v, *args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "gqa_flash_attention_fwd_lse",
                        spy("fwd", ops.gqa_flash_attention_fwd_lse))
    monkeypatch.setattr(ops, "gqa_flash_attention_bwd",
                        spy("bwd", ops.gqa_flash_attention_bwd))
    rng = np.random.default_rng(21)
    N, H, KV = 3, 4, 2
    q = _t(rng.standard_normal((B, S, H, D)))
    ks, vs = (_t(rng.standard_normal((N, B, S, KV, D))) for _ in "kv")
    xs = _t(rng.standard_normal((N, B, S, H, D)))
    folded = fold(ks, 0, N)
    assert folded.data_ptr() == ks.data_ptr()
    torch.func.vmap(torch.func.grad(
        lambda q, k, v, x: (ops.gqa_flash_attention(q * x, k, v) ** 2
                            ).sum(), argnums=(0, 1, 2)),
        in_dims=(None, 0, 0, 0))(q, ks, vs, xs)
    assert seen == [("fwd", (N * B, S, H, D), (N * B, S, KV, D), False),
                    ("bwd", (N * B, S, H, D), (N * B, S, KV, D), False)]
