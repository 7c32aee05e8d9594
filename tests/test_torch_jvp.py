"""Forward-over-reverse — ``torch.func.jvp`` of ``torch.func.grad``, the
exact meta-gradient's Hessian-vector product — through the kernels'
``autograd.Function``s, against ``jax.jvp(jax.grad(...))`` of the JAX
package's oracles, under ``vmap(vmap(...))`` (agents × tasks, the
meta-gradient's nesting).

On CPU tensors each wrapper runs its plain version, inside the same
forward, backward and tangent ``Function``s (and their ``jvp`` and
``vmap`` rules) that the card runs, so this exercises the forward-mode
plumbing; the tangent kernels themselves are held against these plain
versions in test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._C._functorch import is_batchedtensor, is_gradtrackingtensor

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.ssd_scan import ops as sops

# float32 on both sides; a Hessian-vector product is the same sums in
# another order: within 1e-5 of the largest |value| of each result.
HVP_REL = 1e-5
N_AGENTS, N_TASKS = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _hvps(loss_t, loss_j, params, batch, tangents):
    """The port's and the reference's vmap(vmap(jvp(grad))) on the same
    numpy params (unmapped), per-(agent, task) batches and tangents."""
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def t_one(b, t):
        return torch.func.jvp(lambda p: torch.func.grad(loss_t)(p, b),
                              (tp,), (t,))[1]

    def j_one(b, t):
        return jax.jvp(lambda p: jax.grad(loss_j)(p, b), (jp,), (t,))[1]

    got = torch.func.vmap(torch.func.vmap(t_one))(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in tangents.items()})
    want = jax.vmap(jax.vmap(j_one))(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in tangents.items()})
    return got, want


def _assert_hvp_close(got, want):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        err = np.abs(g - w).max()
        assert err <= HVP_REL * np.abs(w).max(), (k, err, np.abs(w).max())


def _attention_loss(out, w):
    return (out * w).sum() + 0.5 * (out ** 2).sum()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)],
                         ids=["causal", "window8", "full"])
def test_flash_forward_over_reverse_matches_jax(causal, window):
    """``flash_attention`` (B, H, S, d) against ``attention_ref``."""
    rng = np.random.default_rng(0)
    B, H, S, D = 1, 2, 32, 16
    params = {n: _draw(rng, B, H, S, D) for n in "qkv"}
    lead = (N_AGENTS, N_TASKS)
    batch = {"w": _draw(rng, *lead, B, H, S, D)}
    tangents = {n: _draw(rng, *lead, B, H, S, D) for n in "qkv"}

    def loss_t(p, b):
        return _attention_loss(ops.flash_attention(
            p["q"], p["k"], p["v"], causal=causal, window=window), b["w"])

    def loss_j(p, b):
        return _attention_loss(jax_attention(
            p["q"], p["k"], p["v"], causal=causal, window=window), b["w"])

    _assert_hvp_close(*_hvps(loss_t, loss_j, params, batch, tangents))


@pytest.mark.parametrize("causal,window,S,Sk",
                         [(True, None, 32, 32), (True, 8, 32, 32),
                          (False, None, 32, 32), (False, None, 16, 40)],
                         ids=["causal", "window8", "full", "cross-16x40"])
def test_gqa_forward_over_reverse_matches_jax_in_model_layout(causal,
                                                              window, S,
                                                              Sk):
    """``gqa_flash_attention`` in the model's layout, q (B, S, H, d) and
    K/V (B, S_k, KV, d) unexpanded, against ``attention_ref`` of the heads
    repeated as the reference's models repeat them; the cross case (16
    queries against 40 keys, non-causal, the shapes whisper's cross block
    gives T1 and T2) against ``layers.sdpa`` as the reference's
    ``attention_apply`` calls it with ``kv_x``."""
    rng = np.random.default_rng(1)
    B, H, KV, D = 1, 4, 2, 16
    params = {"q": _draw(rng, B, S, H, D), "k": _draw(rng, B, Sk, KV, D),
              "v": _draw(rng, B, Sk, KV, D)}
    lead = (N_AGENTS, N_TASKS)
    batch = {"w": _draw(rng, *lead, B, S, H, D)}
    tangents = {n: _draw(rng, *lead, *params[n].shape) for n in params}

    def loss_t(p, b):
        return _attention_loss(ops.gqa_flash_attention(
            p["q"], p["k"], p["v"], causal=causal, window=window), b["w"])

    def loss_j(p, b):
        if S != Sk:
            k, v = (jax_layers._expand_kv(p[n], H) for n in "kv")
            out = jax_layers.sdpa(p["q"], k, v, 1.0 / np.sqrt(D),
                                  causal=False, window=None)
            return _attention_loss(out, b["w"])
        heads = lambda t: jnp.repeat(t, H // KV, axis=2).transpose(0, 2, 1, 3)
        out = jax_attention(p["q"].transpose(0, 2, 1, 3), heads(p["k"]),
                            heads(p["v"]), causal=causal, window=window)
        return _attention_loss(out.transpose(0, 2, 1, 3), b["w"])

    _assert_hvp_close(*_hvps(loss_t, loss_j, params, batch, tangents))


def _ssd_params(rng, B, L, H, P, G, N):
    return {"x": _draw(rng, B, L, H, P),
            "dt": (np.logaddexp(_draw(rng, B, L, H), 0) * 0.5
                   ).astype(np.float32),
            "a_log": _draw(rng, H, scale=0.3),
            "B": _draw(rng, B, L, G, N, scale=0.3),
            "C": _draw(rng, B, L, G, N, scale=0.3)}


def _ssd_loss(y, s, w):
    return (y * w).sum() + 0.5 * (y ** 2).sum() + 0.1 * (s ** 2).sum()


@pytest.mark.parametrize("per_sequence_A", [False, True],
                         ids=["A-shared", "A-per-sequence"])
def test_ssd_forward_over_reverse_matches_jax(per_sequence_A):
    """``ssd_scan`` (plain forward, chunked-VJP backward, and their tangent
    Functions) against the per-step ``ssd_scan_ref``, B and C read by
    group; A = -exp(a_log) (H,) shared by the sequences, or one row a
    sequence (B, H)."""
    rng = np.random.default_rng(2)
    B, L, H, P, G, N, chunk = 2, 32, 2, 4, 1, 8, 16
    params = _ssd_params(rng, B, L, H, P, G, N)
    scales = np.array([[1.0], [0.5]], np.float32)       # per sequence
    lead = (N_AGENTS, N_TASKS)
    batch = {"w": _draw(rng, *lead, B, L, H, P)}
    tangents = {n: _draw(rng, *lead, *v.shape, scale=0.5)
                for n, v in params.items()}

    def A_of(a_log, exp, lib):
        A = -exp(a_log)
        return A[None] * lib(scales) if per_sequence_A else A

    def loss_t(p, b):
        y, s = sops.ssd_scan(p["x"], p["dt"],
                             A_of(p["a_log"], torch.exp, torch.from_numpy),
                             p["B"], p["C"], chunk=chunk)
        return _ssd_loss(y, s, b["w"])

    def loss_j(p, b):
        rep = lambda t: jnp.repeat(t, H // G, axis=2)
        y, s = jax_ssd_scan_ref(p["x"], p["dt"],
                                A_of(p["a_log"], jnp.exp, jnp.asarray),
                                rep(p["B"]), rep(p["C"]))
        return _ssd_loss(y, s, b["w"])

    _assert_hvp_close(*_hvps(loss_t, loss_j, params, batch, tangents))


def _spy(seen, name, fn):
    def wrapped(*args, **kw):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        seen.append((name, tuple(ts[0].shape),
                     any(is_batchedtensor(t) or is_gradtrackingtensor(t)
                         for t in ts)))
        return fn(*args, **kw)
    return wrapped


def test_tangent_entry_points_see_folded_plain_tensors(monkeypatch):
    """What the card needs: under ``vmap(vmap(jvp(grad)))`` every launch
    entry — forward, backward, and both tangents — is called with plain
    tensors (a raw-pointer launch cannot read a batched, dual or
    grad-tracking one) whose batch holds both mapped dims folded in."""
    seen = []
    for name in ("gqa_flash_attention_fwd_lse", "gqa_flash_attention_bwd",
                 "flash_attention_fwd_tangent",
                 "flash_attention_bwd_tangent"):
        monkeypatch.setattr(ops, name, _spy(seen, name, getattr(ops, name)))
    for name in ("ssd_scan_kernel", "_chunked_vjp", "ssd_scan_tangent",
                 "_chunked_vjp_tangent"):
        monkeypatch.setattr(sops, name, _spy(seen, name,
                                             getattr(sops, name)))
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 1, 16, 2, 1, 8
    attn = {"q": _draw(rng, B, S, H, D), "k": _draw(rng, B, S, KV, D),
            "v": _draw(rng, B, S, KV, D)}
    ssd = _ssd_params(rng, 1, 16, 2, 4, 1, 8)
    lead = (N_AGENTS, N_TASKS)
    for params, loss in (
            (attn, lambda p, m: (ops.gqa_flash_attention(
                p["q"] * m, p["k"], p["v"]) ** 2).sum()),
            (ssd, lambda p, m: (sops.ssd_scan(
                p["x"] * m, p["dt"], -torch.exp(p["a_log"]), p["B"], p["C"],
                chunk=8)[0] ** 2).sum())):
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        tangents = {k: torch.from_numpy(_draw(rng, *lead, *v.shape))
                    for k, v in params.items()}
        mult = torch.from_numpy(_draw(rng, *lead, 1))   # per (agent, task)
        torch.func.vmap(torch.func.vmap(lambda m, t: torch.func.jvp(
            lambda p: torch.func.grad(loss)(p, m), (tp,), (t,))[1]))(
                mult, tangents)
    n = N_AGENTS * N_TASKS
    fq, sx = (n * B, S, H, D), (n, 16, 2, 4)
    assert sorted(seen) == sorted([
        ("gqa_flash_attention_fwd_lse", fq, False),
        ("flash_attention_fwd_tangent", fq, False),
        ("gqa_flash_attention_bwd", fq, False),
        ("flash_attention_bwd_tangent", fq, False),
        ("ssd_scan_kernel", sx, False), ("ssd_scan_tangent", sx, False),
        ("_chunked_vjp", sx, False), ("_chunked_vjp_tangent", sx, False)])


def test_reverse_over_reverse_still_raises():
    """grad of grad reaches the backward Functions' ``backward``, which
    raises; the message names both modes."""
    q = torch.randn(1, 8, 2, 4)
    with pytest.raises(RuntimeError, match="reverse-over-reverse"):
        torch.func.grad(lambda q: torch.func.grad(
            lambda q: ops.gqa_flash_attention(q, q, q).pow(2).sum())(q)
            .sum())(q)
    x = torch.randn(1, 8, 2, 4)
    dt, A, Bm = torch.rand(1, 8, 2), -torch.ones(2), torch.randn(1, 8, 1, 4)
    with pytest.raises(RuntimeError, match="reverse-over-reverse"):
        torch.func.grad(lambda x: torch.func.grad(
            lambda x: sops.ssd_scan(x, dt, A, Bm, Bm, chunk=8)[0].pow(2)
            .sum())(x).sum())(x)
