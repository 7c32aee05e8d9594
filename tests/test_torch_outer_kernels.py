"""The grouped outer-update path on CPU: one call over a dict of ragged
(K, ...) leaves of mixed dtypes (what ``core/fused.py`` and the ``pallas``
combine now call), against the per-leaf plain versions (exactly) and
against the JAX package's Pallas kernels on each leaf in interpret mode;
and the schedule row and gate derived from a step tensor against the host
step's.  The CUDA kernels are held against these plain versions in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dif_combine.dif_combine import dif_combine as jax_combine
from repro.kernels.dif_combine.ops import fused_update_flat
from repro_torch.core import update
from repro_torch.kernels.dif_combine import ops, ref

K = 6
WIDTHS = (1, 40, 1001, 1600)
BLOCK = 128          # the reference's block; each leaf is padded to it
# float32: the same f32 products and quotients, the K terms of a mix summed
# in another order (ulps of values of order 1, so an atol beside rtol for
# outputs near zero); bfloat16: rounded to bf16 after that, one ulp apart.
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _leaves(rng, dtypes=(torch.float32, torch.bfloat16)):
    """One leaf per width and dtype, from numpy; a 3-d one among them."""
    out = {}
    for dt in dtypes:
        for m in WIDTHS:
            shape = (K, 40, 40) if m == 1600 else (K, m)
            out[f"{str(dt)[6:]}_{m}"] = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(dt)
    return out


def _pad(x: torch.Tensor) -> jnp.ndarray:
    """(K, ...) leaf -> (K, m) zero-padded to the reference's block."""
    flat = x.reshape(K, -1).float().numpy()
    m = flat.shape[1]
    pad = np.zeros((K, -(-m // BLOCK) * BLOCK), np.float32)
    pad[:, :m] = flat
    return jnp.asarray(pad, JDT[x.dtype])


def _close_to_jax(got: torch.Tensor, want, name):
    m = got[0].numel()
    np.testing.assert_allclose(
        got.reshape(K, m).float().numpy(),
        np.asarray(jnp.asarray(want, jnp.float32))[:, :m],
        err_msg=name, **TOL[got.dtype])


def test_grouped_combine_matches_per_leaf_and_reference():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.random((K, K)).astype(np.float32))
    leaves = _leaves(rng)
    got = ops.dif_combine_leaves(A, leaves)
    assert list(got) == list(leaves)
    for k, x in leaves.items():
        assert got[k].shape == x.shape and got[k].dtype == x.dtype
        assert torch.equal(got[k], ref.dif_combine_ref(
            A, x.reshape(K, -1)).reshape(x.shape)), k
        want = jax_combine(jnp.asarray(A.numpy()), _pad(x), block_m=BLOCK,
                           interpret=True)
        _close_to_jax(got[k], want, k)


def _moments(rng, kind, params):
    """(mu, nu): fp32 for adam, the velocity in the param dtype for
    momentum, none for sgd."""
    draw = lambda f, p: torch.from_numpy(f(p.shape).astype(np.float32))
    if kind == "adam":
        return ({k: draw(lambda s: 0.1 * rng.normal(size=s), p)
                 for k, p in params.items()},
                {k: draw(lambda s: 0.01 * rng.random(s), p)
                 for k, p in params.items()})
    if kind == "momentum":
        return ({k: draw(lambda s: rng.normal(size=s), p).to(p.dtype)
                 for k, p in params.items()}, None)
    return None, None


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("step", [0, 1], ids=["gate0", "gate1"])
@pytest.mark.parametrize("mode", ops.MODES)
@pytest.mark.parametrize("kind", ops.KINDS)
def test_grouped_fused_update_matches_per_leaf_and_reference(kind, mode,
                                                             step, S):
    """combine_every=2: step 0 keeps the identity (gate 0), step 1 mixes
    with row 1 % S (gate 1).  Clip scale, adamw decay and Adam's count as
    the trainer passes them."""
    rng = np.random.default_rng(
        [ops.KINDS.index(kind), ops.MODES.index(mode), step, S])
    table = torch.from_numpy(rng.random((S, K, K)).astype(np.float32))
    scale = torch.from_numpy(rng.random((K, 1)).astype(np.float32))
    params = _leaves(rng)
    grads = _leaves(rng)
    mu, nu = _moments(rng, kind, params)
    count = torch.tensor(3, dtype=torch.int32)
    hyper = dict(mode=mode, kind=kind, lr=1e-2,
                 weight_decay=0.05 * (kind == "adam"))
    got = ops.fused_combine_update_leaves(
        table, scale, params, grads, mu, nu, step=step, every=2,
        count=count if kind == "adam" else None, **hyper)
    sel = torch.tensor([[step % S]], dtype=torch.int32)
    bc1, bc2 = (1 - 0.9 ** torch.tensor(4.0), 1 - 0.999 ** torch.tensor(4.0))
    ctl = torch.stack([torch.tensor(float(step % 2 == 1)), bc1, bc2]
                      ).reshape(1, 3)
    for k, p in params.items():
        flat = lambda t: None if t is None else t[k].reshape(K, -1)
        per_leaf = ref.fused_update_ref(table, sel, ctl, scale, flat(params),
                                        flat(grads), flat(mu), flat(nu),
                                        **hyper)
        moments = [x for x in (mu, nu) if x is not None]
        want = fused_update_flat(
            jnp.asarray(table.numpy()), jnp.asarray(sel.numpy()),
            jnp.asarray(ctl.numpy()), jnp.asarray(scale.numpy()),
            _pad(p), _pad(grads[k]), *(_pad(x[k]) for x in moments),
            block_m=BLOCK, interpret=True, **hyper)
        for name, tree, one, jx in zip(("w", "mu", "nu"), got, per_leaf,
                                       want):
            assert (tree is None) == (one is None) == (jx is None), name
            if one is None:
                continue
            assert tree[k].shape == p.shape, (name, k)
            assert torch.equal(tree[k].reshape(K, -1), one), (name, k)
            _close_to_jax(tree[k], jx, f"{name}[{k}]")


@pytest.mark.parametrize("S,every", [(1, 1), (3, 2), (4, 3)])
def test_step_tensor_selects_the_host_steps_row_and_gate(S, every):
    """Over 12 steps, a 0-d step tensor gives the row ``step % S`` and the
    CommSchedule gate of the host step, and the same update."""
    rng = np.random.default_rng(S)
    comm = update.CommSchedule(every)
    table = torch.from_numpy(rng.random((S, K, K)).astype(np.float32))
    params = _leaves(rng, dtypes=(torch.float32,))
    grads = _leaves(rng, dtypes=(torch.float32,))
    for i in range(12):
        for step in (i, torch.tensor(i), torch.tensor(i, dtype=torch.int32)):
            sel, ctl = ref.step_control(step, S, every)
            assert int(sel) == i % S
            assert float(ctl[0, 0]) == float(comm.is_comm_step(i))
        host = ops.fused_combine_update_leaves(
            table, None, params, grads, step=i, every=every, kind="sgd",
            lr=0.1)[0]
        dev = ops.fused_combine_update_leaves(
            table, None, params, grads, step=torch.tensor(i), every=every,
            kind="sgd", lr=0.1)[0]
        for k in params:
            assert torch.equal(host[k], dev[k]), (i, k)


def test_grouped_wrappers_check_their_leaves():
    x = {"a": torch.ones(K, 4), "b": torch.ones(K + 1, 4)}
    with pytest.raises(ValueError, match="leading agent axis"):
        ops.dif_combine_leaves(torch.eye(K), x)
    p = {"a": torch.ones(K, 4)}
    with pytest.raises(ValueError, match="step count"):
        ops.fused_combine_update_leaves(torch.eye(K)[None], None, p, p,
                                        {"a": torch.zeros(K, 4)},
                                        {"a": torch.zeros(K, 4)}, step=0,
                                        kind="adam", lr=0.1)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_combine_update_leaves(
            torch.eye(K)[None], None, p, p, {"a": torch.zeros(K, 4).double()},
            {"a": torch.zeros(K, 4)}, step=0, count=torch.tensor(0),
            kind="adam", lr=0.1)
