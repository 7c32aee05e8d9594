"""The port's optimizers against ``repro.optim`` on one ragged, mixed-dtype
tree: the same numpy params and gradients, N update steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.optim import clip_by_global_norm, get_optimizer

STEPS = 5
# f32 leaves: both sides evaluate the same expressions in f32; the last
# ulps differ where XLA and torch pick other pow/sqrt/reduction orders.
# bf16 leaves: such a one-ulp f32 difference can flip one bf16 rounding
# (an ulp of bf16 is 2^-8 relative).
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6),
       jnp.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def _tree(rng):
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16),
                  "d": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("clip", [None, 1.0, 0.0])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_update_steps_match_reference(name, clip):
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(jnp.asarray, _tree(rng))
    grads = [jax.tree.map(jnp.asarray, _tree(rng)) for _ in range(STEPS)]
    jopt = jax_get_optimizer(name, 1e-2)
    jstate = jopt.init(jparams)

    tparams = from_jax_params(_np(jparams), device="cpu")
    topt = get_optimizer(name, 1e-2)
    tstate = from_jax_opt_state(_np(jstate), device="cpu")

    for g in grads:
        jg = jax_clip(g, clip) if clip is not None else g
        ju, jstate = jopt.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)

        tg = from_jax_params(_np(g), device="cpu")
        if clip is not None:
            tg = clip_by_global_norm(tg, clip)
        tu, tstate = topt.update(tg, tstate, tparams)
        tparams = {k: p + tu[k] for k, p in tparams.items()}

    want = from_jax_params(_np(jparams), device="cpu")
    for k, t in tparams.items():
        assert t.dtype == want[k].dtype, k
        tol = TOL[jnp.bfloat16 if t.dtype == torch.bfloat16 else np.float32]
        np.testing.assert_allclose(t.float().numpy(), want[k].float().numpy(),
                                   err_msg=k, **tol)
    if name in ("adam", "adamw"):
        assert int(tstate.step) == int(jstate.step) == STEPS
        for k, m in tstate.mu.items():
            assert m.dtype == torch.float32
            np.testing.assert_allclose(
                m.numpy(), from_jax_params(_np(jstate.mu), "cpu")[k].numpy(),
                rtol=1e-5, atol=1e-7)


def test_total_clip_zeroes_updates():
    """max_norm=0.0 is a valid total clip: every gradient leaf becomes 0."""
    g = {"a": torch.ones(3), "b": torch.full((2, 2), 5.0)}
    out = clip_by_global_norm(g, 0.0)
    assert all(torch.count_nonzero(v) == 0 for v in out.values())
