"""The port's meta-gradients against ``repro.core.maml`` on the paper's sine
MLP, from the reference's own weights and the same numpy episode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import maml as jmaml
from repro.data import SineTaskSource
from repro.models.simple import SineMLP as JaxMLP
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core import maml
from repro_torch.models import SineMLP

# f32 on both sides; the matmuls and reductions sum in other orders, and the
# second-order terms compound that over the inner steps.  Gradients here
# are O(1), so 2e-5 is ~100 f32 ulps of the largest component.
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxMLP(jax_config("sine_mlp"))
    jparams = jmodel.init(jax.random.key(0))
    ep = SineTaskSource(K=2, tasks_per_agent=3, shots=10, seed=0).sample(0)
    model = SineMLP(get_config("sine_mlp"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params, ep


def _agent(batch, k=0):
    """Agent k's (tasks, shots, 1) slices, as jnp and as torch."""
    j = tuple(jnp.asarray(x[k]) for x in batch)
    t = tuple(torch.from_numpy(np.array(x[k])) for x in batch)
    return j, t


def _close(tgrad, jgrad):
    want = from_jax_params(jax.tree.map(np.asarray, jgrad), "cpu")
    assert set(tgrad) == set(want)
    for k, g in tgrad.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("mode", ["maml", "fomaml", "reptile", "maml_naive"])
def test_meta_grad_matches_reference(setup, mode, steps):
    jmodel, jparams, model, params, ep = setup
    (js, ts), (jq, tq) = _agent(ep.support), _agent(ep.query)
    s0j, q0j = tuple(x[0] for x in js), tuple(x[0] for x in jq)
    s0t, q0t = tuple(x[0] for x in ts), tuple(x[0] for x in tq)
    jloss, jg = jmaml.meta_grad(jmodel.loss_fn, jparams, s0j, q0j, 0.01,
                                steps, mode)
    loss, g = maml.meta_grad(model.loss_fn, params, s0t, q0t, 0.01, steps,
                             mode)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _close(g, jg)


@pytest.mark.parametrize("mode", ["maml", "fomaml", "reptile", "maml_naive"])
def test_multi_task_meta_grad_matches_reference(setup, mode):
    jmodel, jparams, model, params, ep = setup
    (js, ts), (jq, tq) = _agent(ep.support, 1), _agent(ep.query, 1)
    jloss, jg = jmaml.multi_task_meta_grad(jmodel.loss_fn, jparams, js, jq,
                                           0.01, 1, mode)
    loss, g = maml.multi_task_meta_grad(model.loss_fn, params, ts, tq, 0.01,
                                        1, mode)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _close(g, jg)


def test_hvp_subsample_and_freeze_mask_match_reference(setup):
    jmodel, jparams, model, params, ep = setup
    (js, ts), (jq, tq) = _agent(ep.support), _agent(ep.query)
    jmask = {"l0": {"w": True, "b": True}, "l1": {"w": False, "b": False},
             "l2": {"w": False, "b": False}}
    mask = {k: k.startswith("l0") for k in params}
    for kw, jkw in ((dict(hvp_subsample=0.5), dict(hvp_subsample=0.5)),
                    (dict(freeze_mask=mask), dict(freeze_mask=jmask))):
        jloss, jg = jmaml.multi_task_meta_grad(jmodel.loss_fn, jparams, js,
                                               jq, 0.01, 2, "maml", **jkw)
        loss, g = maml.multi_task_meta_grad(model.loss_fn, params, ts, tq,
                                            0.01, 2, "maml", **kw)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        _close(g, jg)


def test_inner_adapt_matches_reference(setup):
    jmodel, jparams, model, params, ep = setup
    js, ts = _agent(ep.support)
    s0j, s0t = tuple(x[0] for x in js), tuple(x[0] for x in ts)
    ja = jmaml.inner_adapt(jmodel.loss_fn, jparams, s0j, 0.01, steps=3)
    a = maml.inner_adapt(model.loss_fn, params, s0t, 0.01, steps=3)
    _close(a, ja)
