"""The port's ``build_train`` step for reduced qwen2-1.5b at K=4 against the
reference's ``repro.core.make_meta_step``: three ``maml`` steps with the
dense, pallas and fused backends, in float32 and with a bfloat16 outer
dtype (set-up in torch_train_ref.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro_torch.convert import from_jax_params

ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "pallas", "fused"])
def test_train_step_matches_reference(backend, dtype):
    """Three ``maml`` steps, ATC on the ring, Adam: per-step losses and
    the final params."""
    arch = ARCH
    jcfg, cfg = R.cfgs(arch, dtype)
    jstep, jstate, _ = R.jax_setup(jcfg, backend)
    bundle = R.port_bundle(cfg, backend)
    assert (bundle.T, bundle.tb, bundle.combine_backend) == (2, 1, backend)
    state = R.to_port(jstate)
    for ep in R.episodes():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in ep.as_flat_batch().items()})
        state, m = bundle.step_fn(state, R.flat(ep))
        assert np.isfinite(float(jm["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=R.LOSS_RTOL[dtype])
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params), "cpu")
    assert int(state.step) == R.STEPS
    R.assert_params_close(state.params, want, R.PARAMS_ATOL[dtype], R.STEPS)
