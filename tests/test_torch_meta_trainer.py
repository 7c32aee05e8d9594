"""The slice as a whole: the quickstart setup (K=6 on the paper's Fig. 2a
graph, ATC, exact MAML, Adam 1e-3, 5 tasks of 10 shots) runs for 5 steps
in ``repro.core.make_meta_step`` and in the port, from one transferred init
and one numpy episode stream, with each combine backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jax_config
from repro.data import SineTaskSource
from repro.models.simple import SineMLP as JaxMLP
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core import (MetaConfig, TopologyConfig, TrainState,
                              UpdateConfig, init_state, make_meta_step)
from repro_torch.kernels.dif_combine import ops
from repro_torch.models import SineMLP

STEPS = 5
# Both sides are f32 and see the same weights and episodes; they differ in
# the order of matmul and reduction sums (ulps), which five Adam steps carry
# into the parameters.  Observed on CPU: loss 1.2e-7 relative, disagreement
# 8e-7 relative (it is a small difference of squares, ~6e-5), params 3.7e-9
# absolute.  Adam divides by sqrt(nu) + eps, so a coordinate whose
# meta-gradient sits at zero could flip its step-1 move (lr = 1e-3); the
# bounds below sit ~100x above what is observed and below such a flip.
LOSS_RTOL = 1e-5
DIS_RTOL = 1e-4
PARAMS_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def episodes():
    src = SineTaskSource(K=6, tasks_per_agent=5, shots=10, seed=0)
    return [src.sample(i) for i in range(STEPS)]


def _jax_run(backend, episodes, strategy="atc", opt="adam", schedule=None,
             combine_every=1, grad_clip=None):
    model = JaxMLP(jax_config("sine_mlp"))
    topo = (jcore.TopologyConfig(graph="paper") if schedule is None else
            jcore.TopologyConfig(graph="paper", schedule=schedule,
                                 period=3))
    mcfg = jcore.MetaConfig(
        num_agents=6, tasks_per_agent=5, inner_lr=0.01,
        outer_optimizer=opt, outer_lr=1e-3, grad_clip=grad_clip,
        update_config=jcore.UpdateConfig(strategy=strategy, inner="maml",
                                         backend=backend,
                                         combine_every=combine_every),
        topology_config=topo)
    state = jcore.init_state(jax.random.key(0), model.init, mcfg,
                             identical_init=True)
    init = (_np(state.params), _np(state.opt_state))
    step = jax.jit(jcore.make_meta_step(model.loss_fn, mcfg))
    losses, dis = [], []
    for ep in episodes:
        batch = jax.tree.map(jnp.asarray, (ep.support, ep.query))
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
        dis.append(float(m["disagreement"]))
    return init, np.array(losses), np.array(dis), _np(state.params)


@pytest.fixture(scope="module")
def jax_dense(episodes):
    return _jax_run("dense", episodes)


def _port_run(backend, init, episodes, **cfg_kw):
    model = SineMLP(get_config("sine_mlp"))
    uc = UpdateConfig(strategy=cfg_kw.pop("strategy", "atc"), inner="maml",
                      backend=backend,
                      combine_every=cfg_kw.pop("combine_every", 1))
    mcfg = MetaConfig(num_agents=6, tasks_per_agent=5, inner_lr=0.01,
                      outer_optimizer=cfg_kw.pop("opt", "adam"),
                      outer_lr=1e-3, update_config=uc,
                      topology_config=cfg_kw.pop("topo", TopologyConfig()),
                      **cfg_kw)
    if init is None:
        state = init_state(torch.Generator().manual_seed(0), model.init,
                           mcfg, device="cpu")
    else:
        state = TrainState(0, from_jax_params(init[0], "cpu"),
                           from_jax_opt_state(init[1], "cpu"))
    step = make_meta_step(model.loss_fn, mcfg, device="cpu")
    losses, dis = [], []
    for ep in episodes:
        batch = tuple(tuple(torch.from_numpy(np.array(x)) for x in part)
                      for part in (ep.support, ep.query))
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
        dis.append(float(m["disagreement"]))
    return np.array(losses), np.array(dis), state


@pytest.mark.parametrize("backend", ["dense", "pallas", "fused"])
def test_slice_matches_reference(backend, episodes, jax_dense):
    """JAX ``backend`` (Pallas kernels in interpret mode on CPU) against the
    port's ``backend`` (the kernels' plain versions on CPU)."""
    init, jl, jd, jp = (jax_dense if backend == "dense"
                        else _jax_run(backend, episodes))
    # the JAX backends agree among themselves (the anchor: step-5 loss
    # 4.0131, disagreement 6.1e-5 for all three)
    np.testing.assert_allclose(jl, jax_dense[1], rtol=LOSS_RTOL)
    assert abs(jl[-1] - 4.0131) < 1e-3 and 1e-5 < jd[-1] < 2e-4

    ops.reset_launch_counts()
    tl, td, state = _port_run(backend, init, episodes)
    assert ops.launch_counts == {"dif_combine": 0, "fused_combine_update": 0}
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(td, jd, rtol=DIS_RTOL)
    want = from_jax_params(jp, "cpu")
    for k, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAMS_ATOL, err_msg=k)
    assert int(state.opt_state.step) == STEPS


# Strategy, backend, optimizer and schedule cases the slice test above does
# not reach, each against repro.core.make_meta_step from one transferred
# init and one episode stream (4 steps).  The outer step runs through the
# paths the kernels' plain versions serve on CPU (pallas: the grouped
# combine; fused: the grouped update with the gate and row from the step;
# cta: the pre-combine) and the host-side combines.  Observed: loss within
# 2.2e-7 relative, params within 2.2e-8 absolute.
REF_CASES = {
    "cta-dense": dict(strategy="cta"),
    "consensus-dense": dict(strategy="consensus"),
    "none-dense": dict(strategy="none"),
    "centralized-dense": dict(strategy="centralized"),
    "atc-sparse_host": dict(backend="sparse_host"),
    "atc-sparse_host_dynamic-link_failure": dict(
        backend="sparse_host_dynamic", schedule="link_failure"),
    "atc-sparse_host_dynamic-gossip": dict(backend="sparse_host_dynamic",
                                           schedule="gossip"),
    "atc-sparse_host_dynamic-round_robin": dict(
        backend="sparse_host_dynamic", schedule="round_robin"),
    "atc-sgd": dict(opt="sgd"),
    "atc-momentum": dict(opt="momentum"),
    "atc-adamw": dict(opt="adamw"),
    "atc-clip-every2": dict(grad_clip=1.0, combine_every=2),
    "cta-pallas": dict(strategy="cta", backend="pallas"),
    "cta-fused-every2": dict(strategy="cta", backend="fused",
                             combine_every=2),
    "consensus-fused-momentum-link_failure-every2-clip": dict(
        strategy="consensus", backend="fused", opt="momentum",
        schedule="link_failure", combine_every=2, grad_clip=1.0),
    "atc-fused-adamw-gossip-every2": dict(
        backend="fused", opt="adamw", schedule="gossip", combine_every=2),
}
REF_LOSS_RTOL = 1e-6
REF_PARAMS_ATOL = 1e-7


@pytest.mark.parametrize("case", list(REF_CASES))
def test_meta_step_matches_reference(case, episodes):
    kw = dict(dict(backend="dense"), **REF_CASES[case])
    init, jl, jd, jp = _jax_run(episodes=episodes[:4], **kw)
    schedule = kw.pop("schedule", None)
    topo = (TopologyConfig() if schedule is None else
            TopologyConfig(schedule=schedule, period=3))
    tl, td, state = _port_run(kw.pop("backend"), init, episodes[:4],
                              topo=topo, **kw)
    np.testing.assert_allclose(tl, jl, rtol=REF_LOSS_RTOL)
    want = from_jax_params(jp, "cpu")
    for k, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                   atol=REF_PARAMS_ATOL, err_msg=k)


STRATEGIES = ["atc", "consensus", "cta", "none", "centralized"]


@pytest.mark.parametrize("opt", ["adam", "sgd", "momentum"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fused_backend_matches_dense(strategy, opt, episodes):
    """The port's fused outer step against its unfused path, with
    ``combine_every=2`` gating, a gradient clip and a stacked link-failure
    schedule (the same f32 math in another order)."""
    kw = dict(strategy=strategy, opt=opt, combine_every=2, grad_clip=1.0,
              topo=TopologyConfig(schedule="link_failure", period=3))
    dl, dd, ds = _port_run("dense", None, episodes[:3], **kw)
    fl, fd, fs = _port_run("fused", None, episodes[:3], **kw)
    np.testing.assert_allclose(fl, dl, rtol=1e-5)
    np.testing.assert_allclose(fd, dd, rtol=1e-4, atol=1e-9)
    for k, p in fs.params.items():
        torch.testing.assert_close(p, ds.params[k], rtol=1e-5, atol=1e-6)


def test_skipped_comm_steps_launch_no_combine(episodes):
    """combine_every=3: the combine runs on step 2 only of steps 0..2 — the
    gate is a host-side branch, so skipped steps leave agents unmixed."""
    calls = []
    model = SineMLP(get_config("sine_mlp"))
    mcfg = MetaConfig(num_agents=6, tasks_per_agent=5,
                      update_config=UpdateConfig(combine_every=3))

    def combine(phi, step):
        calls.append(step)
        return phi

    state = init_state(torch.Generator().manual_seed(0), model.init, mcfg,
                       device="cpu")
    step = make_meta_step(model.loss_fn, mcfg, combine_fn=combine,
                          device="cpu")
    for ep in episodes[:3]:
        batch = tuple(tuple(torch.from_numpy(np.array(x)) for x in part)
                      for part in (ep.support, ep.query))
        state, _ = step(state, *batch)
    assert calls == [2]
