"""The few-shot classification slice (paper §4.2, Fig. 3) against the
reference: ``FewShotTaskSource`` episodes (equal arrays), ``FewShotCNN``
(forward, loss, accuracy, layouts), the meta-step over the CNN against
``repro.core.make_meta_step`` from one transferred init and one episode
stream, and ``launch/fewshot.py``'s ``test_accuracy`` against the
reference example's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jax_config
from repro.data import FewShotSampler as JaxSampler
from repro.data import FewShotTaskSource as JaxSource
from repro.models.simple import FewShotCNN as JaxCNN
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core import TrainState, make_meta_step
from repro_torch.data import FewShotSampler, FewShotTaskSource
from repro_torch.kernels.dif_combine import ops
from repro_torch.launch import fewshot
from repro_torch.models import FewShotCNN, count_params

SOURCE_KW = dict(K=6, tasks_per_agent=2, n_classes=80, n_way=5, k_shot=1,
                 n_query=5, seed=0)
STEPS = 3
# Forward, loss and accuracy on one batch, float32 both sides: the same
# products summed in another order (the convolutions' and the head's).
MODEL_ATOL = 1e-5
# Three meta-steps, float32 both sides, the same weights and episodes; the
# sums differ in order, which the inner step (α = 0.4), the curvature
# product and three Adam steps carry along.  Set before the first run.
LOSS_RTOL = 1e-5
PARAMS_ATOL = 1e-5
# What the first run showed: losses within 2.8e-6 relative, but 163-492 of
# the 66,078 parameters (up to 0.74%) outside PARAMS_ATOL, by up to 2e-3.
# The cause is a ReLU kink, not the port: after agent 1's inner step one
# second-block pre-activation of a query image sits at 9e-9, and the two
# packages' convolutions (sums in another order) put it on different sides
# of zero, so that task's outer gradient differs by 0.9% (at the same
# adapted weights the gradients agree to 1e-6).  Adam normalises each
# coordinate's step, so such a coordinate moves by at most lr a step on
# either side: at most KINK_SHARE of the parameters may differ by more than
# PARAMS_ATOL, each by at most 2 lr a step.
KINK_SHARE = 1e-2
OUTER_LR = 1e-3
# test_accuracy counts 50 tasks x 25 queries = 1,250 predictions; an
# argmax near a tie may fall either way on the two sides' rounding.
ACC_PREDICTIONS = 1250
ACC_SLACK = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread while this module runs: the suite runs several
    pytest-xdist workers on a few cores, and torch's default of one thread
    per core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_task_source_episodes_are_the_references():
    """Three training steps (all agents) and the eval episodes of every
    split: equal arrays, equal domains."""
    port, ref = FewShotTaskSource(**SOURCE_KW), JaxSource(**SOURCE_KW)
    assert (port.n_domains, port.n_test_domains, port.dim) == \
        (ref.n_domains, ref.n_test_domains, ref.dim) == (64, 16, 196)
    for step in range(3):
        ep, want = port.sample(step), ref.sample(step)
        _assert_tree_equal(ep.support, want.support)
        _assert_tree_equal(ep.query, want.query)
        np.testing.assert_array_equal(ep.domains, want.domains)
        assert np.asarray(ep.support[0]).shape == (6, 2, 5, 196)
        assert np.asarray(ep.query[1]).dtype == np.int32
    for split in (None, "recurring", "unseen", "full"):
        ep = port.eval_sample(7, seed=777, split=split)
        want = ref.eval_sample(7, seed=777, split=split)
        _assert_tree_equal(ep.support, want.support)
        _assert_tree_equal(ep.query, want.query)
        np.testing.assert_array_equal(ep.domains, want.domains)
    for k, (a, b) in enumerate(zip(port.shards(), ref.shards())):
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_sampler_legacy_paths_are_the_references():
    """``FewShotSampler.sample`` (its own generator, then a given seed) and
    ``sample_agents``, in call order."""
    kw = dict(n_classes=40, seed=3)
    port, ref = FewShotSampler(**kw), JaxSampler(**kw)
    _assert_tree_equal(port.sample(4), ref.sample(4))
    _assert_tree_equal(port.sample(3, split="test", seed=9),
                       ref.sample(3, split="test", seed=9))
    _assert_tree_equal(port.sample_agents(3, 2), ref.sample_agents(3, 2))


def test_too_few_classes_a_shard_raises():
    with pytest.raises(ValueError, match="too few"):
        FewShotTaskSource(K=6, n_classes=30)


@pytest.mark.parametrize("hw", [14, 11])
def test_cnn_matches_reference(hw):
    """Forward, loss and accuracy on one batch from the reference's
    weights; the param dict keeps the reference's keys and HWIO shapes.
    hw=14 pools 14 → 7 → 3 (an odd map), hw=11 odd from the start."""
    jcfg = jax_config("omniglot_cnn")
    jm, m = JaxCNN(jcfg, image_hw=hw), FewShotCNN(get_config("omniglot_cnn"),
                                                 image_hw=hw)
    jp = _np(jm.init(jax.random.key(1)))
    params = from_jax_params(jp, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: s.shape for k, s in m.specs().items()}
    assert params["conv1/w"].shape == (3, 3, 32, 32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, hw * hw)).astype(np.float32)
    y = rng.integers(0, 5, size=12).astype(np.int32)
    want = np.asarray(jm.forward(jp, jnp.asarray(x)))
    got = m.forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MODEL_ATOL)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(
        float(m.loss_fn(params, batch)),
        float(jm.loss_fn(jp, (jnp.asarray(x), jnp.asarray(y)))),
        rtol=0, atol=MODEL_ATOL)
    assert float(m.accuracy(params, batch)) == float(
        jm.accuracy(jp, (jnp.asarray(x), jnp.asarray(y))))


def test_cnn_shapes_and_count():
    """11,013 parameters in 6 leaves, as the reference counts them; init
    from a seed on the CPU."""
    m = FewShotCNN(get_config("omniglot_cnn"))
    assert count_params(m.specs()) == 11_013
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert len(p) == 6 and sum(v.numel() for v in p.values()) == 11_013
    assert all(v.dtype == torch.float32 for v in p.values())
    assert float(p["conv0/b"].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def episodes():
    src = JaxSource(**SOURCE_KW)
    return [src.sample(i) for i in range(STEPS)]


def _jax_run(strategy, backend, episodes):
    model = JaxCNN(jax_config("omniglot_cnn"))
    mcfg = jcore.MetaConfig(
        num_agents=6, tasks_per_agent=2, inner_lr=0.4,
        update_config=jcore.UpdateConfig(strategy=strategy, inner="maml",
                                         backend=backend),
        topology_config=jcore.TopologyConfig(graph="paper"),
        outer_optimizer="adam", outer_lr=1e-3)
    state = jcore.init_state(jax.random.key(0), model.init, mcfg,
                             identical_init=True)
    init = (_np(state.params), _np(state.opt_state))
    step = jax.jit(jcore.make_meta_step(model.loss_fn, mcfg))
    losses = []
    for ep in episodes:
        state, m = step(state, *jax.tree.map(jnp.asarray,
                                             (ep.support, ep.query)))
        losses.append(float(m["loss"]))
    return init, np.array(losses), _np(state.params)


CASES = [(s, b) for s in ("atc", "centralized", "none")
         for b in fewshot.BACKENDS]


@pytest.mark.parametrize("strategy,backend", CASES)
def test_meta_step_matches_reference(strategy, backend, episodes):
    """The example's meta-step (``launch.fewshot.meta_config``): K=6 on the
    Fig. 2a graph, 2 tasks an agent, exact MAML through the CNN, Adam;
    losses per step and the final params.  On the CPU the outer-update
    wrappers run their plain versions, so no kernel launches."""
    init, jl, jp = _jax_run(strategy, backend, episodes)
    model = FewShotCNN(get_config("omniglot_cnn"))
    step = make_meta_step(model.loss_fn,
                          fewshot.meta_config(strategy, backend),
                          device="cpu")
    state = TrainState(0, from_jax_params(init[0], "cpu"),
                       from_jax_opt_state(init[1], "cpu"))
    ops.reset_launch_counts()
    losses = []
    for ep in episodes:
        batch = tuple(tuple(torch.from_numpy(np.array(x)) for x in part)
                      for part in (ep.support, ep.query))
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    assert ops.launch_counts == {"dif_combine": 0, "fused_combine_update": 0}
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    want = from_jax_params(jp, "cpu")
    outside, total = 0, 0
    for k, p in state.params.items():
        diff = (p - want[k]).abs()
        outside += int((diff > PARAMS_ATOL).sum())
        total += diff.numel()
        assert float(diff.max()) <= 2 * OUTER_LR * STEPS, (k, diff.max())
    assert outside <= KINK_SHARE * total, (outside, total)


def test_test_accuracy_matches_reference_example():
    """``launch.fewshot.test_accuracy`` against the reference example's on
    one shared centroid (the reference's init, one adaptation step from
    it): within ACC_SLACK of the 1,250 query predictions."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "fewshot_classification.py"
    spec = importlib.util.spec_from_file_location("_fewshot_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    jcfg = jax_config("omniglot_cnn")
    src, ref_src = fewshot.make_source(), JaxSource(**SOURCE_KW)
    jm = JaxCNN(jcfg, image_hw=ref_src.image_hw)
    jp = jm.init(jax.random.key(0))
    want = example.test_accuracy(jm, jp, ref_src, jcfg.inner_lr)
    model = FewShotCNN(get_config("omniglot_cnn"), image_hw=src.image_hw)
    got = fewshot.test_accuracy(model, from_jax_params(_np(jp), "cpu"), src,
                                jcfg.inner_lr)
    assert 0.2 < want < 1.0
    assert abs(got - want) * ACC_PREDICTIONS <= ACC_SLACK + 1e-6, (got, want)
