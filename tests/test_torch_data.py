"""The port's sine episodes are the reference's, bit for bit: sampling is the
same numpy code over the same rng derivation."""
import numpy as np
import pytest
import torch

from repro.data import SineTaskSource as RefSource
from repro_torch.data import MetaBatchPipeline, SineTaskSource


def _assert_tree_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_sample_bit_identical(step):
    kw = dict(K=6, tasks_per_agent=5, shots=10, seed=3)
    ep, ref = SineTaskSource(**kw).sample(step), RefSource(**kw).sample(step)
    _assert_tree_equal(ep.support, ref.support)
    _assert_tree_equal(ep.query, ref.query)
    np.testing.assert_array_equal(ep.domains, ref.domains)
    assert np.asarray(ep.support[0]).shape == (6, 5, 10, 1)


@pytest.mark.parametrize("split", [None, "recurring", "unseen"])
def test_eval_sample_bit_identical(split):
    kw = dict(K=6, holdout_domains=12, seed=0)
    ep = SineTaskSource(**kw).eval_sample(40, seed=999, split=split)
    ref = RefSource(**kw).eval_sample(40, seed=999, split=split)
    _assert_tree_equal(ep.support, ref.support)
    _assert_tree_equal(ep.query, ref.query)
    np.testing.assert_array_equal(ep.domains, ref.domains)


def test_agent_streams_are_slices_of_the_stacked_episode():
    src, ref = SineTaskSource(K=3, seed=1), RefSource(K=3, seed=1)
    for s, r in zip(src.sources(), ref.sources()):
        np.testing.assert_array_equal(s.domains, r.domains)
        _assert_tree_equal(s.sample(4).support, r.sample(4).support)


@pytest.mark.parametrize("depth", [0, 2])
def test_pipeline_yields_the_episode_stream(depth):
    src = SineTaskSource(K=2, tasks_per_agent=2, shots=3, seed=0)
    with MetaBatchPipeline(src, "cpu", depth=depth, start_step=5) as pipe:
        for step in (5, 6, 7):
            support, query = next(pipe)
            ep = src.sample(step)
            for t, x in zip(support + query, ep.support + ep.query):
                assert isinstance(t, torch.Tensor)
                np.testing.assert_array_equal(t.numpy(), x)
        assert pipe.step == 8


def test_episode_to_device_returns_tensors():
    ep = SineTaskSource(K=2, seed=0).sample(0)
    support, query = ep.to_device("cpu")
    np.testing.assert_array_equal(support[1].numpy(), ep.support[1])
    assert query[0].device.type == "cpu"
