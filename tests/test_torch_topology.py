"""The port's topology module is a copy of the reference's: every graph ×
rule and every schedule must give exactly the reference's arrays."""
import numpy as np
import pytest

from repro.core import topology as ref
from repro_torch.core import topology as port


def _sizes(name):
    return [6] if name in ref.FIXED_SIZE else [2, 6, 8, 9]


@pytest.mark.parametrize("rule", ["metropolis", "uniform"])
@pytest.mark.parametrize("name", sorted(ref.TOPOLOGIES))
def test_matrices_equal_reference(name, rule):
    assert sorted(port.TOPOLOGIES) == sorted(ref.TOPOLOGIES)
    for K in _sizes(name):
        A = port.combination_matrix(K, name, rule)
        np.testing.assert_array_equal(A, ref.combination_matrix(K, name, rule))
        t, r = port.build_topology(name, K, rule), ref.build_topology(name, K,
                                                                     rule)
        assert t.edges == r.edges
        np.testing.assert_array_equal(t.matrix, r.matrix)
        assert t.diagnostics() == r.diagnostics()


@pytest.mark.parametrize("kind", sorted(ref.SCHEDULES))
@pytest.mark.parametrize("name", ["paper", "ring", "full"])
def test_schedules_equal_reference(kind, name):
    kw = {"link_failure": dict(p=0.3, period=16, seed=3),
          "gossip": dict(period=16, seed=5)}.get(kind, {})
    s = port.make_schedule(kind, port.build_topology(name, 6), **kw)
    r = ref.make_schedule(kind, ref.build_topology(name, 6), **kw)
    np.testing.assert_array_equal(s.stacked(), r.stacked())
    np.testing.assert_array_equal(s.matrices, r.matrices)
    si, ri = s.ir(), r.ir()
    assert si.offsets == ri.offsets
    np.testing.assert_array_equal(si.self_weights, ri.self_weights)
    np.testing.assert_array_equal(si.offset_weights, ri.offset_weights)
    assert s.mean_mixing_rate == r.mean_mixing_rate


def test_fixed_size_graph_rejects_other_agent_counts():
    with pytest.raises(ValueError, match="fixed 6-agent graph"):
        port.build_topology("paper", 4)
