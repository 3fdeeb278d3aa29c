"""Variable-pool and configuration tests.

Mirrors reference test/variable.jl (ctor bounds, composite packing) and
test/utility.jl (maxdof, probability/padding identity).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration import CompositeVar, Configuration, Continuous, Discrete, FermiK
from mcintegration.solvers.engine import Spec


def test_continuous_ctor():
    v = Continuous(0.0, 1.0)
    assert v.lower == 0.0 and v.upper == 1.0
    assert v.grid.shape == (1025,)  # 1024 increments
    assert np.all(np.diff(v.grid) > 0)
    with pytest.raises(AssertionError):
        Continuous(1.0, 0.0)


def test_continuous_vectorized_ctor_makes_composite():
    c = Continuous([(0.0, 1.0), (-1.0, 1.0)])
    assert isinstance(c, CompositeVar)
    assert len(c) == 2
    assert c[0].lower == 0.0 and c[1].lower == -1.0


def test_discrete_ctor_and_cdf():
    d = Discrete(1, 4)
    assert d.nbin == 4
    np.testing.assert_allclose(d.distribution.sum(), 1.0)
    assert d.accumulation[0] == 0.0 and d.accumulation[-1] == 1.0
    d2 = Discrete((2, 5))
    assert d2.lower == 2 and d2.upper == 5
    c = Discrete([(1, 3), (1, 4)])
    assert isinstance(c, CompositeVar)


def test_discrete_custom_distribution():
    d = Discrete(1, 3, distribution=[1.0, 2.0, 1.0])
    np.testing.assert_allclose(d.distribution, [0.25, 0.5, 0.25])


def test_fermik_ctor():
    k = FermiK(3, 1.9, 0.5, 10.0)
    assert k.dim == 3
    assert k.value_width == 3


def test_configuration_dof_forms():
    v = Continuous(0.0, 1.0)
    assert Configuration(var=v, dof=2).dof == [[2], [0]]
    assert Configuration(var=(v,), dof=[[2], [3]]).maxdof == [3]
    c = Configuration(var=(Continuous(0.0, 1.0), Continuous(0.0, 2.0)),
                      dof=[[1, 1], [2, 0]])
    assert c.maxdof == [2, 1]
    assert c.dof == [[1, 1], [2, 0], [0, 0]]
    assert c.N == 2 and c.norm == 2


def test_configuration_neighbor_default_chain():
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[1], [1], [1]])
    # chain: norm(3) <-> 0 <-> 1 <-> 2 (configuration.jl:201-208)
    assert cfg.neighbor[3] == [0]
    assert 1 in cfg.neighbor[0]
    assert cfg.neighbor[2] == [1]


def test_configuration_neighbor_connectivity_check():
    with pytest.raises(AssertionError):
        Configuration(var=Continuous(0.0, 1.0), dof=[[1], [1]],
                      neighbor=[(0, 1)])  # norm (2) disconnected


def test_configuration_reweight_normalized():
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[1]],
                        reweight=[2.0, 2.0])
    np.testing.assert_allclose(cfg.reweight, [0.5, 0.5])


def test_probability_padding_identity():
    """total_p == probability(i) * padding_probability(i) for every i
    (reference test/utility.jl:30-56)."""
    cfg = Configuration(
        var=(Continuous(0.0, 1.0), Continuous(0.0, 3.0)),
        dof=[[1, 1], [2, 0]])
    spec = Spec(cfg)
    params = spec.device_params()
    pools = spec.draw_all(params, jax.random.key(0), (64,))
    slotp = spec.slot_probs(pools)
    total = np.asarray(spec.total_probability(slotp))
    for i in range(cfg.N + 1):
        p = np.asarray(spec.probability(slotp, i))
        pad = np.asarray(spec.padding_probability(slotp, i))
        np.testing.assert_allclose(total, p * pad, rtol=1e-5)


def test_probability_identity_composite():
    cfg = Configuration(var=Continuous([(0.0, 1.0), (0.0, np.pi)]), dof=[[1]])
    spec = Spec(cfg)
    params = spec.device_params()
    pools = spec.draw_all(params, jax.random.key(1), (16,))
    slotp = spec.slot_probs(pools)
    total = np.asarray(spec.total_probability(slotp))
    p0 = np.asarray(spec.probability(slotp, 0))
    pad0 = np.asarray(spec.padding_probability(slotp, 0))
    np.testing.assert_allclose(total, p0 * pad0, rtol=1e-5)
    # composite slot prob = product of member probs
    q = np.asarray(pools[0]["prob"] * pools[1]["prob"])
    np.testing.assert_allclose(np.asarray(slotp)[:, 0, :], q, rtol=1e-6)


def test_pool_autogrow():
    v = Continuous(0.0, 1.0, 3)  # too small for dof=4
    cfg = Configuration(var=v, dof=[[4]])
    assert v.size >= 4 + 2


def test_train_clears_histogram():
    v = Continuous(0.0, 1.0, ninc=10)  # ninc counts increments here
    assert v.histogram.shape == (10,)
    v.histogram[:] = np.linspace(1, 2, 10)
    g0 = v.grid.copy()
    v.train()
    assert not np.allclose(v.grid, g0)
    assert np.all(v.histogram == 1e-10)


def test_nonadaptive_train_is_noop():
    v = Continuous(0.0, 1.0, adapt=False, ninc=10)
    v.histogram[:] = np.linspace(1, 2, 10)
    g0 = v.grid.copy()
    v.train()
    np.testing.assert_array_equal(v.grid, g0)
