"""Tests for the :vegasplus solver (adaptive hypercube stratification)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mcintegration import Continuous, Discrete, integrate
from conftest import check


def test_pi4():
    res = integrate(lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
                    var=Continuous(0.0, 1.0), dof=[[2]], neval=1e5, niter=10,
                    solver="vegasplus", verbose=-2, seed=8)
    check(res, np.pi / 4)
    # hypercube stratification should beat plain vegas by a lot here
    assert float(np.asarray(res.stdev[0])) < 5e-4


def test_singular_3d_nonseparable():
    # the integrand family plain (separable) vegas struggles with
    def f(x, c):
        ca, cb = jnp.cos(x[0]), jnp.cos(x[1])
        s2a = 2 * jnp.sin(x[0] / 2) ** 2
        s2b = 2 * jnp.sin(x[1] / 2) ** 2
        s2c = 2 * jnp.sin(x[2] / 2) ** 2
        return 1.0 / (s2a + ca * s2b + ca * cb * s2c) / np.pi**3

    res = integrate(f, var=Continuous(0.0, np.pi), dof=[[3]], neval=2e5,
                    niter=10, solver="vegas+", verbose=-2, seed=9)
    check(res, 1.3932039)


def test_multi_integrand():
    def f(x, c):
        return x[0] ** 2 + x[1] ** 2, x[0] * x[1]

    res = integrate(f, var=Continuous(0.0, 1.0), dof=[[2], [2]], neval=5e4,
                    niter=8, solver="vegasplus", verbose=-2, seed=10)
    check(res, [2.0 / 3.0, 0.25])


def test_counts_adapt():
    from mcintegration.configuration import Configuration
    from mcintegration.solvers.engine import Spec
    from mcintegration.solvers.vegasplus import VegasPlusIteration
    import jax

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=2)
    spec = Spec(cfg)
    it = VegasPlusIteration(
        spec, lambda x, c: jnp.exp(-50 * ((x[0] - 0.3) ** 2 + (x[1] - 0.7) ** 2)),
        block=8, nevalperblock=40000, mesh=None)
    params = spec.device_params()
    c0 = it.counts.copy()
    it.run(params, jax.random.key(0))
    assert it.counts.sum() == c0.sum()
    assert not np.array_equal(it.counts, c0), "counts should adapt"
    assert it.counts.min() >= 2


def test_rejects_pure_discrete():
    # no Continuous slot -> nothing to stratify (use :vegas instead)
    with pytest.raises(NotImplementedError):
        integrate(lambda x, c: 1.0, var=Discrete(1, 3), dof=[[1]],
                  neval=1e4, solver="vegasplus", verbose=-2, seed=3)


def test_padding_multi_dof():
    """dof < maxdof through the padding algebra (round 2): the estimator
    w_i * pad_i / p is unbiased under the stratification-coupled joint p."""
    def f(x, c):
        return x[0], jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)

    res = integrate(f, var=Continuous(0.0, 1.0), dof=[[1], [2]], neval=1e5,
                    niter=8, solver="vegasplus", verbose=-2, seed=4)
    check(res, [0.5, np.pi / 4])


def test_discrete_passenger():
    """Discrete pools ride along as non-stratified dims (round 2)."""
    def f(x, c):
        t, d = x
        return t[0] * t[1] * d[0].astype(jnp.float32)

    res = integrate(f, var=(Continuous(0.0, 1.0), Discrete(1, 4)),
                    dof=[[2, 1]], neval=2e5, niter=8,
                    solver="vegasplus", verbose=-2, seed=6)
    # sum_d (int t dt)^2 * d = 0.25 * (1+2+3+4) = 2.5
    check(res, 2.5)


def test_peaked_1d():
    """A D=1 peak at the domain edge, 1/(a + x)^2, against its exact
    1/a - 1/(1 + a): the map and the cubes adapt together."""
    a = 0.01

    def f(x, c):
        return 1.0 / (a + x[0]) ** 2

    res = integrate(f, var=Continuous(0.0, 1.0), dof=[[1]], neval=1e5,
                    niter=6, solver="vegasplus", verbose=-2, seed=22)
    check(res, 1.0 / a - 1.0 / (1.0 + a))


def test_no_kernel_reason():
    """:vegasplus has no fused kernel: asking for one records why."""
    res = integrate(lambda x, c: x[0], var=Continuous(0.0, 1.0), dof=[[1]],
                    neval=1e4, niter=2, solver="vegasplus", verbose=-2,
                    seed=23, backend="pallas")
    assert res.backend == "xla" and "no fused kernel" in res.backend_reason


def test_stratification_counts_follow_variance():
    """Neyman reallocation moves samples toward the peaked cubes."""
    from mcintegration.configuration import Configuration
    from mcintegration.solvers.engine import Spec
    from mcintegration.solvers.vegasplus import VegasPlusIteration
    import jax

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=31)
    spec = Spec(cfg)
    it = VegasPlusIteration(
        spec, lambda x, c: jnp.exp(-50 * ((x[0] - 0.3) ** 2
                                          + (x[1] - 0.7) ** 2)),
        block=4, nevalperblock=40000)
    it.run(spec.device_params(), jax.random.key(0))
    ns = it.nstrat
    # count-weighted centre of the cubes (dimension 0 fastest) sits at
    # the peak (0.3, 0.7)
    w = it.counts - it.counts.min()
    cube = np.arange(len(w))
    cx = ((cube % ns + 0.5) / ns * w).sum() / w.sum()
    cy = ((cube // ns + 0.5) / ns * w).sum() / w.sum()
    assert abs(cx - 0.3) < 0.05 and abs(cy - 0.7) < 0.05, (cx, cy)


def test_discrete_passenger_with_padding():
    """Both round-2 features at once: the first integrand ignores the
    Discrete slot and one Continuous slot."""
    def f(x, c):
        t, d = x
        return t[0], t[0] * t[1] * d[0].astype(jnp.float32)

    res = integrate(f, var=(Continuous(0.0, 1.0), Discrete(1, 4)),
                    dof=[[1, 0], [2, 1]], neval=2e5, niter=8,
                    solver="vegasplus", verbose=-2, seed=7)
    check(res, [0.5, 2.5])


def test_nonpow2_ninc():
    """A 1000-increment grid stratifies at its own resolution and adapts."""
    f = lambda x, c: -jnp.log(jnp.maximum(x[0], 1e-30)) \
        / jnp.sqrt(jnp.maximum(x[0], 1e-30)) / 4.0
    r = integrate(f, var=Continuous(0.0, 1.0, ninc=1000), dof=[[1]],
                  neval=2 ** 17, niter=4, solver="vegasplus",
                  parallel="none", verbose=-2, seed=11)
    g = r.config.var[0].grid
    assert len(g) - 1 == 1000
    assert not np.allclose(g, np.linspace(0, 1, 1001))
    m = float(np.asarray(r.mean[0]))
    e = float(np.asarray(r.stdev[0]))
    assert abs(m - 1.0) < 10 * max(e, 1e-4), (m, e)
