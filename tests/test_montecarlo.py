"""Solver integration battery (mirrors reference test/montecarlo.jl).

Statistical oracles at k-sigma over integrals with closed forms, exercised
for all three solvers on an 8-virtual-device CPU mesh.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mcintegration import (
    CompositeVar,
    Configuration,
    Continuous,
    Discrete,
    integrate,
)
from conftest import check, check_complex, check_vector

PI4 = np.pi / 4.0
SPHERE3 = 4.0 * np.pi / 3.0 / 8.0
NEVAL = 100_000


def sphere1(neval, alg, seed=17):
    f = lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    fi = lambda idx, x, c: f(x, c)
    return integrate(fi if alg == "mcmc" else f,
                     var=(Continuous(0.0, 1.0),), dof=[[2]], neval=neval,
                     solver=alg, verbose=-2, seed=seed)


def sphere2(neval, alg, offset=0, seed=23):
    def f(x, c):
        i1 = jnp.where(x[0 + offset] ** 2 + x[1 + offset] ** 2 < 1.0, 1.0, 0.0)
        i2 = jnp.where(x[0 + offset] ** 2 + x[1 + offset] ** 2
                       + x[2 + offset] ** 2 < 1.0, 1.0, 0.0)
        return i1, i2

    def fi(idx, x, c):
        if idx == 0:
            return jnp.where(x[0 + offset] ** 2 + x[1 + offset] ** 2 < 1.0, 1.0, 0.0)
        return jnp.where(x[0 + offset] ** 2 + x[1 + offset] ** 2
                         + x[2 + offset] ** 2 < 1.0, 1.0, 0.0)

    def measure(x, relw, c):
        return [relw[0], relw[1]]

    def measure_i(idx, x, relw, c):
        return [relw if idx == 0 else relw * 0, relw if idx == 1 else relw * 0]

    t = Continuous(0.0, 1.0, 2 + offset, offset=offset)
    cfg = Configuration(var=(t,), dof=[[2], [3]], neighbor=[(0, 2), (0, 1)])
    return integrate(fi if alg == "mcmc" else f, config=cfg, neval=neval,
                     solver=alg, verbose=-2, seed=seed,
                     measure=measure_i if alg == "mcmc" else measure)


def sphere3(neval, alg, seed=29):
    """Heterogeneous observables [scalar, vector-of-2] with custom measure."""
    def f(x, c):
        i1 = jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
        i2 = jnp.where(x[0] ** 2 + x[1] ** 2 + x[2] ** 2 < 1.0, 1.0, 0.0)
        return i1, i2

    def fi(idx, x, c):
        return f(x, c)[idx]

    def measure(x, relw, c):
        return [relw[0], jnp.stack([relw[1], relw[1] * 2.0])]

    def measure_i(idx, x, relw, c):
        if idx == 0:
            return [relw, jnp.zeros(2)]
        return [relw * 0.0, jnp.stack([relw, relw * 2.0])]

    cfg = Configuration(var=(Continuous(0.0, 1.0),), dof=[[2], [3]],
                        neighbor=[(0, 2), (0, 1)], obs=[0.0, np.zeros(2)])
    return integrate(fi if alg == "mcmc" else f, config=cfg, neval=neval,
                     solver=alg, verbose=-2, seed=seed,
                     measure=measure_i if alg == "mcmc" else measure)


def run_discrete(neval, alg, seed=31):
    f = lambda x, c: x[0].astype(jnp.float32)
    fi = lambda idx, x, c: f(x, c)
    cfg = Configuration(var=(Discrete(1, 3),), dof=[[1]])
    return integrate(fi if alg == "mcmc" else f, config=cfg, neval=neval,
                     niter=10, solver=alg, verbose=-2, seed=seed)


def run_discrete2(neval, alg, seed=37):
    f = lambda x, c: 1.0
    fi = lambda idx, x, c: 1.0
    cfg = Configuration(var=(Discrete([(1, 3), (1, 4)]),), dof=[[1]])
    return integrate(fi if alg == "mcmc" else f, config=cfg, neval=neval,
                     niter=10, solver=alg, verbose=-2, seed=seed)


def singular1(neval, alg, seed=41):
    f = lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0])
    fi = lambda idx, x, c: f(x, c)
    return integrate(fi if alg == "mcmc" else f, var=Continuous(0.0, 1.0),
                     dof=[[1]], neval=neval, solver=alg, verbose=-2, seed=seed)


def singular2(neval, alg, seed=43):
    f = lambda x, c: 1.0 / (1.0 - jnp.cos(x[0]) * jnp.cos(x[1]) * jnp.cos(x[2])) / np.pi**3
    fi = lambda idx, x, c: f(x, c)
    return integrate(fi if alg == "mcmc" else f,
                     var=(Continuous(0.0, np.pi),), dof=[[3]], neval=neval,
                     solver=alg, verbose=-2, seed=seed)


def singular2_composite(neval, alg, seed=47):
    def f(cv, c):
        x, y, z = cv
        return 1.0 / (1.0 - jnp.cos(x[0]) * jnp.cos(y[0]) * jnp.cos(z[0])) / np.pi**3
    fi = lambda idx, cv, c: f(cv, c)
    cvar = CompositeVar(Continuous(0.0, np.pi), Continuous(0.0, np.pi),
                        Continuous(0.0, np.pi))
    return integrate(fi if alg == "mcmc" else f, var=cvar, dof=1, neval=neval,
                     solver=alg, verbose=-2, seed=seed)


def singular2_highdim(neval, alg, seed=53):
    def f(cv, c):
        x, y, z = cv
        return 1.0 / (1.0 - jnp.cos(x[0]) * jnp.cos(y[0]) * jnp.cos(z[0])) / np.pi**3
    fi = lambda idx, cv, c: f(cv, c)
    cvar = Continuous([(0.0, np.pi), (0.0, np.pi), (0.0, np.pi)])
    return integrate(fi if alg == "mcmc" else f, var=cvar, dof=1, neval=neval,
                     solver=alg, verbose=-2, seed=seed)


def complex1(neval, alg, seed=59):
    f = lambda x, c: x[0] + x[0] ** 2 * 1j
    fi = lambda idx, x, c: f(x, c)
    return integrate(fi if alg == "mcmc" else f, neval=neval, type=complex,
                     solver=alg, verbose=-2, seed=seed,
                     var=Continuous(0.0, 1.0), dof=[[1]])


def complex2(neval, alg, seed=61):
    def f(x, c):
        return x[0], x[0] ** 2 * 1j
    def fi(idx, x, c):
        return jnp.where(idx == 0, x[0] + 0j, x[0] ** 2 * 1j) if False else \
            (x[0] + 0j if idx == 0 else x[0] ** 2 * 1j)
    return integrate(fi if alg == "mcmc" else f, dof=[[1], [1]], neval=neval,
                     type=complex, solver=alg, verbose=-2, seed=seed,
                     var=Continuous(0.0, 1.0))


def complex2_inplace(neval, alg, seed=67):
    def f(x, w, c):
        w[0] = x[0]
        w[1] = x[0] ** 2 * 1j
    return integrate(f, dof=[[1], [1]], neval=neval, type=complex,
                     solver=alg, verbose=-2, seed=seed, inplace=True,
                     var=Continuous(0.0, 1.0))


def hypersphere(neval, alg, nmax, seed=71):
    def vol_inv(d):
        e = 2.718281828459045
        return (d / (2 * np.pi * e)) ** (d / 2) * np.sqrt(d) * np.sqrt(np.pi)

    def f(x, w, c):
        acc = x[0] ** 2
        for i in range(c.userdata):
            acc = acc + x[i + 1] ** 2
            w[i] = jnp.where(acc < 1.0, vol_inv(i + 2), 0.0)

    return integrate(f, var=Continuous(-1.0, 1.0),
                     dof=[[i + 2] for i in range(nmax)], userdata=nmax,
                     neval=neval, solver=alg, verbose=-2, seed=seed,
                     inplace=True)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_sphere1(alg):
    check(sphere1(NEVAL, alg), PI4)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_sphere2(alg):
    check(sphere2(2 * NEVAL, alg), [PI4, SPHERE3])


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_sphere2_offset(alg):
    check(sphere2(2 * NEVAL, alg, offset=2), [PI4, SPHERE3])


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_sphere3_heterogeneous_obs(alg):
    check_vector(sphere3(2 * NEVAL, alg), [PI4, [SPHERE3, SPHERE3 * 2]])


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_discrete(alg):
    check(run_discrete(NEVAL, alg), 6.0)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_discrete2(alg):
    check(run_discrete2(NEVAL, alg), 12.0)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc"])
def test_singular1(alg):
    res = singular1(2 * NEVAL if alg == "vegas" else NEVAL, alg)
    check(res, -4.0)
    # stderr regression bounds (reference test/montecarlo.jl:317,364)
    bound = 0.0004 if alg == "vegas" else 0.0007
    assert float(np.asarray(res.stdev[0])) < bound


def test_singular1_mcmc_runs():
    res = singular1(NEVAL, "mcmc")
    check(res, -4.0, ratio=10.0)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_singular2(alg):
    check(singular2(NEVAL, alg), 1.3932)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_singular2_composite(alg):
    check(singular2_composite(NEVAL, alg), 1.3932)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_singular2_highdim(alg):
    check(singular2_highdim(NEVAL, alg), 1.3932)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_complex1(alg):
    check_complex(complex1(NEVAL, alg), 0.5 + 1.0 / 3 * 1j)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_complex2(alg):
    check_complex(complex2(NEVAL, alg), [0.5 + 0j, 1.0 / 3 * 1j])


@pytest.mark.parametrize("alg", ["vegas", "vegasmc"])
def test_complex2_inplace(alg):
    check_complex(complex2_inplace(NEVAL, alg), [0.5 + 0j, 1.0 / 3 * 1j])


@pytest.mark.parametrize("alg", ["vegas", "vegasmc"])
def test_hypersphere_inplace_vector(alg):
    check(hypersphere(2 * NEVAL, alg, 3), [0.9230, 0.94724, 0.96118])


def test_mcmc_reweight_goal():
    res = integrate(lambda idx, x, c: 1.0, var=(Continuous(0.0, 1.0),),
                    dof=[[1]], neval=NEVAL, solver="mcmc", verbose=-2,
                    reweight_goal=[1.0, 1.0], seed=73)
    check(res, 1.0)


def test_report_smoke(capsys):
    from mcintegration import report
    res = sphere1(10_000, "vegas")
    report(res)
    out = capsys.readouterr().out
    assert "Integral" in out


def test_warm_start_reuses_trained_grid():
    res = singular1(NEVAL, "vegas", seed=79)
    g1 = res.config.var[0].grid.copy()
    res2 = integrate(lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0]),
                     config=res.config, neval=NEVAL, niter=2, solver="vegas",
                     verbose=-2, adapt=False)
    check(res2, -4.0)
    np.testing.assert_array_equal(res2.config.var[0].grid, g1)
