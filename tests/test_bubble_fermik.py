"""Lindhard bubble with a FermiK momentum pool, :mcmc only.

Mirrors reference test/bubble_FermiK.jl — including its capability boundary:
vegas/vegasmc do not support FermiK (bubble_FermiK.jl:2), so only the mcmc
solver is exercised, checked against the analytic Lindhard function.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mcintegration import Continuous, Discrete, FermiK, integrate

QSIZE = 4
RS, BETA, SPIN, DIM, ME = 1.0, 25.0, 2, 3, 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF**2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi**2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    if abs(q - 2 * KF) > 1e-6:
        p = 1 + (1 - x**2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x
    else:
        p = 1.0
    return -p * density * SPIN / 2


def green(tau, omega, beta):
    pos = tau >= 0.0
    gp = jnp.where(omega > 0.0,
                   jnp.exp(-omega * tau) / (1 + jnp.exp(-omega * beta)),
                   jnp.exp(omega * (beta - tau)) / (1 + jnp.exp(omega * beta)))
    gn = jnp.where(omega > 0.0,
                   -jnp.exp(-omega * (tau + beta)) / (1 + jnp.exp(-omega * beta)),
                   -jnp.exp(-omega * tau) / (1 + jnp.exp(omega * beta)))
    return jnp.where(pos, gp, gn)


def integrand(idx, vars, c):
    t, k, ext = vars
    extq = jnp.asarray(EXTQ, jnp.float32)
    kvec = k[0]                     # FermiK slot 0: 3-vector
    tau = t[0]
    q = extq[ext[0] - 1]
    kq = kvec + q
    w1 = (jnp.dot(kvec, kvec) - KF**2) / (2 * ME)
    w2 = (jnp.dot(kq, kq) - KF**2) / (2 * ME)
    g1 = green(tau, w1, BETA_PHYS)
    g2 = green(-tau, w2, BETA_PHYS)
    return g1 * g2 * SPIN / (2 * np.pi) ** 3


def measure_i(idx, vars, relw, c):
    ext = vars[-1]
    onehot = (jnp.arange(1, QSIZE + 1) == ext[0]).astype(relw.dtype)
    return [onehot * relw]


def test_fermik_raises_in_vegas_solvers():
    """FermiK is :mcmc-only (bubble_FermiK.jl:2): vegas AND vegasmc raise."""
    for solver in ("vegas", "vegasmc"):
        t = Continuous(0.0, 1.0)
        k = FermiK(3, KF, 0.2 * KF, 10.0 * KF)
        with pytest.raises(NotImplementedError):
            integrate(lambda v, c: 1.0, var=(t, k), dof=[[1, 1]],
                      solver=solver, neval=10_000, niter=2, verbose=-2)


def test_tiny_is_positive():
    """TINY must be a positive float64 floor (reference MCIntegration.jl:11)."""
    from mcintegration.common import TINY
    assert TINY > 0.0
    assert np.isfinite(TINY)
    assert TINY < 1e-200  # far below any physical probability


def test_bubble_fermik_mcmc():
    t = Continuous(0.0, BETA_PHYS, alpha=3.0)
    k = FermiK(3, KF, 0.2 * KF, 10.0 * KF)
    ext = Discrete(1, QSIZE, adapt=False)
    # FermiK equilibration needs long chains: the displaced-shell regions
    # (|k+q| ~ kF) are reached via local jitter/scale moves, so chains must
    # run O(1000) steps each (the reference runs 12.5k steps per block chain)
    res = integrate(integrand, measure=measure_i,
                    var=(t, k, ext), dof=[[1, 1, 1]], obs=[np.zeros(QSIZE)],
                    solver="mcmc", neval=400_000, verbose=-2, block=16,
                    seed=211, nwalkers=128, thermal_ratio=0.3)
    avg = np.asarray(res.mean[0])
    std = np.asarray(res.stdev[0])
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        assert abs(avg[i] - exact) < 7.0 * max(std[i], 1e-10), (
            f"q/kF={EXTQ[i][0]/KF:.3f}: {avg[i]:.6f} ± {std[i]:.6f} vs {exact:.6f}")
