"""Physics end-to-end: Lindhard polarization bubble of free electrons.

Mirrors reference test/bubble.jl: spherical-coordinate Continuous variables +
a non-adaptive Discrete external-momentum index, a vector observable filled
through a custom measure, a warm-started second run reusing the trained
config, checked against the analytic Lindhard function at 10-20 sigma for all
three solvers.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mcintegration import Configuration, Continuous, Discrete, integrate

QSIZE = 4
RS = 1.0
BETA = 25.0
SPIN = 2
DIM = 3
ME = 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF**2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0 * KF, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi**2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    if abs(q - 2 * KF) > 1e-6:
        pi_val = 1 + (1 - x**2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x
    else:
        pi_val = 1.0
    return -pi_val * density * SPIN / 2


def green(tau, omega, beta):
    # fermionic free propagator in imaginary time (bubble.jl:40-50)
    pos = tau >= 0.0
    g_pos = jnp.where(omega > 0.0,
                      jnp.exp(-omega * tau) / (1 + jnp.exp(-omega * beta)),
                      jnp.exp(omega * (beta - tau)) / (1 + jnp.exp(omega * beta)))
    g_neg = jnp.where(omega > 0.0,
                      -jnp.exp(-omega * (tau + beta)) / (1 + jnp.exp(-omega * beta)),
                      -jnp.exp(-omega * tau) / (1 + jnp.exp(omega * beta)))
    return jnp.where(pos, g_pos, g_neg)


def integrand(vars, c):
    R, Theta, Phi, T, Ext = vars
    extq = jnp.asarray(EXTQ, jnp.float32)
    r = R[0] / (1 - R[0])
    th, ph = Theta[0], Phi[0]
    k = jnp.stack([r * jnp.sin(th) * jnp.cos(ph),
                   r * jnp.sin(th) * jnp.sin(ph),
                   r * jnp.cos(th)])
    factor = 1.0 / (2 * np.pi) ** DIM
    factor = factor * r**2 / (1 - R[0]) ** 2 * jnp.sin(th)
    tau = T[0]
    q = extq[Ext[0] - 1]  # Ext is 1-based like the reference Discrete(1, Qsize)
    kq = k + q
    w1 = (jnp.dot(k, k) - KF**2) / (2 * ME)
    w2 = (jnp.dot(kq, kq) - KF**2) / (2 * ME)
    g1 = green(tau, w1, BETA_PHYS)
    g2 = green(-tau, w2, BETA_PHYS)
    return g1 * g2 * SPIN * factor


def measure(vars, relw, c):
    from mcintegration import onehot
    ext = vars[-1]
    return [onehot(ext[0], 1, QSIZE, relw[0].dtype) * relw[0]]


def measure_i(idx, vars, relw, c):
    from mcintegration import onehot
    ext = vars[-1]
    return [onehot(ext[0], 1, QSIZE, relw.dtype) * relw]


def run_bubble(steps, alg, ratio):
    t = Continuous(0.0, BETA_PHYS, alpha=3.0)
    r = Continuous(0.0, 1.0, alpha=3.0)
    th = Continuous(0.0, np.pi, alpha=3.0)
    ph = Continuous(0.0, 2 * np.pi, alpha=3.0)
    ext = Discrete(1, QSIZE, adapt=False)
    dof = [[1, 1, 1, 1, 1]]
    obs = [np.zeros(QSIZE)]

    fi = lambda idx, v, c: integrand(v, c)
    res = integrate(fi if alg == "mcmc" else integrand,
                    measure=measure_i if alg == "mcmc" else measure,
                    userdata=None, var=(r, th, ph, t, ext), dof=dof, obs=obs,
                    solver=alg, neval=steps, verbose=-2, block=8, seed=101)
    # warm-started second run reusing the trained config (bubble.jl:111-113)
    res = integrate(fi if alg == "mcmc" else integrand,
                    measure=measure_i if alg == "mcmc" else measure,
                    var=(r, th, ph, t, ext), dof=dof, obs=obs,
                    solver=alg, neval=steps * 10, verbose=-2, block=64,
                    niter=1, config=res.config, seed=103)
    avg = np.asarray(res.mean[0])
    std = np.asarray(res.stdev[0])
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        assert abs(avg[i] - exact) < ratio * max(std[i], 1e-10), (
            f"q/kF={EXTQ[i][0]/KF:.3f}: {avg[i]:.6f} ± {std[i]:.6f} "
            f"vs exact {exact:.6f}")
    return res


def test_bubble_mcmc():
    run_bubble(100_000, "mcmc", 10.0)


def test_bubble_vegas():
    run_bubble(100_000, "vegas", 20.0)


def test_bubble_vegasmc():
    run_bubble(100_000, "vegasmc", 10.0)
