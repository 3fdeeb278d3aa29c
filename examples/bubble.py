"""Physics demo: Lindhard polarization bubble of free electrons.

Port of the reference's example/test (test/bubble.jl): a 4-variable
spherical-coordinate integral with a discrete external-momentum index,
vector observable via a custom measure, warm-started refinement run, checked
against the analytic Lindhard function.

Run: python examples/bubble.py [neval] [solver]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mcintegration.platform import configure_jax

configure_jax(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax.numpy as jnp

from mcintegration import Continuous, Discrete, integrate, report

QSIZE = 8
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


def integrand(v, c):
    """Shape-agnostic (elementwise over any trailing sample axes): works
    per-sample under vmap (XLA path) AND batched inside the fused Pallas
    chain kernel; the external-q lookup is a one-hot sum, not a gather."""
    R, TH, PH, T, EXT = v
    r = R[0] / (1 - R[0])
    th, ph = TH[0], PH[0]
    k = [r * jnp.sin(th) * jnp.cos(ph),
         r * jnp.sin(th) * jnp.sin(ph),
         r * jnp.cos(th)]
    factor = r**2 / (1 - R[0]) ** 2 * jnp.sin(th) / (2 * np.pi) ** DIM
    tau = T[0]
    e = EXT[0]
    oh = [(e == j + 1).astype(jnp.float32) for j in range(QSIZE)]
    q = [sum(oh[j] * float(EXTQ[j, d]) for j in range(QSIZE))
         for d in range(DIM)]
    k2 = sum(kc * kc for kc in k)
    kq2 = sum((kc + qc) ** 2 for kc, qc in zip(k, q))
    g1 = green(tau, (k2 - KF**2) / (2 * ME), BETA_PHYS)
    g2 = green(-tau, (kq2 - KF**2) / (2 * ME), BETA_PHYS)
    return g1 * g2 * SPIN * factor


def measure(v, relw, c):
    """Shape-agnostic vector measure: the observable axis is built by a
    static python loop of one-hot selects, valid per-sample (XLA vmap) AND
    batched over sample tiles (Pallas chain kernel)."""
    ext = v[-1][0]
    rows = [(ext == j + 1).astype(relw[0].dtype) * relw[0]
            for j in range(QSIZE)]
    return [jnp.stack(rows)]


def main():
    neval = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000
    solver = sys.argv[2] if len(sys.argv) > 2 else "vegasmc"
    fi = (lambda idx, v, c: integrand(v, c)) if solver == "mcmc" else integrand

    var = (Continuous(0.0, 1.0, alpha=3.0),
           Continuous(0.0, np.pi, alpha=3.0),
           Continuous(0.0, 2 * np.pi, alpha=3.0),
           Continuous(0.0, BETA_PHYS, alpha=3.0),
           Discrete(1, QSIZE, adapt=False))
    if solver == "mcmc":
        def m(idx, v, relw, c):
            ext = v[-1]
            onehot = (jnp.arange(1, QSIZE + 1) == ext[0]).astype(relw.dtype)
            return [onehot * relw]
    else:
        m = measure

    res = integrate(fi, measure=m, var=var, dof=[[1, 1, 1, 1, 1]],
                    obs=[np.zeros(QSIZE)], solver=solver, neval=neval,
                    verbose=-2, block=16)
    # warm-started refinement run on the trained grids (bubble.jl:111-113)
    res = integrate(fi, measure=m, var=var, dof=[[1, 1, 1, 1, 1]],
                    obs=[np.zeros(QSIZE)], solver=solver, neval=neval * 4,
                    verbose=-2, block=64, niter=2, config=res.config)

    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    print(f"solver = {solver}")
    print(f"{'q/kF':>10s} {'avg':>12s} {'err':>10s} {'exact':>12s} {'sigma':>7s}")
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        ns = abs(avg[i] - exact) / max(std[i], 1e-12)
        print(f"{EXTQ[i][0]/KF:10.4f} {avg[i]:12.6f} {std[i]:10.6f} "
              f"{exact:12.6f} {ns:7.2f}")


if __name__ == "__main__":
    main()
