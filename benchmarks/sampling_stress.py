"""Normalization-sector vs conventional importance sampling stress test.

Reproduces the reference's shifted-Gaussian benchmark
(docs/src/man/important_sampling.md:103-131, a BASELINE.md anchor):
integrate f(x) = exp(-(x-beta/2)^2/delta^2) over [0, beta] (= sqrt(pi)*delta
= 0.17725 for delta=0.1) using a FIXED, deliberately mismatched proposal
g(x) = exp(-(x-beta/2+s)^2/delta^2) shifted by s.

- "conventional" importance sampling (:vegas with the frozen shifted grid)
  breaks down around s = 4*delta (published: 0.0204 +- 0.0064 vs 0.1772);
- the normalization-sector scheme (:vegasmc, the same frozen grid) survives
  (published: 0.176 +- 0.015).

Run: python benchmarks/sampling_stress.py [neval]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mcintegration.platform import configure_jax

configure_jax(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import math

import numpy as np
import jax.numpy as jnp

from mcintegration import Continuous, integrate


def _erfinv(y: np.ndarray) -> np.ndarray:
    """Vectorized host-side erfinv by bisection (jax's erfinv lowering is
    surprisingly slow to compile; 60 bisection steps are exact enough)."""
    y = np.clip(np.asarray(y, np.float64), -1 + 1e-15, 1 - 1e-15)
    lo = np.full_like(y, -8.0)
    hi = np.full_like(y, 8.0)
    erf_v = np.vectorize(math.erf)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        m = erf_v(mid) < y
        lo = np.where(m, mid, lo)
        hi = np.where(m, hi, mid)
    return 0.5 * (lo + hi)

BETA = 100.0
DELTA = 0.1
EXACT = np.sqrt(np.pi) * DELTA  # 0.1772454


def shifted_grid(s: float, nodes: int = 1025) -> np.ndarray:
    """Grid nodes = equal-probability quantiles of the shifted Gaussian
    g(x) = exp(-(x-mu)^2/delta^2) truncated to [0, beta], mu = beta/2 - s.
    1024 increments, the library's default resolution."""
    mu = BETA / 2 - s
    a = math.erf((0.0 - mu) / DELTA)
    b = math.erf((BETA - mu) / DELTA)
    q = a + (b - a) * np.linspace(0.0, 1.0, nodes)
    x = mu + DELTA * _erfinv(q)
    x[0], x[-1] = 0.0, BETA
    return np.maximum.accumulate(x)


def run(solver: str, s: float, neval: int):
    grid = shifted_grid(s)
    var = Continuous(0.0, BETA, adapt=False, grid=grid)
    f = lambda x, c: jnp.exp(-((x[0] - BETA / 2) ** 2) / DELTA**2)
    kw = {}
    niter = 10
    if solver == "vegasmc":
        # the normalization-sector robustness claim rests on LONG chains
        # (the reference runs 1e7-1e8 sequential updates): 8192 walkers
        # running neval/8192 steps each, with the first half of every chain
        # discarded so the walk can mix into the shifted peak before
        # measuring
        kw = dict(nwalkers=8192, warmup=0.5, block=8)
        niter = 1
    res = integrate(f, var=var, dof=[[1]], neval=neval, niter=niter,
                    solver=solver, verbose=-2, adapt=False, seed=5, **kw)
    return float(np.asarray(res.mean[0])), float(np.asarray(res.stdev[0]))


def main():
    # default: vegasmc runs 8192 chains of neval/8192 steps; 8e9 gives
    # ~1e6 steps/chain, enough to mix through s = 4δ
    neval = int(float(sys.argv[1])) if len(sys.argv) > 1 else 8_000_000_000
    print(f"exact = {EXACT:.5f}   (neval={neval:.0e} per cell)")
    print(f"{'s/delta':>8s} {'vegas (conventional)':>24s} "
          f"{'vegasmc (norm sector)':>24s}")
    for k in (1, 2, 3, 4, 5):
        row = [f"{k:8d}"]
        for solver in ("vegas", "vegasmc"):
            try:
                m, e = run(solver, k * DELTA, neval)
                row.append(f"{m:12.4f} ± {e:.4f}")
            except Exception as ex:
                row.append(f"failed: {str(ex)[:24]}")
        print(" ".join(row))
    print("published @1e8 updates: conventional 0.0204(64) at s=4δ (breaks); "
          "normalization sector 0.176(15) (survives)")
    print("note: with a frozen mismatched proposal the importance weights "
          "are heavy-tailed, so ALL reported error bars in the conventional "
          "column are underestimates — the pathology this benchmark exposes; "
          "stratified sampling keeps every bin covered, which is why the "
          "conventional column here degrades more gracefully than published")


if __name__ == "__main__":
    main()
