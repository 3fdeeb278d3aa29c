"""The Cuba 11-component 3-D suite (reference example/benchmark/cuba/benchmark.jl).

Eleven simultaneous 3-D integrands with shared pools — the reference's
throughput anchor (0.246 s wall at :vegas neval=1e5 ⇒ ~0.41 M steps/s,
~4.5 M component-evals/s on the author's laptop; BASELINE.md).  Prints
per-component estimates vs Cuba's vegas values plus wall time and rates.

Run: python benchmarks/cuba11.py [neval] [solver]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mcintegration.platform import configure_jax

configure_jax(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax.numpy as jnp

from mcintegration import Continuous, integrate

CUBA_VEGAS = [  # reference benchmark.jl:101-113 (Cuba vegas @ ~1e6 evals)
    0.66466956, 5.26864144, 0.30780794, 0.87731278, 0.41654127,
    1.20201670, 0.70962355, 0.89121873, 0.08018534, 2.39635903, 0.52363603,
]


def test2(x, c):
    x0, x1, x2 = x[0], x[1], x[2]
    rsq = x0 * x0 + x1 * x1 + x2 * x2
    return (
        jnp.sin(x0) * jnp.cos(x1) * jnp.exp(x2),
        1.0 / ((x0 + x1) ** 2 + 0.003) * jnp.cos(x1) * jnp.exp(x2),
        1.0 / (3.75 - jnp.cos(np.pi * x0) - jnp.cos(np.pi * x1)
               - jnp.cos(np.pi * x2)),
        jnp.abs(rsq - 0.125),
        jnp.exp(-rsq),
        1.0 / (1.0 - x0 * x1 * x2 + 1e-10),
        jnp.sqrt(jnp.abs(x0 - x1 - x2)),
        jnp.exp(-x0 * x1 * x2),
        x0 * x0 / (jnp.cos(x0 + x1 + x2 + 1.0) + 5.0),
        jnp.where(x0 > 0.5,
                  1.0 / jnp.sqrt(x0 * x1 * x2 + 1e-5),
                  jnp.sqrt(x0 * x1 * x2)),
        jnp.where(rsq < 1.0, 1.0, 0.0),
    )


def scan_flat_cost(neval):
    """Per-step wall time of :mcmc vs integrand count N=1..11.

    The reference evaluates only the current integrand per step
    (src/mcmc/montecarlo.jl:138-139), so steps/s should stay ~flat in N —
    the property SURVEY.md §5 requires.  The XLA scan evaluates all N
    integrands and selects (solvers/mcmc.py), so its cost grows with N.
    """
    import jax

    print("devices:", jax.devices(), flush=True)
    rows = []
    # N>11 cycles the component list with distinct scale factors — the
    # huge-bundle regime (SURVEY §5: per-step cost ⊥ N)
    for n in (1, 2, 4, 8, 11, 16, 32):
        fi = (lambda idx, x, c, n=n:
              test2(x, c)[idx % 11] * (1.0 + idx / (2.0 * n)))
        kw = dict(var=Continuous(0.0, 1.0), dof=[[3]] * n, neval=neval,
                  solver="mcmc", verbose=-2, seed=3)
        integrate(fi, niter=2, **kw)             # compile + train warmup
        t0 = time.time()
        res = integrate(fi, niter=5, **kw)
        dt = time.time() - t0
        steps = res.neval
        rows.append((n, steps / dt / 1e6, dt))
        print(f"  N={n:>2}: {steps/dt/1e6:8.2f} M steps/s "
              f"({n*steps/dt/1e6:8.1f} M component-capacity/s), "
              f"wall {dt:.2f}s", flush=True)
    base = rows[0][1]
    worst = min(r[1] for r in rows)
    print(f"flatness: slowest/N=1 = {worst/base:.2f} "
          f"(1.0 = perfectly flat per-step cost)")


def main():
    import jax
    if len(sys.argv) > 1 and sys.argv[1] == "--scan":
        neval = int(float(sys.argv[2])) if len(sys.argv) > 2 else 300_000_000
        scan_flat_cost(neval)
        return
    print("devices:", jax.devices(), flush=True)
    neval = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000
    solver = sys.argv[2] if len(sys.argv) > 2 else "vegas"
    fi = (lambda idx, x, c: test2(x, c)[idx]) if solver == "mcmc" else test2

    # warmup/compile
    integrate(fi, var=Continuous(0.0, 1.0), dof=[[3]] * 11, neval=neval,
              niter=2, solver=solver, verbose=-2, seed=3)
    t0 = time.time()
    res = integrate(fi, var=Continuous(0.0, 1.0), dof=[[3]] * 11, neval=neval,
                    niter=10, solver=solver, verbose=-2, seed=3)
    dt = time.time() - t0
    steps = res.neval
    print(f"solver :{solver}  neval={neval:.0e} x 10  wall {dt:.3f}s "
          f"=> {steps/dt/1e6:.2f} M steps/s, {11*steps/dt/1e6:.1f} M "
          f"component-evals/s")
    print(f"  (reference :vegas @1e5: 0.246 s/iterset => ~0.41 M steps/s)")
    for i in range(11):
        m = float(np.asarray(res.mean[i]))
        s = float(np.asarray(res.stdev[i]))
        c = CUBA_VEGAS[i]
        print(f"  f{i+1:>2}: {m:12.7f} ± {s:.7f}   cuba {c:12.7f} "
              f"({abs(m-c)/max(s,1e-12):5.1f}σ)")


if __name__ == "__main__":
    main()
