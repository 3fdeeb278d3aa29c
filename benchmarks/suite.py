"""Accuracy-anchor benchmark suite.

Runs the reference's headline benchmark integrals (BASELINE.md; reference
example/benchmark/vegas/benchmark{1,2,3,4}.jl + README quick-start) at the
published evaluation budgets and prints a comparison table against the
published numbers of the reference, classic Vegas, Vegas+ and Cuba.

Run: python benchmarks/suite.py [solver]
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


def bench(name, integrand, exact, neval, dof, solver, lower=0.0, upper=1.0,
          niter=10, n_int=1, published=""):
    t0 = time.time()
    res = integrate(integrand, var=Continuous(lower, upper), dof=dof,
                    neval=neval, niter=niter, solver=solver, verbose=-2,
                    seed=33)
    dt = time.time() - t0
    rows = []
    for i in range(n_int):
        m = float(np.asarray(res.mean[i]))
        s = float(np.asarray(res.stdev[i]))
        e = exact[i] if isinstance(exact, (list, tuple)) else exact
        rows.append((m, s, e, abs(m - e) / max(s, 1e-15)))
    print(f"\n== {name}  (neval={neval:.0e} x {niter}, :{solver}, {dt:.1f}s)")
    if published:
        print(f"   published: {published}")
    for i, (m, s, e, ns) in enumerate(rows):
        print(f"   ours[{i}]: {m:.6f} ± {s:.6f}   exact {e:.6f}   ({ns:.1f}σ)")
    return res


def main():
    solver = sys.argv[1] if len(sys.argv) > 1 else "vegas"

    # benchmark2.jl: ∫₀¹ log(x)/√x dx = −4 @1e6
    bench("singular log(x)/sqrt(x)",
          lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0]),
          -4.0, int(1e6), [[1]], solver,
          published="Vegas+ −3.999953(24); Cuba −3.99816(44); "
                    "reference(:vegas) −4.0166(184) 'fails'")

    # benchmark1.jl: ∭ 1/(1−cos x cos y cos z)/π³ = 1.3932039 @2e6
    # stable float32 form: 1−ca·cb·cc = s2a + ca·s2b + ca·cb·s2c with
    # s2t = 2 sin²(t/2) (avoids catastrophic cancellation near the corner)
    def f_sing3(x, c):
        ca, cb, cc = jnp.cos(x[0]), jnp.cos(x[1]), jnp.cos(x[2])
        s2a = 2 * jnp.sin(x[0] / 2) ** 2
        s2b = 2 * jnp.sin(x[1] / 2) ** 2
        s2c = 2 * jnp.sin(x[2] / 2) ** 2
        denom = s2a + ca * s2b + ca * cb * s2c
        return 1.0 / denom / np.pi**3

    bench("3-D singular 1/(1-cosx cosy cosz)/pi^3",
          f_sing3,
          1.3932039296856768, int(2e6), [[3]], solver, upper=np.pi,
          published="Vegas+ 1.39314(15); Cuba 1.39223(109); "
                    "reference(:vegas) 1.39612(818)")

    # benchmark4.jl: 4-D Gaussian, normalized to 1 @1e6
    bench("4-D Gaussian (normalized)",
          lambda x, c: jnp.exp(-100.0 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2
                                         + (x[2] - 0.5) ** 2
                                         + (x[3] - 0.5) ** 2))
          * 1013.2118364296088,
          1.0, int(1e6), [[4]], solver,
          published="Vegas+ 1.00025(32); Cuba 1.000062(293); "
                    "reference 0.99198(648)")

    # benchmark3.jl: three simultaneous 4-D Gaussian moments @1e5
    def f3(x, c):
        dx2 = ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2 + (x[2] - 0.5) ** 2
               + (x[3] - 0.5) ** 2)
        f = jnp.exp(-200.0 * dx2) * 1000.0
        return f, f * x[0], f * x[0] ** 2

    # analytic: I0 = 1000*(pi/200)^2, <x> = 1/2, <x^2> = 1/4 + 1/400
    i0 = 1000.0 * (np.pi / 200.0) ** 2
    bench("3 simultaneous 4-D Gaussian moments",
          f3, [i0, i0 / 2, i0 * 0.2525], int(1e5),
          [[4], [4], [4]], solver, n_int=3,
          published="classic Vegas 0.24631(65)/0.12316(33)/0.06220(17); "
                    "Cuba 0.246816(298)/...; 'reference currently fails'")

    # README quick-start: π/4 quarter circle at defaults
    bench("quarter circle pi/4",
          lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
          np.pi / 4, int(1e4), [[2]], solver,
          published="reference 0.786012 ± 0.002323 (chi2=2.14)")


if __name__ == "__main__":
    main()
