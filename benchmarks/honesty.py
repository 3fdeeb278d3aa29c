"""Error-bar honesty of the :vegasmc chain at production scale.

Over N seeds, compares the empirical seed-to-seed spread of the estimate
with the mean reported stderr (block-spread error bars, the same statistic
Result reports).  Honest errors give ratio r ~= 1 +- 1/sqrt(2N) — the
sampling uncertainty of r itself is printed with each row, because it is
the dominant effect at small N.  The :vegasmc rows run the fused chain
kernel on a GPU; the :mcmc rows run its XLA scan.  CI gate:
tests/test_honesty.py.

Run: python benchmarks/honesty.py [nseeds]   (nseeds scales the per-row
seed count; the default gives +-0.044 resolution at 32768 steps)
Reference statistic being validated: block error bars,
/root/reference/src/vegas_mc/montecarlo.jl:233-241 + src/statistics.jl.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mcintegration.platform import configure_jax

configure_jax(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from mcintegration.configuration import Configuration
from mcintegration.models.variable import Continuous
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.vegasmc import VegasMCIteration

EXACT = np.pi / 4


def _pi(x, c):
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def honesty(nsteps: int, nseeds: int, nwalkers: int = 8192, block: int = 8,
            solver: str = "vegasmc"):
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=1)
    spec = Spec(cfg)
    if solver == "mcmc":
        from mcintegration.solvers.mcmc import MCMCIteration

        it = MCMCIteration(spec, lambda i, x, c: _pi(x, c), block=block,
                           nevalperblock=nwalkers * nsteps // block,
                           nwalkers=nwalkers, thermal_ratio=0.2)
    else:
        it = VegasMCIteration(spec, _pi, block=block,
                              nevalperblock=nwalkers * nsteps // block,
                              nwalkers=nwalkers)
        assert it.backend == "pallas", it.backend_reason
    means, errs = [], []
    t0 = time.time()
    for seed in range(nseeds):
        st = it.run(spec.device_params(), jax.random.key(1000 + seed))
        m = st["obs_blocks"][:, 0] / st["norm_blocks"]
        means.append(float(m.mean()))
        errs.append(float(m.std(ddof=1) / np.sqrt(len(m))))
    dt = time.time() - t0
    means, errs = np.asarray(means), np.asarray(errs)
    z = (means - EXACT) / errs
    r = np.sqrt(means.var(ddof=1) / np.mean(errs ** 2))
    return {
        "steps_per_walker": nsteps,
        "spread": float(means.std(ddof=1)),
        "reported": float(np.mean(errs)),
        "ratio": float(r),
        "max_abs_z": float(np.max(np.abs(z))),
        "evals_per_s": nseeds * it.neval / dt,
    }


def main():
    base = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    if base < 8:
        sys.exit(f"usage: {sys.argv[0]} [nseeds >= 8] (got {base}; the "
                 "spread estimate needs >= 2 seeds per row)")
    print(f"8192 walkers, :vegasmc chain kernel, "
          f"2-D pi integrand (exact {EXACT:.6f})")
    print(f"{'steps/walker':>13s} {'nseeds':>6s} {'spread':>10s} "
          f"{'reported':>10s} {'ratio':>12s} {'max|z|':>7s} {'Mevals/s':>9s}")
    # more seeds at longer chains: the ratio's own noise 1/sqrt(2N) is the
    # dominant effect there
    for nsteps, nseeds in ((512, base // 4), (4096, base // 2),
                           (32768, base)):
        h = honesty(nsteps, nseeds)
        sd = 1 / np.sqrt(2 * nseeds)
        print(f"{h['steps_per_walker']:13d} {nseeds:6d} {h['spread']:10.2e} "
              f"{h['reported']:10.2e} {h['ratio']:7.2f}+-{sd:.2f} "
              f"{h['max_abs_z']:7.2f} {h['evals_per_s'] / 1e6:9.0f}")
    print("honest errors: ratio ~= 1 within its printed +- band")


if __name__ == "__main__":
    main()
