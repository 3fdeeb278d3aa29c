"""Error-bar honesty regression gates for the fused chain kernel.

The error bars of the :vegasmc chain kernel (ops/pallas_chain.py) are
computed from the block spread; these tests turn "the reported error is
honest" into a regression gate:

- `test_chain_error_bar_honesty`: over 16 seeds, the empirical spread of
  the estimate matches the mean reported stderr (ratio gate ~±40%; the
  fixed seeds make the test deterministic).  Production-length runs on
  the GPU go through `benchmarks/honesty.py`.
- `test_chain_short_chain_inflation`: at short chains the kernel's
  reported error must stay within 2.5x of the XLA path's — and honest.

Reference behavior being matched: block-spread error bars,
/root/reference/src/vegas_mc/montecarlo.jl:233-241 + src/statistics.jl.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration.configuration import Configuration
from mcintegration.models.variable import Continuous
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.vegasmc import VegasMCIteration

EXACT = np.pi / 4


def _pi(x, c):
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _estimate(it, seed):
    """(mean, stderr) the way Result computes them: block-ratio spread."""
    st = it.run(it.spec.device_params(), jax.random.key(seed))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    return float(m.mean()), float(m.std(ddof=1) / np.sqrt(len(m)))


@pytest.mark.slow
def test_chain_error_bar_honesty():
    """Empirical seed-to-seed spread ≈ mean reported stderr (chain kernel)."""
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=1)
    spec = Spec(cfg)
    # 4096 walkers, 512 steps/walker: keeps 16 interpret-mode runs
    # within the CI budget
    it = VegasMCIteration(spec, _pi, block=4, nevalperblock=2 ** 19,
                          backend="pallas", nwalkers=4096)
    assert it.backend == "pallas"
    means, errs = [], []
    for seed in range(16):
        m, e = _estimate(it, 100 + seed)
        means.append(m)
        errs.append(e)
    means = np.asarray(means)
    errs = np.asarray(errs)
    # all runs must also be statistically correct
    z = (means - EXACT) / errs
    assert np.all(np.abs(z) < 6.0), z
    # honesty ratio: empirical spread vs mean reported variance.  Var over
    # 16 seeds has 15 dof and mean(err^2) pools 16x3 block dof, so under
    # honest errors r concentrates near 1 with sd ~0.2; the gate catches a
    # systematic 1.5x+ under- or over-estimate while staying deterministic
    # (fixed seeds).
    r = np.sqrt(means.var(ddof=1) / np.mean(errs ** 2))
    assert 0.75 < r < 1.6, (
        f"reported error bars dishonest: spread/reported = {r:.2f} "
        f"(spread {means.std(ddof=1):.2e}, reported {np.mean(errs):.2e})")


@pytest.mark.slow
def test_chain_short_chain_inflation():
    """Short chains: kernel error bars may inflate vs XLA (≤2.5x), and the
    kernel estimate stays within its own (inflated) error."""
    res = {}
    for be in ("pallas", "xla"):
        cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=2)
        spec = Spec(cfg)
        it = VegasMCIteration(spec, _pi, block=4, nevalperblock=2 ** 17,
                              backend=be, nwalkers=4096)
        assert it.backend == be
        ms, es = zip(*(_estimate(it, 200 + s) for s in range(2)))
        res[be] = (np.mean(ms), np.mean(es))
    mp, ep = res["pallas"]
    _, ex = res["xla"]
    assert abs(mp - EXACT) < 6 * ep, (mp, ep)
    # short-chain inflation stays bounded
    assert ep < 2.5 * ex, f"short-chain inflation {ep / ex:.2f}x exceeds 2.5x"
