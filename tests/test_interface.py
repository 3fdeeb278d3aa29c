"""Interface smoke tests (mirrors reference test/interface_tests.jl)."""

import time

import numpy as np
import jax.numpy as jnp

from mcintegration import Continuous, integrate


def test_unknown_kwargs_swallowed():
    # unknown kwargs flow into Configuration(**kwargs) and are ignored
    # (reference test/interface_tests.jl:1-6)
    res = integrate(lambda x, c: x[0], neval=2048, niter=2, verbose=-2,
                    solver="vegas", vars=Continuous(0.0, 1.0), seed=1)
    assert np.isfinite(float(np.asarray(res.mean[0])))


def test_userdata_passthrough():
    res = integrate(lambda x, c: x[0] * c.userdata, neval=4096, niter=3,
                    var=Continuous(0.0, 1.0), dof=[[1]], userdata=2.0,
                    solver="vegas", verbose=-2, seed=2)
    assert abs(float(np.asarray(res.mean[0])) - 1.0) < 0.05


def test_result_indexing_and_repr():
    res = integrate(lambda x, c: x[0], neval=4096, niter=3,
                    var=Continuous(0.0, 1.0), dof=[[1]],
                    solver="vegas", verbose=-2, seed=3)
    m, e, c = res[0]
    assert np.isfinite(float(np.asarray(m)))
    assert "Integral" in repr(res)
    assert res.neval > 0


def test_solver_symbol_colon_prefix():
    # accept ':vegas' spelling for familiarity with the reference API
    res = integrate(lambda x, c: x[0], neval=2048, niter=2,
                    var=Continuous(0.0, 1.0), dof=[[1]],
                    solver=":vegas", verbose=-2, seed=4)
    assert np.isfinite(float(np.asarray(res.mean[0])))


def test_full_config_snapshots_and_midhistory_warm_start():
    """Result.iterations carries full deep-copied configs (reference
    src/statistics.jl:16-23): trained grids evolve across snapshots, and
    any mid-history snapshot warm-starts a new integrate() call."""
    from mcintegration.configuration import Configuration

    def f(x, c):
        return -jnp.log(jnp.maximum(x[0], 1e-30)) \
            / jnp.sqrt(jnp.maximum(x[0], 1e-30)) / 4.0

    res = integrate(f, var=Continuous(0.0, 1.0), dof=[[1]], neval=2 ** 14,
                    niter=4, solver="vegas", verbose=-2, seed=5)
    snaps = [h[2] for h in res.iterations]
    assert all(isinstance(s, Configuration) for s in snaps)
    # Result.neval sums per-iteration counts
    assert res.neval == sum(s.neval for s in snaps)
    # adaptive training reshapes the grid between snapshots
    g0 = snaps[0].var[0].grid
    g3 = snaps[3].var[0].grid
    assert g0.shape == g3.shape and not np.allclose(g0, g3)
    # snapshots are decoupled from the live config
    live = res.config.var[0].grid
    snaps[0].var[0].grid[:] = 0.0
    assert not np.allclose(snaps[0].var[0].grid, live)

    # warm-start from the iteration-2 snapshot
    res2 = integrate(f, config=snaps[2], neval=2 ** 14, niter=3,
                     verbose=-2, solver="vegas")
    m = float(np.asarray(res2.mean[0]))
    e = float(np.asarray(res2.stdev[0]))
    assert abs(m - 1.0) < 10 * max(e, 1e-9)


def test_midrun_timer_polls():
    """With timers active, each iteration splits into sub-dispatches and
    polls the timers with live tallies (reference polls every 1000 steps,
    src/vegas_mc/montecarlo.jl:233-237)."""
    calls = []

    class Probe:
        def check(self, cfg, *a):
            calls.append(int(cfg.neval))

    integrate(lambda x, c: x[0], neval=2 ** 14, niter=2,
              var=Continuous(0.0, 1.0), dof=[[1]], solver="vegasmc",
              verbose=-2, seed=6, timer=[Probe()])
    # nsplit=4: 3 mid-iteration polls + 1 end-of-iteration poll per iter
    assert len(calls) == 8, calls
    assert calls[0] < calls[3] <= calls[-1]


def test_wall_clock_timer_resplit():
    """The sub-dispatch split is a wall-clock policy: when iterations run
    long relative to the shortest timer interval, iterations 2+ re-split
    so `print`-second report intervals are honored regardless of
    iteration length (reference: in-loop StopWatch poll every 1000 steps,
    src/utility/stopwatch.jl:11-29)."""
    from mcintegration.utils import StopWatch

    common = dict(neval=2 ** 21, niter=3, block=4,
                  var=Continuous(0.0, 1.0), dof=[[1]], solver="vegasmc",
                  verbose=-2, seed=6, nwalkers=4096, backend="xla")

    # calibrate: sampling wall time per iteration, post-compile
    marks = []
    integrate(lambda x, c: x[0],
              timer=[StopWatch(1e9, lambda *a: None)],
              **{**common, "niter": 2})
    t0 = time.time()
    integrate(lambda x, c: x[0] * 1.0,
              timer=[type("P", (), {"check":
                                    lambda self, *a: marks.append(1)})()],
              **common)
    t_iter = (time.time() - t0) / 3          # incl. its own compile: upper
    interval = max(t_iter / 8, 0.02)         # ~8 polls/iteration wanted

    calls = []
    watch = StopWatch(interval, lambda cfg, *a: calls.append(time.time()))
    t0 = time.time()
    integrate(lambda x, c: x[0] * 1.0, timer=[watch], **common)
    spanned = time.time() - t0
    # a fixed nsplit=4 fires at most 4 polls/iteration; the wall-clock
    # policy must fire substantially during iterations 2-3 after the
    # resplit.  Gate well below the ideal spanned/interval to stay
    # deterministic across machine speeds.
    required = max(3, min(8, int(spanned / interval / 4)))
    assert len(calls) >= required, (len(calls), required, interval, spanned)


def test_kernel_cache_reuse_and_isolation():
    """Repeated integrate() calls over the same problem shape reuse the
    compiled kernel (main._KERNEL_CACHE) without changing results; a
    different integrand, seed, or userdata must NOT reuse it (userdata is
    baked into the trace as a constant).  Julia-JIT analog: montecarlo
    compiles once per method signature per session."""
    import numpy as np
    import jax.numpy as jnp
    from mcintegration import Continuous, integrate
    from mcintegration.main import _KERNEL_CACHE, _cache_key
    from mcintegration.configuration import Configuration

    f = lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)

    def run(seed=7):
        return integrate(f, var=Continuous(0.0, 1.0), dof=[[2]],
                         neval=20000, niter=2, solver="vegas",
                         verbose=-2, seed=seed)

    r1 = run()
    n0 = len(_KERNEL_CACHE)
    r2 = run()                      # hit: no new entry, identical result
    assert len(_KERNEL_CACHE) == n0
    assert np.array_equal(np.asarray(r1.mean), np.asarray(r2.mean))
    r3 = run(seed=8)                # different seed -> different key
    assert not np.array_equal(np.asarray(r2.mean), np.asarray(r3.mean))

    # userdata disables caching entirely (captured as a trace constant)
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=7,
                        userdata=2.0)
    assert _cache_key(cfg, "vegas", f, None, mesh=None, npb=1) is None

    # a different integrand function object must never alias the cache
    g = lambda x, c: x[0] * 0.0 + 0.25
    rg = integrate(g, var=Continuous(0.0, 1.0), dof=[[2]], neval=20000,
                   niter=2, solver="vegas", verbose=-2, seed=7)
    assert abs(float(np.asarray(rg.mean)[0]) - 0.25) < 1e-3

    # vegasplus holds run-to-run state (lane/chunk allocation) AND reads
    # trained grids through self.spec on its fused path: a cache hit must
    # reset the former and rebind the latter — caught live as a
    # non-deterministic cached second call before the round-4 fix
    def run_vp():
        return integrate(f, var=Continuous(0.0, 1.0), dof=[[2]],
                         neval=2 ** 16, niter=3, solver="vegasplus",
                         verbose=-2, seed=9)

    v1, v2 = run_vp(), run_vp()
    assert np.array_equal(np.asarray(v1.mean), np.asarray(v2.mean))


def test_cache_closure_mutation_not_stale():
    """A lambda reading a mutated closure cell must NOT silently reuse the
    stale compiled kernel (jit-style bake-in, made safe: the cache key
    folds a content hash of captured state — main._callable_sig)."""
    from mcintegration import integrate

    scale = [1.0]

    def make(s):
        return lambda x, c: x[0] * 0.0 + s

    # closure cell with a float: cacheable, keyed on the value
    f1 = make(1.0)
    r1 = integrate(f1, var=Continuous(0.0, 1.0), dof=[[1]], neval=4096,
                   niter=2, solver="vegas", verbose=-2, seed=11)
    assert abs(float(np.asarray(r1.mean)[0]) - 1.0) < 0.05

    # same function OBJECT, mutated captured state via __defaults__-free
    # path: use a callable object whose attribute changes
    class F:
        def __init__(self):
            self.s = 1.0

        def __call__(self, x, c):
            return x[0] * 0.0 + self.s

    g = F()
    ra = integrate(g, var=Continuous(0.0, 1.0), dof=[[1]], neval=4096,
                   niter=2, solver="vegas", verbose=-2, seed=11)
    g.s = 2.0
    rb = integrate(g, var=Continuous(0.0, 1.0), dof=[[1]], neval=4096,
                   niter=2, solver="vegas", verbose=-2, seed=11)
    assert abs(float(np.asarray(ra.mean)[0]) - 1.0) < 0.1
    assert abs(float(np.asarray(rb.mean)[0]) - 2.0) < 0.1, \
        "stale kernel reused after callable attribute mutation"

    # unhashable captured state refuses to cache rather than guessing
    from mcintegration.main import _callable_sig

    class Opaque:
        __slots__ = ("x",)
    h = (lambda o: lambda x, c: (o, x[0])[1])(Opaque())
    assert _callable_sig(h) is None

    # cache=False escape hatch + clear_kernel_cache drains entries
    from mcintegration import clear_kernel_cache
    from mcintegration.main import _KERNEL_CACHE
    n0 = len(_KERNEL_CACHE)
    integrate(make(3.0), var=Continuous(0.0, 1.0), dof=[[1]], neval=4096,
              niter=2, solver="vegas", verbose=-2, seed=11, cache=False)
    assert len(_KERNEL_CACHE) == n0
    clear_kernel_cache()
    assert len(_KERNEL_CACHE) == 0


def test_result_backend_surfaced():
    """Result.backend records the compute path; fallbacks carry a reason
    (round-5: a user must be able to tell which path ran and why)."""
    from mcintegration import integrate

    # on the CPU test mesh, auto routes to XLA with an explanatory reason
    res = integrate(lambda x, c: x[0], var=Continuous(0.0, 1.0), dof=[[1]],
                    neval=4096, niter=2, solver="vegas", verbose=-2, seed=5)
    assert res.backend == "xla"
    assert res.backend_reason  # a human-readable explanation is recorded

    # custom measures run on the XLA path, with a measure reason
    def ms_bad(vars, relw, c):
        return [jnp.zeros(()) + jnp.sum(relw[0])]   # couples samples

    res2 = integrate(lambda x, c: x[0], var=Continuous(0.0, 1.0), dof=[[1]],
                     neval=2 ** 19, niter=2, solver="vegas", verbose=-2,
                     seed=5, measure=ms_bad, obs=[0.0], backend="pallas")
    assert res2.backend == "xla"
    assert "measure" in res2.backend_reason

    # forced interpret-mode pallas reports backend='pallas', empty reason
    res3 = integrate(lambda x, c: x[0] * 0.0 + 1.0, var=Continuous(0.0, 1.0),
                     dof=[[1]], neval=2 ** 19, niter=2, solver="vegas",
                     verbose=-2, seed=5, backend="pallas")
    assert res3.backend == "pallas" and res3.backend_reason == ""

    # derived Result(res, ignore) keeps the provenance
    from mcintegration import Result
    assert Result(res3, 1).backend == "pallas"


def test_kernel_routing_reasons():
    """Which path each solver takes, and the reason it records: the fused
    kernels run natively only on a CUDA GPU; on the CPU they run only when
    forced (interpret mode); :mcmc and :vegasplus have no kernel."""
    from mcintegration.configuration import Configuration
    from mcintegration.solvers.engine import Spec
    from mcintegration.solvers.mcmc import MCMCIteration
    from mcintegration.solvers.vegas import VegasIteration
    from mcintegration.solvers.vegasmc import VegasMCIteration
    from mcintegration.solvers.vegasplus import VegasPlusIteration

    def spec():
        return Spec(Configuration(var=Continuous(0.0, 1.0), dof=[[2]],
                                  seed=3))

    f = lambda x, c: x[0] * x[1]
    for cls in (VegasIteration, VegasMCIteration):
        auto = cls(spec(), f, block=4, nevalperblock=2 ** 12)
        assert auto.backend == "xla" and "no GPU" in auto.backend_reason
        forced = cls(spec(), f, block=4, nevalperblock=2 ** 12,
                     backend="pallas")
        assert forced.backend == "pallas" and forced.backend_reason == ""
        asked = cls(spec(), f, block=4, nevalperblock=2 ** 12,
                    backend="xla")
        assert asked.backend_reason == "backend='xla' requested"
    it = MCMCIteration(spec(), lambda i, x, c: x[0], block=4,
                       nevalperblock=2 ** 12, backend="pallas")
    assert it.backend == "xla" and "no fused kernel" in it.backend_reason
    it = VegasPlusIteration(spec(), f, block=4, nevalperblock=2 ** 12,
                            backend="pallas")
    assert it.backend == "xla" and "no fused kernel" in it.backend_reason
    # no kernel asked for, none missed: no reason to print
    it = VegasPlusIteration(spec(), f, block=4, nevalperblock=2 ** 12)
    assert it.backend_reason == ""

