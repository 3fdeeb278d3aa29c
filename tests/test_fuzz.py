"""Property-based spec fuzz: kernel/XLA parity over random problem shapes.

Round-5 response to a pattern of boundary bugs (the wide-Discrete clamp
fix, the vegasplus cache-hit fix): instead of hand-picking shapes, sample
random specs — pool kinds and counts, dof tables including dof < maxdof,
offsets, composite bundles, nbin across the {31, 32, 33, 1000, 1024}
eligibility boundaries, real/complex weights, measurefreq — and assert,
for each Markov solver:

1. **eligibility-probe consistency**: constructing the same iteration
   twice makes the same fused/XLA routing decision and identical results
   for the same seed (determinism);
2. **statistical parity**: when the fused kernel is eligible, its estimate
   agrees with the XLA path at kσ on the same spec.

A fixed-seed subset runs in CI; set MCI_FUZZ_N=<n> (and optionally
MCI_FUZZ_SEED) for a wider nightly-style sweep.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration.configuration import Configuration
from mcintegration.models.variable import CompositeVar, Continuous, Discrete
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.mcmc import MCMCIteration
from mcintegration.solvers.vegasmc import VegasMCIteration

FUZZ_N = int(os.environ.get("MCI_FUZZ_N", "4"))
FUZZ_SEED = int(os.environ.get("MCI_FUZZ_SEED", "20260821"))


def sample_spec(rng):
    """Random (var tuple, dof table, complex?, measurefreq) spec."""
    nincs = [32, 128, 1024, 1000, 31]          # incl. non-power-of-two
    nbins = [2, 31, 32, 33, 200, 1000, 1024]
    pools = []
    npools = rng.integers(1, 3)
    for _ in range(npools):
        kind = rng.choice(["cont", "disc", "composite"])
        offset = int(rng.integers(0, 2))
        if kind == "cont":
            lo = float(rng.uniform(-1.0, 0.5))
            hi = lo + float(rng.uniform(0.5, 2.0))
            pools.append(Continuous(lo, hi, ninc=int(rng.choice(nincs)),
                                    offset=offset))
        elif kind == "disc":
            lo = int(rng.integers(-3, 3))
            pools.append(Discrete(lo, lo + int(rng.choice(nbins)) - 1,
                                  offset=offset))
        else:
            lo = float(rng.uniform(0.0, 0.5))
            pools.append(CompositeVar(
                Continuous(lo, lo + 1.0, ninc=int(rng.choice(nincs))),
                Discrete(1, int(rng.choice([3, 5, 32]))),
            ))
    n_int = int(rng.integers(1, 4))
    maxdof = [int(rng.integers(1, 3)) for _ in pools]
    dof = [[int(rng.integers(0 if n_int > 1 else 1, m + 1))
            for m in maxdof] for _ in range(n_int)]
    # at least one integrand uses the max dof of each pool so maxdof holds
    for g, m in enumerate(maxdof):
        dof[rng.integers(0, n_int)][g] = m
    # every integrand must own at least one slot
    for row in dof:
        if all(d == 0 for d in row):
            row[int(rng.integers(0, len(row)))] = 1
    cplx = bool(rng.integers(0, 2))
    mf = int(rng.choice([1, 1, 2]))
    return tuple(pools), dof, cplx, mf


def sample_kernel_spec(rng):
    """Random spec inside the fused kernels' scope: Continuous pools only
    (plain, offset, or a Continuous composite), one shared ninc (the :vegas
    kernel stratifies all pools alike), real weights, measurefreq."""
    ninc = int(rng.choice([32, 100, 128, 1000, 1024]))
    pools = []
    for _ in range(int(rng.integers(1, 3))):
        lo = float(rng.uniform(-1.0, 0.5))
        if rng.integers(0, 3) == 0:
            pools.append(CompositeVar(
                Continuous(lo, lo + 1.0, ninc=ninc),
                Continuous(0.0, 2.0, ninc=ninc)))
        else:
            pools.append(Continuous(lo, lo + float(rng.uniform(0.5, 2.0)),
                                    ninc=ninc,
                                    offset=int(rng.integers(0, 2))))
    n_int = int(rng.integers(1, 4))
    maxdof = [int(rng.integers(1, 3)) for _ in pools]
    dof = [[int(rng.integers(0 if n_int > 1 else 1, m + 1))
            for m in maxdof] for _ in range(n_int)]
    for g, m in enumerate(maxdof):
        dof[rng.integers(0, n_int)][g] = m
    for row in dof:
        if all(d == 0 for d in row):
            row[int(rng.integers(0, len(row)))] = 1
    return tuple(pools), dof, False, int(rng.choice([1, 1, 2]))


def make_integrand(spec, cplx, mcmc, salt):
    """Deterministic smooth integrand over every slot the spec owns."""
    nvar = len(spec.cfg.var)
    # per (group, member) view offset: fixed (user-pinned) slots come first
    # in the view, MC-owned slots start at the leaf's offset
    offs = [[spec.leaves[lidx].offset for lidx in spec.group_leaves[g]]
            for g in range(nvar)]

    def body(view, i):
        groups = (view,) if nvar == 1 else view
        acc = 0.19 + 0.01 * salt + 0.05 * i
        for g, v in enumerate(groups):
            members = v if isinstance(v, tuple) else (v,)
            for mi, x in enumerate(members):
                for s in range(len_dof(spec, i, g)):
                    xv = x[offs[g][mi] + s]
                    if xv.dtype.kind == "i":
                        xv = xv.astype(jnp.float32)
                    acc = acc + 0.3 * jnp.cos(
                        0.7 * xv + 0.2 * g + 0.13 * mi + 0.1 * s)
        if cplx:
            return jnp.exp(1j * acc * 0.5) * (1.5 + jnp.cos(acc))
        return 1.5 + jnp.cos(acc)

    if mcmc:
        return lambda i, x, c: body(x, i)
    if spec.N == 1:
        return lambda x, c: body(x, 0)
    return lambda x, c: tuple(body(x, i) for i in range(spec.N))


def len_dof(spec, i, g):
    return int(spec.dof_np[i][g])


def _estimate(st, n, cplx):
    nb = np.asarray(st["norm_blocks"])
    if not (nb > 0).all():
        # a statistically norm-starved spec (e.g. wide Discrete pools make
        # the norm sector ~1/nbin-suppressed without reweight adaptation):
        # the raw obs/norm estimate is undefined; parity is skipped for
        # this case while determinism/eligibility checks still ran
        return None, None
    ob = np.asarray(st["obs_blocks"])
    means, errs = [], []
    for i in range(n):
        m = ob[:, i] / nb
        means.append(m.mean())
        if np.iscomplexobj(m):
            errs.append((m.real.std(ddof=1) + 1j * m.imag.std(ddof=1))
                        / np.sqrt(len(m)))
        else:
            errs.append(m.std(ddof=1) / np.sqrt(len(m)))
    return means, errs


def _parity(mA, eA, mB, eB, k=7.0, floor=5e-3):
    for a, ea, b, eb in zip(mA, eA, mB, eB):
        if np.iscomplexobj(np.asarray(a)) or np.iscomplexobj(np.asarray(b)):
            sr = np.hypot(np.real(ea), np.real(eb))
            si = np.hypot(np.imag(ea), np.imag(eb))
            assert abs(np.real(a) - np.real(b)) < k * max(sr, floor), \
                (a, ea, b, eb)
            assert abs(np.imag(a) - np.imag(b)) < k * max(si, floor), \
                (a, ea, b, eb)
        else:
            s = np.hypot(ea, eb)
            assert abs(a - b) < k * max(s, floor), (a, ea, b, eb)


def _run_case(Iteration, case_idx, mcmc=False):
    rng = np.random.default_rng(FUZZ_SEED + 1000 * case_idx + int(mcmc))
    pools, dof, cplx, mf = sample_spec(rng)
    cfg = Configuration(var=pools, dof=dof, seed=int(rng.integers(1, 2**31)),
                        **({"type": complex} if cplx else {}))
    spec = Spec(cfg)
    f = make_integrand(spec, cplx, mcmc, case_idx)
    wd = jnp.complex64 if cplx else jnp.float32
    # mcmc needs longer chains: the scheduled kernel enters the norm
    # sector via a rare per-step coin (~1/(deg*C*N) per walker-step), and
    # an empty norm block makes the estimate inf
    kw = dict(block=4, nevalperblock=2 ** 16 if mcmc else 2 ** 13,
              nwalkers=4096, measurefreq=mf, weight_dtype=wd)

    results = {}
    for be in ("xla", "pallas"):
        its = [Iteration(spec, f, backend=be, **kw) for _ in range(2)]
        # eligibility-probe consistency: same decision both times
        assert its[0].backend == its[1].backend, \
            (be, its[0].backend_reason, its[1].backend_reason)
        sts = [it.run(spec.device_params(), jax.random.key(11))
               for it in its]
        # determinism: same seed, same construction -> identical blocks
        np.testing.assert_array_equal(np.asarray(sts[0]["obs_blocks"]),
                                      np.asarray(sts[1]["obs_blocks"]))
        results[be] = (its[0].backend, *_estimate(sts[0], spec.N, cplx))

    be_p, mP, eP = results["pallas"]
    _, mX, eX = results["xla"]
    # statistical parity whenever the fused kernel actually engaged and
    # the spec is not norm-starved on either path
    if be_p == "pallas" and mP is not None and mX is not None:
        _parity(mP, eP, mX, eX)
    return be_p


@pytest.mark.parametrize("case_idx", range(FUZZ_N))
def test_fuzz_vegasmc(case_idx):
    _run_case(VegasMCIteration, case_idx, mcmc=False)


@pytest.mark.parametrize("case_idx", range(FUZZ_N))
def test_fuzz_mcmc(case_idx):
    def Iteration(spec, f, backend, block, nevalperblock, nwalkers,
                  measurefreq, weight_dtype):
        return MCMCIteration(spec, f, backend=backend, block=block,
                             nevalperblock=nevalperblock, nwalkers=nwalkers,
                             measurefreq=measurefreq,
                             weight_dtype=weight_dtype, thermal_ratio=0.3)

    _run_case(Iteration, case_idx, mcmc=True)


def _kernel_case(case_idx):
    rng = np.random.default_rng(FUZZ_SEED + 1000 * case_idx + 29)
    pools, dof, cplx, mf = sample_kernel_spec(rng)
    spec = Spec(Configuration(var=pools, dof=dof,
                              seed=int(rng.integers(1, 2**31))))
    return spec, make_integrand(spec, cplx, False, case_idx), mf


@pytest.mark.parametrize("case_idx", range(FUZZ_N))
def test_fuzz_kernels(case_idx):
    """Random specs inside the kernels' scope: both kernels engage (the
    :vegas one unless measurefreq > 1), run deterministically, and agree
    with the XLA path."""
    from mcintegration.solvers.vegas import VegasIteration

    spec, f, mf = _kernel_case(case_idx)
    for cls, kw in ((VegasMCIteration, {"nwalkers": 4096}),
                    (VegasIteration, {})):
        results = {}
        for be in ("xla", "pallas"):
            its = [cls(spec, f, backend=be, block=4, nevalperblock=2 ** 13,
                       measurefreq=mf, **kw) for _ in range(2)]
            sts = [it.run(spec.device_params(), jax.random.key(11))
                   for it in its]
            np.testing.assert_array_equal(
                np.asarray(sts[0]["obs_blocks"]),
                np.asarray(sts[1]["obs_blocks"]))
            results[be] = (its[0].backend,
                           *_estimate(sts[0], spec.N, False))
        want = "xla" if cls is VegasIteration and mf > 1 else "pallas"
        assert results["pallas"][0] == want, (cls.__name__, mf)
        _parity(*results["pallas"][1:], *results["xla"][1:])


def test_fuzz_engages_fused_path_somewhere():
    """The sampled CI subsets must exercise each fused kernel at least
    once — otherwise the parity half of the fuzz is vacuous."""
    from mcintegration.solvers.vegas import VegasIteration

    hits = {"chain": 0, "vegas": 0}
    for case_idx in range(FUZZ_N):
        spec, f, mf = _kernel_case(case_idx)
        hits["chain"] += VegasMCIteration(
            spec, f, backend="pallas", block=4, nevalperblock=2 ** 13,
            nwalkers=4096, measurefreq=mf).backend == "pallas"
        hits["vegas"] += VegasIteration(
            spec, f, backend="pallas", block=4, nevalperblock=2 ** 13,
            measurefreq=mf).backend == "pallas"
    assert hits["chain"] > 0 and hits["vegas"] > 0, hits


@pytest.mark.parametrize("case_idx", range(FUZZ_N))
def test_fuzz_vegas(case_idx):
    """The :vegas importance sampler over the same random spec pool:
    routing consistency, determinism, and fused/XLA parity (the fused
    kernel engages only for all-Continuous specs with a stratification
    plan; everything else must agree XLA-vs-XLA deterministically)."""
    from mcintegration.solvers.vegas import VegasIteration

    rng = np.random.default_rng(FUZZ_SEED + 1000 * case_idx + 7)
    pools, dof, cplx, mf = sample_spec(rng)
    cfg = Configuration(var=pools, dof=dof, seed=int(rng.integers(1, 2**31)),
                        **({"type": complex} if cplx else {}))
    spec = Spec(cfg)
    f = make_integrand(spec, cplx, False, case_idx)
    wd = jnp.complex64 if cplx else jnp.float32

    results = {}
    for be in ("xla", "pallas"):
        its = [VegasIteration(spec, f, backend=be, block=4,
                              nevalperblock=2 ** 13, measurefreq=mf,
                              weight_dtype=wd) for _ in range(2)]
        assert its[0].backend == its[1].backend, \
            (be, its[0].backend_reason, its[1].backend_reason)
        sts = [it.run(spec.device_params(), jax.random.key(11))
               for it in its]
        np.testing.assert_array_equal(np.asarray(sts[0]["obs_blocks"]),
                                      np.asarray(sts[1]["obs_blocks"]))
        results[be] = (its[0].backend, *_estimate(sts[0], spec.N, cplx))

    be_p, mP, eP = results["pallas"]
    _, mX, eX = results["xla"]
    if be_p == "pallas" and mP is not None and mX is not None:
        _parity(mP, eP, mX, eX)


@pytest.mark.parametrize("case_idx", range(FUZZ_N))
def test_fuzz_vegasplus(case_idx):
    """The :vegasplus solver over the same random spec pool.  Specs it
    declares unsupported (pure-Discrete, >10 stratified dims) are skipped
    via its own NotImplementedError; everything else must route
    consistently, run deterministically, and agree across backends."""
    from mcintegration.solvers.vegasplus import VegasPlusIteration

    rng = np.random.default_rng(FUZZ_SEED + 1000 * case_idx + 13)
    pools, dof, cplx, mf = sample_spec(rng)
    cfg = Configuration(var=pools, dof=dof, seed=int(rng.integers(1, 2**31)),
                        **({"type": complex} if cplx else {}))
    spec = Spec(cfg)
    f = make_integrand(spec, cplx, False, case_idx)
    wd = jnp.complex64 if cplx else jnp.float32

    results = {}
    for be in ("xla", "pallas"):
        try:
            its = [VegasPlusIteration(spec, f, backend=be, block=4,
                                      nevalperblock=2 ** 13,
                                      measurefreq=mf, weight_dtype=wd)
                   for _ in range(2)]
        except NotImplementedError as e:
            pytest.skip(f"spec unsupported by :vegasplus: {e}")
        assert its[0].backend == its[1].backend, \
            (be, its[0].backend_reason, its[1].backend_reason)
        sts = [it.run(spec.device_params(), jax.random.key(11))
               for it in its]
        np.testing.assert_array_equal(np.asarray(sts[0]["obs_blocks"]),
                                      np.asarray(sts[1]["obs_blocks"]))
        results[be] = (its[0].backend, *_estimate(sts[0], spec.N, cplx))

    be_p, mP, eP = results["pallas"]
    _, mX, eX = results["xla"]
    if be_p == "pallas" and mP is not None and mX is not None:
        _parity(mP, eP, mX, eX)
