"""Fused Triton kernels (ops/pallas_vegas.py, ops/pallas_chain.py).

On the CPU the kernels run under the Pallas interpreter (``backend=
"pallas"`` forces them), which executes every kernel line with the same
counter-hash RNG as the GPU.  What only the card can say — Triton's code
generation and the speed — is covered by ``chip_smoke.py``; the lowering
to Triton IR is checked here by exporting the kernels for CUDA.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration.configuration import Configuration
from mcintegration.models.variable import CompositeVar, Continuous, Discrete
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.vegas import VegasIteration
from mcintegration.solvers.vegasmc import VegasMCIteration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pi(x, c):
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _run(it, seed=3):
    st = it.run(it.spec.device_params(), jax.random.key(seed))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    return st, m.mean(), m.std(ddof=1) / np.sqrt(len(m))


# ---------------------------------------------------------------------------
# :vegas stratified kernel
# ---------------------------------------------------------------------------

def test_pallas_pi_statistical():
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=1)
    spec = Spec(cfg)
    it = VegasIteration(spec, _pi, block=8, nevalperblock=2 ** 15,
                        backend="pallas")
    assert it.backend == "pallas"
    st, mean, err = _run(it)
    assert abs(mean - np.pi / 4) < 7 * max(err, 1e-9)
    # histogram collected for training
    assert st["hists"][0].sum() > 0


def test_pallas_matches_xla_statistically():
    res = {}
    for be in ("xla", "pallas"):
        cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=5)
        spec = Spec(cfg)
        it = VegasIteration(spec, _pi, block=8, nevalperblock=2 ** 15,
                            backend=be)
        _, mean, err = _run(it)
        res[be] = (mean, err)
    d = abs(res["xla"][0] - res["pallas"][0])
    s = np.hypot(res["xla"][1], res["pallas"][1])
    assert d < 7 * max(s, 1e-9)


def test_pallas_deterministic_same_seed():
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=1)
    spec = Spec(cfg)
    it = VegasIteration(spec, _pi, block=4, nevalperblock=2 ** 14,
                        backend="pallas")
    p = spec.device_params()
    a = it.run(p, jax.random.key(9))
    b = it.run(p, jax.random.key(9))
    assert np.array_equal(a["obs_blocks"], b["obs_blocks"])
    assert np.array_equal(a["hists"][0], b["hists"][0])


def test_pallas_padding_multi_integrand():
    # two integrands with different dof: exercises the padding factors
    def f(x, c):
        return (x[0], jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[1], [2]], seed=2)
    spec = Spec(cfg)
    it = VegasIteration(spec, f, block=8, nevalperblock=2 ** 15,
                        backend="pallas")
    assert it.backend == "pallas"
    st = it.run(spec.device_params(), jax.random.key(4))
    m0 = st["obs_blocks"][:, 0] / st["norm_blocks"]
    m1 = st["obs_blocks"][:, 1] / st["norm_blocks"]
    e0 = m0.std(ddof=1) / np.sqrt(8)
    e1 = m1.std(ddof=1) / np.sqrt(8)
    assert abs(m0.mean() - 0.5) < 7 * max(e0, 1e-9)
    assert abs(m1.mean() - np.pi / 4) < 7 * max(e1, 1e-9)


def test_pallas_fallbacks_to_xla():
    def build(var, f, **kw):
        spec = Spec(Configuration(var=var, dof=kw.pop("dof", [[2]]),
                                  seed=1, **kw.pop("cfg", {})))
        return VegasIteration(spec, f, block=4, nevalperblock=2 ** 12,
                              backend="pallas", **kw)

    # Discrete leaf cannot stratify -> xla
    it = build((Continuous(0.0, 1.0), Discrete(1, 10)),
               lambda x, c: x[0][0] * 1.0, dof=[[1, 1]])
    assert it.backend == "xla" and "Discrete" in it.backend_reason
    # measurefreq > 1 -> xla
    it = build(Continuous(0.0, 1.0), _pi, measurefreq=2)
    assert it.backend == "xla" and "measurefreq" in it.backend_reason
    # complex weights -> xla
    it = build(Continuous(0.0, 1.0), lambda x, c: jnp.exp(1j * x[0]),
               weight_dtype=jnp.complex64, cfg={"type": complex})
    assert it.backend == "xla" and "complex64" in it.backend_reason

    # non-elementwise integrand (couples samples) -> caught by the
    # validate_batched equivalence probe -> xla
    def bad(x, c):
        return x[0] * jnp.mean(jnp.asarray(x))

    it = build(Continuous(0.0, 1.0), bad)
    assert it.backend == "xla" and "probe" in it.backend_reason


def test_pallas_integrate_end_to_end():
    """Full adaptive run through integrate() with the kernel."""
    from mcintegration.main import integrate

    res = integrate(lambda x, c: -jnp.log(jnp.maximum(x[0], 1e-30))
                    / jnp.sqrt(jnp.maximum(x[0], 1e-30)) / 4.0,
                    var=Continuous(0.0, 1.0), dof=[[1]], neval=2 ** 16,
                    niter=4, block=8, verbose=-2, seed=11,
                    solver="vegas", backend="pallas")
    assert res.backend == "pallas"
    mean = float(np.asarray(res.mean[0]))
    err = float(np.asarray(res.stdev[0]))
    assert abs(mean - 1.0) < 10 * max(err, 1e-9)


def test_vegas_pallas_custom_measure():
    """Custom measures route :vegas to the XLA path, which bins a vector
    observable by a quartile index exactly."""
    from mcintegration import onehot

    def f(x, c):
        return x[0] * x[1]

    def meas(v, relw, c):
        q = jnp.clip((v[0] * 4).astype(jnp.int32), 0, 3)
        return [onehot(q, 0, 3, relw[0].dtype) * relw[0]]

    exact = np.array([(2 * k + 1) / 64.0 for k in range(4)])
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=5,
                        obs=[np.zeros(4)])
    spec = Spec(cfg)
    it = VegasIteration(spec, f, block=8, nevalperblock=2 ** 15,
                        backend="pallas", measure=meas,
                        obs_proto=[np.zeros(4)])
    assert it.backend == "xla" and "measure" in it.backend_reason
    st = it.run(spec.device_params(), jax.random.key(3))
    m = np.asarray(st["obs_blocks"][0]) / np.asarray(st["norm_blocks"])[:, None]
    mean, err = m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(len(m))
    for k in range(4):
        assert abs(mean[k] - exact[k]) < 10 * max(err[k], 1e-4), \
            (k, mean[k], exact[k], err[k])


# ---------------------------------------------------------------------------
# the kernels' building blocks
# ---------------------------------------------------------------------------

def test_rng_stream_independent_of_program_layout():
    """The counter-hash bits of a (key, counter) pair are the same whatever
    program draws them: 256 counters drawn by 1, 4 or 16 programs."""
    from jax.experimental import pallas as pl

    from mcintegration.ops.pallas_vegas import (random_bits, salt_of,
                                                    stream_keys)

    def draw(nprog):
        width = 256 // nprog

        def kernel(kd_ref, o_ref):
            k1, k2 = stream_keys(kd_ref[0], kd_ref[1], jnp.int32(3))
            p = pl.program_id(0)
            ctr = (p * width + jax.lax.broadcasted_iota(
                jnp.int32, (width,), 0)).astype(jnp.uint32)
            o_ref[pl.ds(p * width, width)] = random_bits(k1, k2, salt_of(5),
                                                         ctr)

        return np.asarray(pl.pallas_call(
            kernel, grid=(nprog,), backend="triton", interpret=True,
            out_shape=jax.ShapeDtypeStruct((256,), jnp.uint32))(
                jnp.asarray([123, 456], jnp.uint32)))

    ref = draw(1)
    assert len(np.unique(ref)) == 256
    for nprog in (4, 16):
        assert np.array_equal(draw(nprog), ref), nprog


def test_partials_reduce_to_one_program_sums():
    """Per-program partials of the :vegas kernel add up to the sums one
    program computes over the same chunks (same draws, another grouping)."""
    from mcintegration.ops import pallas_vegas

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[1], [2]], seed=4)
    spec = Spec(cfg)
    f = lambda x, c: (x[0], _pi(x, c))
    plans = VegasIteration(spec, f, block=2, nevalperblock=2 ** 14,
                           backend="xla").plans
    eval_b = pallas_vegas.make_eval_batched(spec, f, False, jnp.float32)
    kd = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(2), 2)))
    outs = {}
    for g, p in ((4, 1), (1, 4), (2, 2)):
        run = pallas_vegas.build_run_all(spec, plans, eval_b, m=4,
                                         chunks_per_program=g, programs=p,
                                         interpret=True)
        outs[(g, p)] = jax.device_get(run(spec.device_params(), kd))
    obs0, norm0, hists0 = outs[(4, 1)]
    for key, (obs, norm, hists) in outs.items():
        np.testing.assert_allclose(obs, obs0, rtol=2e-6, err_msg=str(key))
        np.testing.assert_array_equal(norm, norm0)
        np.testing.assert_allclose(hists[0], hists0[0], rtol=2e-6)


def test_add_in_order_independent_of_block_count():
    """The partial sums of a block are the same bits whatever rows sit
    beside it — the property that makes :vegas mesh-size invariant."""
    from mcintegration.ops.pallas_vegas import add_in_order

    x = jax.random.normal(jax.random.key(0), (16, 13, 5)) * 1e3
    full = np.asarray(jax.jit(add_in_order)(x))
    for rows in (1, 4, 8):
        part = np.asarray(jax.jit(add_in_order)(x[:rows]))
        assert np.array_equal(part, full[:rows]), rows
    np.testing.assert_allclose(full, np.asarray(x, np.float64).sum(axis=1),
                               rtol=1e-5, atol=1e-2)


def test_onehot_hist_matches_bincount():
    """hist2d of the split-bfloat16 one-hot product equals a float64
    bincount to f32 accuracy, over weights spanning 40 decades."""
    from mcintegration.ops.pallas_vegas import onehot_hist

    rng = np.random.default_rng(3)
    bins = rng.integers(0, 1000, 64)
    w = np.exp(rng.uniform(-45, 45, 64)).astype(np.float32)
    h = np.asarray(onehot_hist(jnp.asarray(bins, jnp.int32),
                               jnp.asarray(w), 32)).reshape(-1)
    want = np.bincount(bins, weights=w.astype(np.float64), minlength=1024)
    np.testing.assert_allclose(h, want, rtol=1e-6)


def test_histogram_unpermute_exact():
    """Each chunk scatters its strata rows back through a bijection: with
    a flat map and a constant integrand every bin gets exactly the same
    weight, including a ninc that is not a multiple of the tile rows."""
    for ninc in (1024, 100):
        cfg = Configuration(var=Continuous(0.0, 1.0, ninc=ninc), dof=[[2]],
                            seed=3)
        spec = Spec(cfg)
        it = VegasIteration(spec, lambda x, c: x[0] * 0.0 + 1.0, block=2,
                            nevalperblock=ninc * 64, backend="pallas")
        assert it.backend == "pallas"
        st = it.run(spec.device_params(), jax.random.key(1))
        h = st["hists"][0]
        assert h.shape == (ninc,)
        # 2 slots x 2 blocks x samples per bin, weight (w*jac)^2 = 1
        assert np.all(h == h[0]), np.unique(h)
        assert h[0] == 2 * 2 * it.nevalperblock // ninc


@pytest.mark.parametrize("nevalperblock", [2 ** 10, 2 ** 15, 10 ** 6,
                                           3 * 10 ** 7])
def test_chunk_layout_tiles(nevalperblock):
    """Tile choice: power-of-two samples per stratum (<= M_MAX, the XLA
    path's stratification unit), enough programs to fill the card, and a
    budget rounded up by less than one chunk per program."""
    from mcintegration.ops import pallas_vegas as pv

    nb = 1024
    m, g, p = pv.chunk_layout(nb, nevalperblock, 16)
    assert m & (m - 1) == 0 and 1 <= m <= pv.M_MAX
    assert 16 * p <= pv.PROGRAMS_PER_DEVICE or p == 1
    total = nb * m * g * p
    assert total >= nevalperblock
    assert total < nevalperblock + nb * m * g


def test_chain_walkers_layout():
    from mcintegration.ops import pallas_chain as pc

    nprog, nsteps = pc.chain_walkers(10 ** 8, 16, None, 256)
    assert 16 * nprog * pc.WALKERS == pc.MAX_WALKERS
    assert nsteps == 10 ** 8 // pc.MAX_WALKERS
    nprog, nsteps = pc.chain_walkers(2 ** 20, 4, 8192, 256)
    assert (nprog, nsteps) == (8192 // (4 * pc.WALKERS), 128)
    # tiny budgets still get one program per block and >= 8 steps
    assert pc.chain_walkers(100, 4, None, 256) == (1, 8)


def test_kahan_add_compensates_long_sums():
    """The kernels' Neumaier add (ops/ksum.py, inside a fori_loop as in
    the kernels) keeps f32 running sums exact where the naive sum drifts
    systematically (constant-magnitude increments at 2^16 adds; the
    reference accumulates in f64, montecarlo.jl:158-170)."""
    from mcintegration.ops import ksum

    inc = jnp.float32(1.0 / 3.0)          # full-mantissa constant increment
    n = 1 << 16

    def step(_, c):
        acc, naive = c
        return ksum.kadd(acc, inc), naive + inc

    acc, naive = jax.lax.fori_loop(
        0, n, step, (ksum.kzeros(()), jnp.float32(0.0)))
    exact = n / 3.0
    kahan_err = abs(float(acc.value) - exact)
    naive_err = abs(float(naive) - exact)
    assert kahan_err < 1e-2, kahan_err               # O(1 ulp of the total)
    assert naive_err > 10 * max(kahan_err, 1e-3), (naive_err, kahan_err)


def _export_for_cuda(fn, *args):
    """Lower ``fn`` for CUDA on this host: Pallas emits the Triton IR of
    every kernel, so an op the Triton route cannot express fails here."""
    return jax.export.export(
        jax.jit(fn), platforms=("cuda",),
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)


_LOWER_CASES = {
    "pi": (Continuous(0.0, 1.0), [[2]], _pi),
    "padding": (Continuous(0.0, 1.0), [[1], [2]],
                lambda x, c: (x[0], _pi(x, c))),
    "offset-ninc100": (Continuous(0.0, 1.0, ninc=100, offset=1), [[2]],
                       lambda x, c: jnp.exp(-x[0]) * jnp.sin(x[1] + x[2])),
    "composite": (CompositeVar(Continuous(0.0, 1.0), Continuous(1.0, 2.0)),
                  [[1]], lambda x, c: jnp.log(x[1][0]) * x[0][0] ** 2),
}


@pytest.mark.parametrize("case", sorted(_LOWER_CASES))
@pytest.mark.parametrize("kernel", ["vegas", "chain"])
def test_kernels_lower_for_cuda(kernel, case):
    from mcintegration.ops import pallas_chain, pallas_vegas

    var, dof, f = _LOWER_CASES[case]
    spec = Spec(Configuration(var=var, dof=dof, seed=5))
    eval_b = pallas_vegas.make_eval_batched(spec, f, False, jnp.float32)
    if kernel == "vegas":
        nb = spec.leaves[0].leaf.ninc
        plans = VegasIteration(spec, f, block=4, nevalperblock=nb * 32,
                               backend="xla").plans
        assert pallas_vegas.eligible(spec, plans, measure=None,
                                     measurefreq=1,
                                     weight_dtype=jnp.float32)
        run = pallas_vegas.build_run_all(spec, plans, eval_b, m=8,
                                         chunks_per_program=2, programs=3)
    else:
        assert pallas_chain.chain_eligible(spec, measure=None,
                                           weight_dtype=jnp.float32)
        run = pallas_chain.build_chain_run_all(spec, eval_b, programs=2,
                                               nsteps=16, mf=2, warmup=3)
    exp = _export_for_cuda(run, spec.device_params(),
                           np.zeros((4, 2), np.uint32))
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


# ---------------------------------------------------------------------------
# :vegasmc chain kernel
# ---------------------------------------------------------------------------

def test_chain_matches_xla_statistically():
    res = {}
    for be in ("xla", "pallas"):
        cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=5)
        spec = Spec(cfg)
        it = VegasMCIteration(spec, _pi, block=4, nevalperblock=2 ** 15,
                              backend=be, nwalkers=8192)
        assert it.backend == be
        st = it.run(spec.device_params(), jax.random.key(3))
        m = st["obs_blocks"][:, 0] / st["norm_blocks"]
        acc = st["accept"][1, 0, 0] / max(st["propose"][1, 0, 0], 1)
        res[be] = (m.mean(), m.std(ddof=1) / 2, acc)
    d = abs(res["xla"][0] - res["pallas"][0])
    s = np.hypot(res["xla"][1], res["pallas"][1])
    assert d < 7 * max(s, 1e-9)
    # chain law parity: acceptance rates agree closely
    assert abs(res["xla"][2] - res["pallas"][2]) < 0.02


def test_chain_fallbacks():
    def build(var, f, dof=((2,),), **kw):
        spec = Spec(Configuration(var=var, dof=[list(r) for r in dof],
                                  seed=1, **kw.pop("cfg", {})))
        return VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 12,
                                backend="pallas", nwalkers=4096, **kw)

    # any Continuous ninc is served directly (the map draw is a gather)
    assert build(Continuous(0.0, 1.0, ninc=1000), _pi).backend == "pallas"
    # Discrete pools, custom measures and complex weights -> xla
    it = build((Continuous(0.0, 1.0), Discrete(1, 4)),
               lambda x, c: x[0][0], dof=((1, 1),))
    assert it.backend == "xla" and "Discrete" in it.backend_reason
    it = build(Continuous(0.0, 1.0), _pi, measure=lambda v, r, c: [r[0]],
               obs_proto=[np.zeros(())], cfg={"obs": [np.zeros(())]})
    assert it.backend == "xla" and "measure" in it.backend_reason
    it = build(Continuous(0.0, 1.0), lambda x, c: jnp.exp(1j * x[0]),
               weight_dtype=jnp.complex64, cfg={"type": complex})
    assert it.backend == "xla" and "complex64" in it.backend_reason
    # a grid too fine for the register histogram -> xla
    it = build(Continuous(0.0, 1.0, ninc=8192), _pi)
    assert it.backend == "xla" and "ninc" in it.backend_reason


def test_chain_discrete_pool_statistical():
    """Discrete pools run on the XLA scan (CDF inversion)."""
    def f(x, c):
        t, d = x
        return t[0] * d[0].astype(jnp.float32)

    cfg = Configuration(var=(Continuous(0.0, 1.0), Discrete(1, 4)),
                        dof=[[1, 1]], seed=3)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 15,
                          nwalkers=8192)
    assert it.backend == "xla"
    st = it.run(spec.device_params(), jax.random.key(6))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    # sum_d int t*d dt = 0.5*(1+2+3+4) = 5
    assert abs(m.mean() - 5.0) < 10 * max(err, 0.05), (m.mean(), err)


def test_discrete_cdf_draw_exact_law():
    """The Discrete draw (ops/grid.sample_discrete_cdf) reproduces the
    exact inverse-CDF law gidx = #{k: u >= cdf[k+1]} (sampler.jl:13-22)
    and the matching bin probability, for nbin both at a power of two and
    ragged."""
    from mcintegration.ops.grid import sample_discrete_cdf
    from mcintegration.ops.lookup import pack_table

    rng = np.random.default_rng(7)
    for nbin in (100, 128, 33, 1024):
        w = rng.dirichlet(np.ones(nbin) * 0.2)     # skewed distribution
        cdf = np.concatenate([[0.0], np.cumsum(w)]).astype(np.float32)
        dist = cdf[1:] - cdf[:-1]
        u = rng.uniform(0, 1, (8, 128)).astype(np.float32)
        gidx, prob = sample_discrete_cdf(
            jnp.asarray(u), jnp.asarray(cdf),
            jnp.asarray(pack_table(dist), jnp.float32), nbin)
        want = np.minimum((u[..., None] >= cdf[None, None, 1:]).sum(-1),
                          nbin - 1)
        assert np.array_equal(np.asarray(gidx), want), nbin
        np.testing.assert_allclose(np.asarray(prob), dist[want], rtol=1e-6)


def test_discrete_cdf_draw_clamps_into_last_real_bin():
    """u >= f32(cdf[nbin]) must land in the last REAL bin, never a pad
    bin: f32 rounding of the cumulative sum can leave cdf[nbin] < 1
    (the reference's `locate` returns the last bin, common.jl:8-36)."""
    from mcintegration.ops.grid import sample_discrete_cdf
    from mcintegration.ops.lookup import pack_table

    nbin = 100
    cdf = np.linspace(0.0, 1.0, nbin + 1).astype(np.float32)
    cdf[-1] = np.nextafter(np.float32(1.0), np.float32(0.0))
    u = np.full((8, 128), np.nextafter(np.float32(1.0), np.float32(0.0)),
                np.float32)
    gidx, prob = sample_discrete_cdf(
        jnp.asarray(u), jnp.asarray(cdf),
        jnp.asarray(pack_table(cdf[1:] - cdf[:-1]), jnp.float32), nbin)
    assert int(np.asarray(gidx).max()) == nbin - 1
    assert float(np.asarray(prob).min()) > 0.0


def test_chain_wide_discrete_pi_series():
    """'Discrete(1,100) pi Taylor series' on :vegasmc (XLA scan)."""
    NB = 100

    def f(x, c):
        n = x[0].astype(jnp.float32)
        return 4.0 * jnp.where(jnp.mod(n, 2.0) == 1.0, 1.0, -1.0) \
            / (2.0 * n - 1.0)

    exact = float(sum(4 * (-1) ** (k + 1) / (2 * k - 1)
                      for k in range(1, NB + 1)))  # ~3.13159
    cfg = Configuration(var=Discrete(1, NB), dof=[[1]], seed=3)
    spec = Spec(cfg)
    # 256 steps/walker + 25% warmup: signed 100-bin chains need room to
    # equilibrate before the ratio estimator is trustworthy
    it = VegasMCIteration(spec, f, block=2, nevalperblock=2 ** 18,
                          backend="pallas", nwalkers=2048, warmup=0.25)
    assert it.backend == "xla" and "Discrete" in it.backend_reason
    st = it.run(spec.device_params(), jax.random.key(6))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    assert abs(m.mean() - exact) < 10 * max(err, 0.05), (m.mean(), err)


def test_chain_custom_measure_vector_obs():
    """Vector measure by a Discrete external index (the bubble shape), on
    the XLA scan."""
    Q = 3

    def f(x, c):
        t, d = x
        return t[0] + 0.1 * d[0].astype(jnp.float32)

    def meas(v, relw, c):
        t, d = v
        onehot = (jnp.arange(1, Q + 1) == d[0]).astype(relw.dtype)
        return [onehot * relw[0]]

    obs = [np.zeros(Q)]
    cfg = Configuration(var=(Continuous(0.0, 1.0), Discrete(1, Q)),
                        dof=[[1, 1]], seed=4, obs=obs)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 15,
                          backend="pallas", nwalkers=8192,
                          measure=meas, obs_proto=obs)
    assert it.backend == "xla"
    st = it.run(spec.device_params(), jax.random.key(8))
    nb = st["norm_blocks"]
    ob = st["obs_blocks"][0]          # [block, Q]
    for q in range(Q):
        m = ob[:, q] / nb
        err = m.std(ddof=1) / np.sqrt(len(m))
        exact = 0.5 + 0.1 * (q + 1)   # int (t + 0.1 d) dt at d = q+1
        assert abs(m.mean() - exact) < 10 * max(err, 0.02), (q, m.mean(), err)


def test_chain_measurefreq():
    """measurefreq > 1 runs on the chain kernel."""
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=5)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, _pi, block=4, nevalperblock=2 ** 15,
                          backend="pallas", nwalkers=8192, measurefreq=3)
    assert it.backend == "pallas"
    st = it.run(spec.device_params(), jax.random.key(3))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    assert abs(m.mean() - np.pi / 4) < 10 * max(err, 5e-3)


def test_chain_complex_statistical():
    """Complex integrands run on the XLA scan and match the exact
    quarter-disc phase integral (src/statistics.jl:24-55)."""
    def fc(x, c):
        inside = jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
        return inside * jnp.exp(1j * (x[0] + x[1]))

    # dblquad of e^{i(x+y)} over the quarter disc
    EXACT = 0.4930385477642199 + 0.5622057316603964j
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=5,
                        type=complex)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, fc, block=4, nevalperblock=2 ** 15,
                          backend="pallas", nwalkers=8192,
                          weight_dtype=jnp.complex64)
    assert it.backend == "xla"
    st = it.run(spec.device_params(), jax.random.key(3))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    assert np.iscomplexobj(m)
    mean = m.mean()
    err = (m.real.std(ddof=1) + 1j * m.imag.std(ddof=1)) / 2
    assert abs(mean.real - EXACT.real) < 10 * max(err.real, 1e-9)
    assert abs(mean.imag - EXACT.imag) < 10 * max(err.imag, 1e-9)


def test_chain_complex_custom_measure():
    """Complex vector observable through a custom measure (the oscillatory
    bubble shape: Continuous time + Discrete external index)."""
    Q = 3

    def f(x, c):
        t, d = x
        return jnp.exp(1j * t[0])

    def meas(v, relw, c):
        t, d = v
        onehot = (jnp.arange(1, Q + 1) == d[0]).astype(jnp.float32)
        return [onehot * relw[0]]

    # per external index q: int_0^1 e^{it} dt = sin(1) + i(1 - cos(1))
    exact = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))
    obs = [np.zeros(Q, np.complex64)]
    cfg = Configuration(var=(Continuous(0.0, 1.0), Discrete(1, Q)),
                        dof=[[1, 1]], seed=4, obs=obs, type=complex)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 15,
                          nwalkers=8192, weight_dtype=jnp.complex64,
                          measure=meas, obs_proto=obs)
    st = it.run(spec.device_params(), jax.random.key(8))
    nb = st["norm_blocks"]
    ob = st["obs_blocks"][0]          # [block, Q] complex
    assert np.iscomplexobj(ob)
    for q in range(Q):
        m = ob[:, q] / nb
        er = m.real.std(ddof=1) / np.sqrt(len(m))
        ei = m.imag.std(ddof=1) / np.sqrt(len(m))
        assert abs(m.mean().real - exact.real) < 10 * max(er, 0.02), (q, m)
        assert abs(m.mean().imag - exact.imag) < 10 * max(ei, 0.02), (q, m)


def test_chain_integrate_adaptive():
    from mcintegration.main import integrate

    res = integrate(lambda x, c: -jnp.log(jnp.maximum(x[0], 1e-30))
                    / jnp.sqrt(jnp.maximum(x[0], 1e-30)) / 4.0,
                    var=Continuous(0.0, 1.0), dof=[[1]], neval=2 ** 16,
                    niter=4, block=4, verbose=-2, seed=11,
                    solver="vegasmc", backend="pallas", nwalkers=4096)
    assert res.backend == "pallas"
    mean = float(np.asarray(res.mean[0]))
    err = float(np.asarray(res.stdev[0]))
    assert abs(mean - 1.0) < 10 * max(err, 1e-9)


@pytest.mark.parametrize("ninc", [7, 100, 1000, 2048])
def test_chain_any_ninc(ninc):
    """Any Continuous ninc runs on the chain kernel (each walker gathers
    its own bin), the histogram comes back at the grid's resolution, and
    adaptation reshapes the grid."""
    from mcintegration import integrate

    f = lambda x, c: 3.0 * x[0] ** 2
    spec = Spec(Configuration(var=Continuous(0.0, 1.0, ninc=ninc),
                              dof=[[1]], seed=5))
    it = VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 14,
                          backend="pallas", nwalkers=4096)
    assert it.backend == "pallas", it.backend_reason
    st = it.run(spec.device_params(), jax.random.key(3))
    assert st["hists"][0].shape == (ninc,)
    assert st["hists"][0].sum() > 0
    r = integrate(f, var=Continuous(0.0, 1.0, ninc=ninc), dof=[[1]],
                  neval=2 ** 16, niter=4, solver="vegasmc", backend="pallas",
                  nwalkers=4096, parallel="none", block=4, verbose=-2,
                  seed=11)
    assert r.backend == "pallas", r.backend_reason
    g = r.config.var[0].grid
    assert len(g) - 1 == ninc
    assert not np.allclose(g, np.linspace(0, 1, ninc + 1))
    m = float(np.asarray(r.mean[0]))
    e = float(np.asarray(r.stdev[0]))
    assert abs(m - 1.0) < 12 * max(e, 2e-3), (m, e)


def test_pallas_sharded_over_mesh():
    """Both kernels compose with shard_map over the CPU mesh."""
    from mcintegration.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    if ndev < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(ndev)

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=1)
    spec = Spec(cfg)
    it = VegasIteration(spec, _pi, block=2 * ndev, nevalperblock=2 ** 14,
                        mesh=mesh, backend="pallas")
    assert it.backend == "pallas"
    st = it.run(spec.device_params(), jax.random.key(3))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    assert abs(m.mean() - np.pi / 4) < 7 * max(err, 1e-9)

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=2)
    spec = Spec(cfg)
    it = VegasMCIteration(spec, _pi, block=ndev, nevalperblock=2 ** 15,
                          mesh=mesh, backend="pallas", nwalkers=ndev * 2048)
    assert it.backend == "pallas"
    st = it.run(spec.device_params(), jax.random.key(4))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    assert abs(m.mean() - np.pi / 4) < 10 * max(err, 1e-9)


def test_vegas_kernel_mesh_size_invariance(monkeypatch):
    """Same seed, 1 vs 4 devices: the :vegas kernel's per-block results
    and the histograms the host adds are the same bits — including when
    a block's chunks are split over several programs."""
    from mcintegration import integrate
    from mcintegration.ops import pallas_vegas
    from mcintegration.parallel.mesh import make_mesh

    # 2 programs x 2 chunks per block (16 strata x 128 samples per chunk)
    monkeypatch.setattr(pallas_vegas, "PROGRAMS_PER_DEVICE", 16)
    runs = []
    for mesh in (None, make_mesh(4)):
        runs.append(integrate(_pi, var=Continuous(0.0, 1.0, ninc=16),
                              dof=[[2]],
                              neval=2 ** 16, niter=3, block=8,
                              solver="vegas", backend="pallas", mesh=mesh,
                              parallel="none", verbose=-2, seed=17))
    a, b = runs
    assert a.backend == b.backend == "pallas"
    assert np.array_equal(np.asarray(a.mean[0]), np.asarray(b.mean[0]))
    assert np.array_equal(np.asarray(a.stdev[0]), np.asarray(b.stdev[0]))
    assert np.array_equal(a.config.var[0].grid, b.config.var[0].grid)


# ---------------------------------------------------------------------------
# GPU-facing checks that run here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["vegasmc", "mcmc"])
def test_exact_contractions(solver):
    """Every float contraction of the Markov XLA scans asks for HIGHEST
    precision: on the GPU a default-precision dot may run in TF32 and
    round the tallies and histogram weights to ~3 digits."""
    from mcintegration.solvers.mcmc import MCMCIteration

    spec = Spec(Configuration(var=Continuous(0.0, 1.0), dof=[[1], [2]],
                              seed=3))
    if solver == "mcmc":
        it = MCMCIteration(spec, lambda i, x, c: x[0] + i, block=2,
                           nevalperblock=256, nwalkers=16)
    else:
        it = VegasMCIteration(spec, lambda x, c: (x[0], x[0] * x[1]),
                              block=2, nevalperblock=256, nwalkers=16,
                              backend="xla")
    jaxpr = jax.make_jaxpr(it.raw_fn)(spec.device_params(),
                                      np.zeros((1, 2), np.uint32))
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general" and jnp.issubdtype(
                    eqn.invars[0].aval.dtype, jnp.floating):
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    assert found
    high = jax.lax.Precision.HIGHEST
    assert all(p == (high, high) for p in found), found


@pytest.mark.parametrize("script,where", [("chip_smoke.py", "checkout"),
                                          ("chip_smoke.py", "alone"),
                                          ("bench.py", "checkout")])
def test_chip_smoke_refuses_cpu(script, where, tmp_path):
    """chip_smoke.py and bench.py exit non-zero and print no result line
    on a host whose JAX runs on the CPU; chip_smoke.py also outside a
    checkout of the repository."""
    path = os.path.join(REPO, script)
    if where == "alone":
        alone = tmp_path / script
        alone.write_text(open(path).read())
        path, cwd = str(alone), str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, path], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0, out.stdout
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
