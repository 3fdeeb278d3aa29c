""":mcmc solver semantics on the XLA scan (solvers/mcmc.py): multiple
integrands with changeIntegrand jumps, Discrete and FermiK pools, complex
weights, custom measures, tallies, determinism and the device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration import onehot
from mcintegration.configuration import Configuration
from mcintegration.models.variable import Continuous, Discrete, FermiK
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.mcmc import MCMCIteration


def _mk_mcmc(integrand, *, dof, seed, neval, ninc=128, var=None,
             nwalkers=2048, thermal=0.3, **kw):
    cfg = Configuration(var=var if var is not None
                        else Continuous(0.0, 1.0, ninc=ninc),
                        dof=dof, seed=seed, **kw.pop("cfg", {}))
    spec = Spec(cfg)
    it = MCMCIteration(spec, integrand, block=2, nevalperblock=neval // 2,
                       nwalkers=nwalkers, thermal_ratio=thermal, **kw)
    assert it.backend == "xla"
    return spec, it


def _blocks(st, i=0):
    m = st["obs_blocks"][:, i] / st["norm_blocks"]
    return m.mean(), m.std(ddof=1) / np.sqrt(len(m))


def _pi_i(i, x, c):
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1, 1.0, 0.0)


def _f2(i, x, c):
    r2 = x[0] ** 2 + x[1] ** 2
    return jnp.where(i == 0, jnp.where(r2 < 1.0, 1.0, 0.0),
                     jnp.where(r2 + x[2] ** 2 < 1.0, 1.0, 0.0))


def test_mcmc_multi_integrand_statistical():
    """Two integrands with different dof: changeIntegrand create/remove,
    the normalization sector and swap."""
    spec, it = _mk_mcmc(_f2, dof=[[2], [3]], seed=11, neval=1_500_000)
    st = it.run(spec.device_params(), jax.random.key(2))
    for i, exact in ((0, np.pi / 4), (1, np.pi / 6)):
        mean, err = _blocks(st, i)
        assert abs(mean - exact) < 10 * max(err, 5e-3), (i, mean, err)
    assert st["visited"].sum() > 0
    assert st["hists"][0].sum() > 0


def test_mcmc_pi_statistical():
    spec, it = _mk_mcmc(_pi_i, dof=[[2]], seed=5, neval=1_000_000)
    mean, err = _blocks(it.run(spec.device_params(), jax.random.key(3)))
    assert abs(mean - np.pi / 4) < 10 * max(err, 5e-3)


def test_mcmc_discrete_pool():
    def f(i, x, c):
        t, d = x
        return t[0] * d[0]

    spec, it = _mk_mcmc(f, dof=[[1, 1]], seed=7, neval=1_000_000,
                        var=(Continuous(0.0, 1.0, ninc=128), Discrete(1, 4)))
    mean, err = _blocks(it.run(spec.device_params(), jax.random.key(5)))
    # E[t*d] integrated over t in [0,1], summed over d: 0.5*(1+2+3+4) = 5
    assert abs(mean - 5.0) < 10 * max(err, 0.1), (mean, err)


@pytest.mark.parametrize("n_int", [1, 2])
def test_mcmc_complex_statistical(n_int):
    """Complex weights (src/statistics.jl:207-214), one sector and two
    sectors with changeIntegrand jumps between them."""
    def fc(i, x, c):
        inside = jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
        return jnp.where(i == 0, inside * jnp.exp(1j * (x[0] + x[1])),
                         inside * jnp.exp(2j * x[0]))

    exacts = (0.4930147 + 0.5621625j, 0.4529586 + 0.5079670j)[:n_int]
    spec, it = _mk_mcmc(fc, dof=[[2]] * n_int, seed=7 + 2 * n_int,
                        neval=1_200_000 * n_int, weight_dtype=jnp.complex64,
                        cfg={"type": complex})
    st = it.run(spec.device_params(), jax.random.key(5))
    for i, exact in enumerate(exacts):
        m = st["obs_blocks"][:, i] / st["norm_blocks"]
        err = (m.real.std(ddof=1) + 1j * m.imag.std(ddof=1)) / 2
        assert abs(m.mean().real - exact.real) < 10 * max(err.real, 5e-3), i
        assert abs(m.mean().imag - exact.imag) < 10 * max(err.imag, 5e-3), i


def test_mcmc_deterministic_same_seed():
    spec, it = _mk_mcmc(_pi_i, dof=[[2]], seed=1, neval=300_000)
    p = spec.device_params()
    a = it.run(p, jax.random.key(9))
    b = it.run(p, jax.random.key(9))
    assert np.array_equal(a["obs_blocks"], b["obs_blocks"])
    assert np.array_equal(a["hists"][0], b["hists"][0])


def test_mcmc_full_tally_tables():
    """Per-(kind, sector, target) propose/accept tables
    (configuration.jl:345-465): changeVariable and swap rows occupied,
    acceptance never above proposal."""
    spec, it = _mk_mcmc(_f2, dof=[[2], [3]], seed=5, neval=1_000_000)
    st = it.run(spec.device_params(), jax.random.key(3))
    prop, acc = st["propose"], st["accept"]
    assert prop.shape == acc.shape == (3, 3, 3)
    assert np.all(acc <= prop + 1e-9)
    assert prop[0].sum() > 0 and prop[1].sum() > 0 and prop[2].sum() > 0
    # tallies are exact counts: integral values
    assert np.array_equal(prop, np.round(prop))


@pytest.mark.parametrize("dim", [2, 3])
def test_mcmc_fermik_statistical(dim):
    """FermiK shell sampling: k^2 over the Fermi shell (times exp(-tau)
    in 3-D), against the exact shell integral."""
    kF, dk = 1.0, (0.3 if dim == 2 else 0.2)

    if dim == 3:
        def f(i, x, c):
            K, T = x
            k2 = K[0][0] ** 2 + K[0][1] ** 2 + K[0][2] ** 2
            k = jnp.sqrt(k2)
            inside = (k > kF - dk) & (k < kF + dk)
            return jnp.where(inside, k2 * jnp.exp(-T[0]), 0.0)

        var = (FermiK(3, kF, dk, 10.0), Continuous(0.0, 1.0, ninc=128))
        dof = [[1, 1]]
        exact = (4 * np.pi / 5 * ((kF + dk) ** 5 - (kF - dk) ** 5)
                 * (1 - np.exp(-1.0)))
    else:
        def f(i, x, c):
            k2 = x[0][0] ** 2 + x[0][1] ** 2
            k = jnp.sqrt(k2)
            return jnp.where((k > kF - dk) & (k < kF + dk), k2, 0.0)

        var = FermiK(2, kF, dk, 10.0)
        dof = [[1]]
        exact = 2 * np.pi / 4 * ((kF + dk) ** 4 - (kF - dk) ** 4)
    spec, it = _mk_mcmc(f, dof=dof, seed=21 + dim, neval=1_000_000, var=var)
    mean, err = _blocks(it.run(spec.device_params(), jax.random.key(6)))
    assert abs(mean - exact) < 10 * max(err, 5e-3), (mean, err, exact)


@pytest.mark.parametrize("cplx", [False, True])
def test_mcmc_measure_statistical(cplx):
    """Custom vector measure: one-hot scatter by a Discrete external index
    (the bubble.jl observable shape), real and complex."""
    Q = 4 if not cplx else 3

    if cplx:
        def f(i, x, c):
            return jnp.exp(1j * x[0][0])

        # per external index q: int_0^1 e^{it} dt
        exact = np.full(Q, np.sin(1.0) + 1j * (1.0 - np.cos(1.0)))
    else:
        def f(i, x, c):
            return x[0][0] * x[1][0]

        exact = np.arange(1, Q + 1) / 2.0

    def meas(i, x, w, c):
        return [onehot(x[1][0], 1, Q, w.dtype) * w]

    obs = [np.zeros(Q, np.complex64 if cplx else np.float64)]
    spec, it = _mk_mcmc(
        f, dof=[[1, 1]], seed=31, neval=1_200_000, measure=meas,
        obs_proto=obs, var=(Continuous(0.0, 1.0, ninc=128), Discrete(1, Q)),
        weight_dtype=jnp.complex64 if cplx else jnp.float32,
        cfg={"obs": obs, **({"type": complex} if cplx else {})})
    st = it.run(spec.device_params(), jax.random.key(12))
    ob = np.asarray(st["obs_blocks"][0])
    assert np.iscomplexobj(ob) == cplx
    m = ob / np.asarray(st["norm_blocks"])[:, None]
    mean = m.mean(axis=0)
    err_r = m.real.std(axis=0, ddof=1) / np.sqrt(len(m))
    err_i = m.imag.std(axis=0, ddof=1) / np.sqrt(len(m))
    for q in range(Q):
        assert abs(mean[q].real - exact[q].real) < 10 * max(err_r[q], 2e-2)
        assert abs(mean[q].imag - exact[q].imag) < 10 * max(err_i[q], 2e-2)


def test_mcmc_sharded_over_mesh():
    from mcintegration.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    if ndev < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = make_mesh(ndev)
    cfg = Configuration(var=Continuous(0.0, 1.0, ninc=128), dof=[[2]], seed=3)
    spec = Spec(cfg)
    it = MCMCIteration(spec, _pi_i, block=ndev, nevalperblock=400_000,
                       mesh=mesh, nwalkers=ndev * 1024, thermal_ratio=0.3)
    st = it.run(spec.device_params(), jax.random.key(4))
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    err = m.std(ddof=1) / np.sqrt(len(m))
    assert abs(m.mean() - np.pi / 4) < 10 * max(err, 5e-3)


def test_mcmc_wide_discrete_pi_series():
    """'Discrete(1,100) pi Taylor series' through :mcmc with adaptive
    reweighting via integrate()."""
    from mcintegration.main import integrate

    NB = 100
    exact = float(sum(4 * (-1) ** (k + 1) / (2 * k - 1)
                      for k in range(1, NB + 1)))

    def f(i, x, c):
        n = x[0].astype(jnp.float32)
        return 4.0 * jnp.where(jnp.mod(n, 2.0) == 1.0, 1.0, -1.0) \
            / (2.0 * n - 1.0)

    res = integrate(f, var=Discrete(1, NB), dof=[[1]], neval=600_000,
                    niter=4, block=2, verbose=-2, seed=5, solver="mcmc",
                    nwalkers=2048)
    mean = float(np.asarray(res.mean[0]))
    err = float(np.asarray(res.stdev[0]))
    assert abs(mean - exact) < 10 * max(err, 0.05), (mean, err)


def test_mcmc_nonpow2_ninc():
    """The reference's default-style 1000-increment grid: histograms at
    the grid's resolution, and the estimate stays exact."""
    spec, it = _mk_mcmc(_pi_i, dof=[[2]], seed=5, neval=2 ** 17,
                        ninc=1000, nwalkers=4096)
    st = it.run(spec.device_params(), jax.random.key(3))
    assert st["hists"][0].shape == (1000,)
    mean, err = _blocks(st)
    assert abs(mean - np.pi / 4) < 10 * max(err, 5e-3)
