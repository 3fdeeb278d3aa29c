"""Statistics-layer tests (mirrors reference test/statistics.jl)."""

import numpy as np
import pytest

from mcintegration.statistics import Result, average, mean_std, sig_digits, tostring


class _FakeConfig:
    def __init__(self, n=1, neval=100):
        self.N = n
        self.neval = neval


def test_mean_std_scalar():
    # block estimates m_b; obs_sum = sum m_b, obs_sq = sum m_b^2
    rng = np.random.default_rng(0)
    m = rng.normal(2.0, 0.1, size=64)
    means, stds = mean_std([m.sum()], [(m**2).sum()], 64)
    np.testing.assert_allclose(means[0], m.mean(), rtol=1e-12)
    # stderr of mean = population std / sqrt(B-1)-ish (reference formula)
    want = np.sqrt((np.mean(m**2) - np.mean(m) ** 2) / 63)
    np.testing.assert_allclose(stds[0], want, rtol=1e-10)


def test_mean_std_vector_and_complex():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(16, 3)) + 1j * rng.normal(size=(16, 3))
    osum = m.sum(axis=0)
    osq = (m.real**2 + 1j * m.imag**2).sum(axis=0)
    means, stds = mean_std([osum], [osq], 16)
    np.testing.assert_allclose(means[0], m.mean(axis=0))
    assert stds[0].shape == (3,)
    assert np.all(stds[0].real > 0) and np.all(stds[0].imag > 0)


def test_average_weighted():
    cfg = _FakeConfig()
    # two iterations, precision-weighted
    hist = [
        ([np.float64(1.0)], [np.float64(0.1)], cfg),
        ([np.float64(2.0)], [np.float64(0.1)], cfg),
    ]
    m, e, chi2 = average(hist, 0)
    np.testing.assert_allclose(m, 1.5, rtol=1e-6)
    # equal weights w=1/(0.1+1e-10)^2 each; err = 1/sqrt(2w)
    np.testing.assert_allclose(e, 0.1 / np.sqrt(2), rtol=1e-4)
    assert chi2 > 0


def test_average_ignores_init():
    cfg = _FakeConfig()
    hist = [
        ([np.float64(100.0)], [np.float64(0.001)], cfg),
        ([np.float64(2.0)], [np.float64(0.1)], cfg),
        ([np.float64(2.2)], [np.float64(0.1)], cfg),
    ]
    m, e, chi2 = average(hist, 0, init=1)
    np.testing.assert_allclose(m, 2.1, rtol=1e-6)


def test_result_and_chi2():
    cfg = _FakeConfig(n=1, neval=50)
    hist = [([np.float64(v)], [np.float64(0.1)], cfg)
            for v in [1.0, 1.1, 0.9, 1.05]]
    res = Result(hist, 0)
    assert res.neval == 200
    np.testing.assert_allclose(np.asarray(res.mean[0]), 1.0125, rtol=1e-3)
    assert res.dof() == 3
    m, e, c = res[0]
    assert float(np.asarray(c)) < 3.0


def test_result_reignore():
    cfg = _FakeConfig(n=1)
    hist = [([np.float64(v)], [np.float64(0.1)], cfg) for v in [5.0, 1.0, 1.0]]
    r0 = Result(hist, 0)
    r1 = Result(r0, 1)
    assert float(np.asarray(r1.mean[0])) == pytest.approx(1.0)
    assert float(np.asarray(r0.mean[0])) > 1.5


def test_complex_average_independent_channels():
    cfg = _FakeConfig()
    hist = [
        ([np.complex128(1.0 + 2.0j)], [np.complex128(0.1 + 0.4j)], cfg),
        ([np.complex128(1.2 + 2.2j)], [np.complex128(0.1 + 0.1j)], cfg),
    ]
    m, e, chi2 = average(hist, 0)
    assert abs(m.real - 1.1) < 0.01
    # imag channel dominated by the second (smaller error) iteration
    assert m.imag > 2.15


def test_tostring_sig_digits():
    assert sig_digits(0.0234) == 4  # 2 - floor(log10(err)) (statistics.jl:74-79)
    assert tostring(1.23456, 0.0234) == "1.2346 ± 0.0234"
    assert tostring(0.5, 0.0) == "0.5 ± 0.0" or "±" in tostring(0.5, 0.0)
    s = tostring(1.0 + 2.0j, 0.1 + 0.2j)
    assert "im" in s


def test_reweight_converges_to_goal():
    """Reweighting drives visited ratios toward reweight_goal over
    iterations (reference test/mpi_test.jl:148-169)."""
    from mcintegration.configuration import Configuration
    from mcintegration.main import do_reweight
    from mcintegration.models.variable import Continuous

    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[1], [1]])
    goal = np.array([2.0, 1.0, 1.0])
    rng = np.random.default_rng(0)
    for _ in range(20):
        # visits proportional to current reweight (perfect mixing model)
        cfg.visited[:] = cfg.reweight * 3e5 + rng.integers(0, 10, 3)
        do_reweight(cfg, 1.0, goal)
    r = cfg.reweight / cfg.reweight.sum()
    np.testing.assert_allclose(r, goal / goal.sum(), rtol=0.05)
