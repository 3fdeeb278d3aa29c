"""Unit tests for the adaptive-map math (mirrors reference test/utility.jl).

Golden values computed with an independent straight-line transcription of the
reference formulas (sequential prefix-walk etc.) so the vectorized
implementations are checked against the exact reference semantics.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration.ops.grid import (
    build_cdf,
    locate,
    rescale,
    sample_continuous,
    sample_discrete,
    smooth,
    train_grid,
    uniform_open01,
)


def test_locate_edges():
    # reference test/utility.jl:1-10
    acc = np.array([0.0, 0.3, 0.5, 1.0])
    assert locate(acc, 0.0) == 0
    assert locate(acc, 0.2999) == 0
    assert locate(acc, 0.3) == 1
    assert locate(acc, 0.7) == 2
    assert locate(acc, 0.9999) == 2
    with pytest.raises(ValueError):
        locate(acc, 1.0)
    with pytest.raises(ValueError):
        locate(acc, -0.1)


def _smooth_naive(dist, factor=6.0):
    # straight transcription of common.jl:43-54
    dist = np.asarray(dist, dtype=np.float64)
    if len(dist) <= 1:
        return dist.copy()
    new = dist.copy()
    new[0] = (dist[0] * (factor + 1) + dist[1]) / (factor + 2)
    new[-1] = (dist[-1] * (factor + 1) + dist[-2]) / (factor + 2)
    for i in range(1, len(dist) - 1):
        new[i] = (dist[i - 1] + dist[i] * factor + dist[i + 1]) / (factor + 2)
    return new


def test_smooth_matches_reference_formula():
    rng = np.random.default_rng(0)
    d = rng.random(100) + 0.1
    np.testing.assert_allclose(smooth(d, 6.0), _smooth_naive(d, 6.0), rtol=1e-14)
    np.testing.assert_allclose(smooth(d[:2], 3.0), _smooth_naive(d[:2], 3.0))
    np.testing.assert_allclose(smooth(d[:1]), d[:1])


def _rescale_naive(dist, alpha):
    dist = np.asarray(dist, np.float64)
    dist = dist / dist.sum()
    out = dist.copy()
    for i in range(len(dist)):
        if 0 < dist[i] <= 0.99999999:
            out[i] = (-(1 - dist[i]) / np.log(dist[i])) ** alpha
    return out


def test_rescale_matches_reference_formula():
    rng = np.random.default_rng(1)
    d = rng.random(50) + 1e-3
    np.testing.assert_allclose(rescale(d.copy(), 1.5), _rescale_naive(d, 1.5),
                               rtol=1e-13)
    np.testing.assert_allclose(rescale(d.copy(), 2.0), _rescale_naive(d, 2.0),
                               rtol=1e-13)


def _train_naive(grid, hist, alpha):
    # straight transcription of variable.jl:206-239
    distribution = _smooth_naive(hist, 6.0)
    distribution = _rescale_naive(distribution, alpha)
    newgrid = grid.copy()
    j = -1  # 0-based: will be incremented before first use
    acc_f = 0.0
    avg_f = distribution
    f_ninc = avg_f.sum() / (len(grid) - 1)
    for i in range(1, len(grid) - 1):
        while acc_f < f_ninc:
            j += 1
            acc_f += avg_f[j]
        acc_f -= f_ninc
        newgrid[i] = grid[j + 1] - (acc_f / avg_f[j]) * (grid[j + 1] - grid[j])
    newgrid[-1] = grid[-1]
    return newgrid


@pytest.mark.parametrize("ninc", [10, 100, 1000])
def test_train_grid_matches_sequential_walk(ninc):
    rng = np.random.default_rng(2)
    grid = np.linspace(0.0, 1.0, ninc + 1)
    hist = rng.random(ninc) + 1e-6
    got = train_grid(grid, hist, alpha=2.0)
    want = _train_naive(grid, hist, 2.0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert np.all(np.diff(got) > 0), "trained grid must stay monotone"


def test_train_grid_adapts_to_singularity():
    # mass near x=0 should shrink the first bins
    ninc = 100
    grid = np.linspace(0.0, 1.0, ninc + 1)
    hist = 1.0 / (np.arange(ninc) + 1.0)
    g = grid
    for _ in range(5):
        g = train_grid(g, hist, alpha=2.0)
    assert g[1] < grid[1]


def test_uniform_open01_never_hits_endpoints():
    u = uniform_open01(jax.random.key(0), (100000,))
    u = np.asarray(u)
    assert u.min() > 0.0
    assert u.max() < 1.0


def test_sample_continuous_prob_is_inverse_jacobian():
    grid64 = np.sort(np.concatenate([[0.0, 1.0], np.random.default_rng(3).random(99)]))
    inc = np.diff(grid64)
    grid = jnp.asarray(grid64, jnp.float32)
    incj = jnp.asarray(inc, jnp.float32)
    y = uniform_open01(jax.random.key(1), (10000,))
    x, gidx, prob = sample_continuous(y, grid, incj)
    x, gidx, prob = map(np.asarray, (x, gidx, prob))
    n = len(grid64) - 1
    assert np.all((x >= 0.0) & (x < 1.0))
    # x lies in its bin
    assert np.all(x >= grid64[gidx] - 1e-6)
    assert np.all(x <= grid64[gidx + 1] + 1e-6)
    np.testing.assert_allclose(prob, 1.0 / (n * inc[gidx]), rtol=1e-5)


def test_sample_continuous_flat_grid_uniform_mean():
    grid = jnp.linspace(0.0, 1.0, 1001)
    inc = jnp.diff(grid)
    y = uniform_open01(jax.random.key(2), (200000,))
    x, _, prob = sample_continuous(y, grid, inc)
    assert abs(float(jnp.mean(x)) - 0.5) < 0.005
    np.testing.assert_allclose(np.asarray(prob), 1.0, rtol=1e-4)


def test_sample_discrete_distribution():
    dist, cdf = build_cdf(np.array([0.2, 0.5, 0.3]))
    u = uniform_open01(jax.random.key(3), (100000,))
    gidx, prob = sample_discrete(u, jnp.asarray(cdf, jnp.float32),
                                 jnp.asarray(dist, jnp.float32))
    gidx = np.asarray(gidx)
    freq = np.bincount(gidx, minlength=3) / len(gidx)
    np.testing.assert_allclose(freq, [0.2, 0.5, 0.3], atol=0.01)
    np.testing.assert_allclose(np.asarray(prob), dist[gidx], rtol=1e-6)
