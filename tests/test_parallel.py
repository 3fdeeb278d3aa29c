"""Parallelism and determinism tests.

The reference tests threads (test/thread.jl) and a self-spawned 2-rank MPI
job (test/mpi.jl); here the analogue is the 8-virtual-device CPU mesh:
shard_map sharding of the block/walker axis plus a psum'd statistics
reduction, and the counter-based-RNG determinism the reference cannot offer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcintegration import Continuous, integrate, make_mesh
from mcintegration.parallel.mesh import mesh_size
from conftest import check

F = lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
FI = lambda idx, x, c: F(x, c)
PI4 = np.pi / 4


def _run(alg, mesh, seed=7, neval=5e4):
    return integrate(FI if alg == "mcmc" else F, var=Continuous(0.0, 1.0),
                     dof=[[2]], neval=neval, niter=4, solver=alg,
                     verbose=-2, seed=seed, mesh=mesh, block=16)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
def test_deterministic_same_seed(alg):
    """Same seed -> bit-identical result (counter-based RNG; SURVEY.md §4)."""
    mesh = make_mesh(8)
    r1 = _run(alg, mesh, seed=99)
    r2 = _run(alg, mesh, seed=99)
    assert float(np.asarray(r1.mean[0])) == float(np.asarray(r2.mean[0]))
    assert float(np.asarray(r1.stdev[0])) == float(np.asarray(r2.stdev[0]))


def test_vegas_mesh_size_invariance():
    """:vegas block lanes are keyed globally, so 1-device and 8-device meshes
    compute the same estimate up to float reduction order."""
    r1 = _run("vegas", None, seed=5)
    r8 = _run("vegas", make_mesh(8), seed=5)
    np.testing.assert_allclose(float(np.asarray(r1.mean[0])),
                               float(np.asarray(r8.mean[0])), rtol=1e-4)


@pytest.mark.parametrize("alg", ["vegas", "vegasmc", "mcmc"])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_sizes_statistically_correct(alg, ndev):
    mesh = make_mesh(ndev) if ndev > 1 else None
    check(_run(alg, mesh, seed=ndev * 11 + 1), PI4)


def test_different_seeds_differ():
    mesh = make_mesh(8)
    r1 = _run("vegas", mesh, seed=1)
    r2 = _run("vegas", mesh, seed=2)
    assert float(np.asarray(r1.mean[0])) != float(np.asarray(r2.mean[0]))


def test_checkpoint_roundtrip(tmp_path):
    from mcintegration import Configuration, load_state, save_state

    res = integrate(lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0]),
                    var=Continuous(0.0, 1.0), dof=[[1]], neval=5e4, niter=5,
                    solver="vegas", verbose=-2, seed=3)
    path = str(tmp_path / "state.npz")
    save_state(res.config, path)

    cfg2 = Configuration(var=Continuous(0.0, 1.0), dof=[[1]], seed=17)
    load_state(cfg2, path)
    np.testing.assert_array_equal(cfg2.var[0].grid, res.config.var[0].grid)
    np.testing.assert_array_equal(cfg2.reweight, res.config.reweight)

    # resume: run non-adaptively from the restored state and stay accurate
    res2 = integrate(lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0]),
                     config=cfg2, neval=5e4, niter=2, solver="vegas",
                     verbose=-2, adapt=False)
    check(res2, -4.0)
