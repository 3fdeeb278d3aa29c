"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the reference's "fake cluster" testing trick (SURVEY.md §4): the
reference self-spawns `mpiexec -n 2`; here XLA hosts 8 virtual CPU devices so
every shard_map/collective codepath is exercised without accelerators.  The
tests always run on the CPU, even where a GPU is attached; the GPU is
exercised by `chip_smoke.py`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
# a pytest plugin may import jax before this conftest runs, baking the env
# vars in; config.update still works until backends initialize
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def check(result, expect, ratio=7.0):
    """kσ statistical oracle (reference test/runtests.jl:4-29)."""
    expects = expect if isinstance(expect, (list, tuple)) else [expect]
    for i, e in enumerate(expects):
        m = np.asarray(result.mean[i]).reshape(-1)
        s = np.asarray(result.stdev[i]).reshape(-1)
        e = np.asarray(e).reshape(-1)
        for mj, sj, ej in zip(m, s, e):
            assert abs(mj - ej) < ratio * max(sj, 1e-12), (
                f"integral {i}: {mj} ± {sj} vs expected {ej} "
                f"(|Δ|={abs(mj-ej):.3g} > {ratio}σ={ratio*sj:.3g})"
            )


def check_complex(result, expect, ratio=7.0):
    expects = expect if isinstance(expect, (list, tuple)) else [expect]
    for i, e in enumerate(expects):
        m = complex(np.asarray(result.mean[i]).reshape(-1)[0])
        s = complex(np.asarray(result.stdev[i]).reshape(-1)[0])
        e = complex(e)
        assert abs(m.real - e.real) < ratio * max(s.real, 1e-12), \
            f"integral {i} re: {m} ± {s} vs {e}"
        assert abs(m.imag - e.imag) < ratio * max(s.imag, 1e-12), \
            f"integral {i} im: {m} ± {s} vs {e}"


def check_vector(result, expect, ratio=7.0):
    """Heterogeneous observables: expect is a list matching obs structure."""
    for i, e in enumerate(expect):
        m = np.asarray(result.mean[i]).reshape(-1)
        s = np.asarray(result.stdev[i]).reshape(-1)
        e = np.asarray(e, dtype=np.float64).reshape(-1)
        for mj, sj, ej in zip(m, s, e):
            assert abs(mj - ej) < ratio * max(sj, 1e-12), (
                f"integral {i}: {mj} ± {sj} vs expected {ej}")


@pytest.fixture
def oracle():
    return check
