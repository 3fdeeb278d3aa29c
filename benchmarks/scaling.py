"""Multi-device scaling benchmark.

Measures evals/s of the sharded :vegas kernel as the mesh grows, reporting
scaling efficiency vs the 1-device rate (the BASELINE.md ">=80% scaling
1 chip -> 1 host -> N hosts" target).  Over virtual CPU devices (set
JAX_PLATFORMS=cpu with --xla_force_host_platform_device_count=N) it
exercises the real shard_map path; on a host with several GPUs the same
script measures NVLink scaling directly.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/scaling.py [neval_per_device]
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
from mcintegration.parallel.mesh import make_mesh
from mcintegration.solvers.engine import Spec
from mcintegration.solvers.vegas import VegasIteration


def rate(ndev: int, neval_per_dev: int) -> float:
    mesh = make_mesh(ndev) if ndev > 1 else None
    block = 2 * max(ndev, 1)
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=11)
    spec = Spec(cfg)
    it = VegasIteration(
        spec, lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
        block=block, nevalperblock=neval_per_dev * ndev // block, mesh=mesh)
    params = spec.device_params()
    it.run(params, jax.random.key(0))  # compile
    best = 0.0
    for rep in range(3):
        t0 = time.perf_counter()
        it.run(params, jax.random.key(rep + 1))
        best = max(best, it.block * it.nevalperblock / (time.perf_counter() - t0))
    return best


def main():
    npd = int(float(sys.argv[1])) if len(sys.argv) > 1 else 2**22
    devs = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= devs]
    r1 = None
    print(f"platform={jax.devices()[0].platform}, {devs} devices, "
          f"{npd:.0e} evals/device/iteration")
    for n in sizes:
        r = rate(n, npd)
        if r1 is None:
            r1 = r
        eff = r / (r1 * n) * 100
        print(f"  {n:3d} devices: {r/1e9:7.3f} G evals/s   "
              f"efficiency {eff:5.1f}%")


if __name__ == "__main__":
    main()
