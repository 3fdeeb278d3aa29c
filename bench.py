"""Headline benchmark: integrand evals/s on the 2-D unit-circle pi integral
(:vegas, one GPU).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.
Baseline = 1e9 evals/s per card, the project's north-star target
(BASELINE.md; the reference's measured single-core rate is ~0.4-4.5e6
evals/s).

Requires a GPU: exits non-zero on any other platform.  Times one warm
iteration (device work plus the blocking statistics fetch), best of 3,
after a compiling warm-up call, and sanity-checks the estimate against
pi/4 at 5 sigma before reporting.

    python bench.py [neval]        # default 2**32 evals per iteration
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    sys.path.insert(0, HERE)
    from mcintegration.platform import configure_jax

    configure_jax(HERE)
    import jax
    import jax.numpy as jnp

    from mcintegration.configuration import Configuration
    from mcintegration.models.variable import Continuous
    from mcintegration.solvers.engine import Spec
    from mcintegration.solvers.vegas import VegasIteration

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX runs on '{dev.platform}'")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0].strip()

    block = 16
    neval = int(float(sys.argv[1])) if len(sys.argv) > 1 else 2 ** 32
    cfg = Configuration(var=Continuous(0.0, 1.0), dof=[[2]], seed=20260817)
    spec = Spec(cfg)
    it = VegasIteration(
        spec, lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
        block=block, nevalperblock=neval // block, mesh=None)
    params = spec.device_params()

    t0 = time.perf_counter()
    stats = it.run(params, jax.random.key(0))        # compile + warm-up
    first = time.perf_counter() - t0
    total = it.block * it.nevalperblock
    best, best_dt = 0.0, None
    for rep in range(3):
        t0 = time.perf_counter()
        stats = it.run(params, jax.random.key(rep + 1))
        dt = time.perf_counter() - t0
        if total / dt > best:
            best, best_dt = total / dt, dt

    m_b = stats["obs_blocks"][:, 0] / stats["norm_blocks"]
    mean = m_b.mean()
    err = m_b.std(ddof=1) / np.sqrt(block)
    assert abs(mean - np.pi / 4) < 5 * max(err, 1e-9), (mean, err)

    print(f"card: {card} | {dev.device_kind} | backend {it.backend} | "
          f"{total} evals in {best_dt:.4f} s | first call {first:.2f} s",
          flush=True)
    print(json.dumps({
        "metric": "pi2d_integrand_evals_per_sec_per_card",
        "value": best,
        "unit": "evals/s",
        "vs_baseline": best / 1e9,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
    }))


if __name__ == "__main__":
    main()
