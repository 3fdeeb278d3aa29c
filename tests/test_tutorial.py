"""Every python block in docs/tutorial.md must run (scaled-down budgets)."""

import re
import os

import numpy as np
import jax.numpy as jnp

import mcintegration as mci
from mcintegration import Configuration, Continuous, Discrete
from mcintegration.parallel import make_mesh


def _blocks():
    path = os.path.join(os.path.dirname(__file__), "..", "docs",
                        "tutorial.md")
    text = open(path).read()
    return re.findall(r"```python\n(.*?)```", text, re.DOTALL)


def test_tutorial_blocks_run():
    blocks = _blocks()
    assert len(blocks) >= 7

    def small_integrate(*args, **kw):
        kw["neval"] = min(int(float(kw.get("neval", 1e4))), 2 ** 14)
        kw["niter"] = min(int(kw.get("niter", 10)), 3)
        kw.setdefault("verbose", -2)
        kw.setdefault("seed", 7)
        return mci.integrate(*args, **kw)

    ns = {"jnp": jnp, "np": np, "integrate": small_integrate,
          "Continuous": Continuous, "Discrete": Discrete,
          "Configuration": Configuration, "make_mesh": make_mesh,
          "__name__": "__tutorial__"}
    for blk in blocks:
        if "init_distributed" in blk:   # multi-host: needs N processes
            continue
        # imports are for the reader; the namespace injects clamped versions
        src = "\n".join(l for l in blk.splitlines()
                        if not l.startswith(("import ", "from ")))
        exec(compile(src, "<tutorial>", "exec"), ns)
    assert "res" in ns and "hist" in ns
