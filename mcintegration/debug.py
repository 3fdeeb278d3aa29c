"""Debug-mode diagnostics.

The analogue of the reference's ``debug=true`` machinery: the
``@inferred`` type-stability checker (src/utility/utility.jl:42-53) becomes
an eager probe evaluation of the user integrand/measure on a small batch
(shape+dtype validation with readable errors), and the in-loop non-finite
weight warnings (src/vegas/montecarlo.jl:176-178 etc.) become host-side
scans of each iteration's reduced statistics.
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from .utils.color import red, yellow


def probe_integrand(spec, integrand, measure, inplace, solver, weight_dtype):
    """Trace + run the user functions on a 4-sample batch and sanity-check.

    Raises with a readable message on structure mismatches; warns on
    non-finite probe weights (which may be legitimate for singular
    integrands, hence not fatal).
    """
    params = spec.device_params()
    key = jax.random.key(0)
    pools = spec.draw_all(params, key, (4,))
    n = spec.N

    if solver == "mcmc":
        try:
            for idx in range(n):
                f = spec.make_eval_one(integrand, idx, weight_dtype)
                w = jax.vmap(f)(pools)
                assert w.shape == (4,)
        except Exception as e:
            raise TypeError(
                f"debug probe: mcmc integrand(idx, var, config) failed for "
                f"idx={idx}: {e}") from e
    else:
        try:
            f = spec.make_eval(integrand, inplace, weight_dtype)
            w = jax.vmap(f)(pools)
            assert w.shape == (4, n), w.shape
        except Exception as e:
            sig = "(var, weights, config)" if inplace else "(var, config)"
            raise TypeError(
                f"debug probe: integrand{sig} failed or returned the wrong "
                f"number of weights (expected {n}): {e}") from e
        wnp = np.asarray(jnp.abs(w))
        if not np.all(np.isfinite(wnp)):
            warnings.warn(
                "debug probe: integrand returned non-finite weights on a "
                "random probe batch (may be fine for singular integrands)")
        if np.iscomplexobj(np.asarray(w)) and weight_dtype == jnp.float32:
            raise TypeError(
                "integrand returned complex weights but type=float; pass "
                "type=complex to integrate()")

    if measure is not None and solver != "mcmc":
        uc = spec.uconfig
        try:
            relw = jnp.zeros((4, n), weight_dtype)
            jax.vmap(lambda p, r: measure(spec.view(p), r, uc))(pools, relw)
        except Exception as e:
            raise TypeError(
                "debug probe: measure(var, relative_weights, config) must "
                f"return the observable-contribution pytree: {e}") from e


def check_iteration_stats(stats, it: int):
    """Warn on non-finite reduced statistics, mirroring the solvers'
    isfinite warnings (vegas/montecarlo.jl:176-178)."""
    bad = []
    obs = stats["obs_blocks"]
    for leaf in jax.tree_util.tree_leaves(obs):
        if not np.all(np.isfinite(np.asarray(leaf))):
            bad.append("observable")
            break
    if not np.all(np.isfinite(stats["norm_blocks"])):
        bad.append("normalization")
    for h in stats["hists"]:
        if not np.all(np.isfinite(h)):
            bad.append("histogram")
            break
    if bad:
        sys.stderr.write(red(
            f"iteration {it}: non-finite {', '.join(bad)} statistics — the "
            "integrand likely produced Inf/NaN weights\n"))
    return not bad
