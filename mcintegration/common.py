"""Shared constants and small helpers.

Counterparts in the reference implementation (MCIntegration.jl):
- ``TINY``/``EPSILON`` constants: /root/reference/src/MCIntegration.jl:10-12.

The framework splits math across two precision domains:

- **Host domain** (numpy, float64): everything sequential and tiny — grid
  training, reweighting, per-iteration statistics, chi^2 pooling.  This is
  where the reference's accuracy-sensitive scalar math lives, and float64 is
  free on the host.
- **Device domain** (JAX, float32 by default): the embarrassingly parallel
  sampling / integrand-evaluation / accumulation path.  Accumulators use
  compensated (Kahan) summation so that float32 block sums at 1e8+ samples
  do not lose precision (see :mod:`mcintegration.ops.ksum`).
"""

from __future__ import annotations

import numpy as np

# Reference: TINY = eps(Float64(0)) * 1e50 ≈ 4.94e-274 (MCIntegration.jl:11)
# used as a *positive* floor for probabilities on the host side.
# eps(Float64(0)) is the smallest subnormal (5e-324 = np.nextafter(0, 1)).
TINY = float(np.nextafter(np.float64(0.0), np.float64(1.0)) * 1e50)
assert TINY > 0.0  # a zero floor would make every `p > TINY` guard a no-op
EPSILON = np.finfo(np.float64).eps

# Device-side float32 floors.  The reference floors float64 probabilities
# at TINY ≈ 4.94e-274 (MCIntegration.jl:11) — vanishingly small but
# positive.  In the float32 device domain the equivalent probability floor
# sits just above the smallest normal (1.18e-38); density denominators
# (1/prob Jacobians) use a larger guard so the reciprocal cannot overflow.
TINY_F32 = 1e-38        # probability floor in Metropolis accept guards
DENS_FLOOR_F32 = 1e-30  # denominator guard for 1/density Jacobians

# Default pool size, mirrors Dist.MaxOrder (distribution.jl).
MAX_ORDER = 16


def asarray_f64(x):
    return np.asarray(x, dtype=np.float64)


def onehot(idx, lo, hi, dtype=None, *, like=None):
    """Batch-safe one-hot over an inclusive integer range [lo, hi].

    The canonical custom-measure pattern scatters a walker's contribution
    into an observable bin chosen by a Discrete variable (the reference
    writes ``obs[ext] += weight``, e.g. test/bubble.jl:63-66).  Written as
    ``(jnp.arange(lo, hi+1) == ext) * relw`` that only broadcasts when
    ``ext`` is a per-sample scalar; evaluated once on batched sample
    tiles, the leading bin axis must be prepended instead.  This helper
    inserts trailing singleton axes to match the batch rank of ``idx`` (or
    of ``like=relw`` when ``idx`` is a scalar, e.g. the integrand index),
    so the same measure code is correct per-sample AND batched.  The bin
    axis is materialized with ``lax.broadcasted_iota`` at the full output
    rank.
    """
    import jax
    import jax.numpy as jnp

    n = int(hi) - int(lo) + 1
    ref = idx
    if like is not None and jnp.ndim(like) > jnp.ndim(idx):
        ref = like
    if jnp.ndim(ref) == 0:
        oh = (jnp.arange(lo, hi + 1) == idx)
    else:
        shape = (n,) + tuple(jnp.shape(ref))
        rng = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + lo
        oh = (rng == idx)      # idx broadcasts over the leading bin axis
    return oh.astype(dtype) if dtype is not None else oh
