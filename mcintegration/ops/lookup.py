"""Table lookup and scatter-accumulate via factored one-hots.

The XLA path reads the Vegas map (random indices into a ~1000-entry table)
and accumulates histograms without gather or scatter: the index is split
into two levels,

    iy = hi * L + lo,   hi, lo in [0, L),   L = ceil(sqrt(NB))

and the gather becomes

    tmp = onehot(hi) @ table.reshape(L, L*K)        ([T,L] x [L,L*K])
    val = sum(onehot(lo)[..., None] * tmp, axis=-2)

costing ~2L compares + small matmuls per element instead of NB compares for
a flat one-hot.  The same factored one-hots drive the histogram
scatter-add:

    hist2d += (onehot(hi) * w).T @ onehot(lo)       ([L,T] x [T,L])

Both are exact at HIGHEST precision (0/1 coefficients select a single
row) and deterministic: XLA's scatter-add on a GPU sums with atomics in a
run-dependent order.  Whether a plain gather is faster on the GPU is an
open measurement.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def level_size(nb: int) -> int:
    """Side length L of the two-level factorization (a multiple of 8)."""
    l = int(math.ceil(math.sqrt(max(nb, 1))))
    return max(8, -(-l // 8) * 8)


def pack_table(table: np.ndarray, pad_value=0.0) -> np.ndarray:
    """Pack a [NB, K] (or [NB]) float64 table into [L, L*K] for two_level_take."""
    table = np.asarray(table, dtype=np.float64)
    if table.ndim == 1:
        table = table[:, None]
    nb, k = table.shape
    l = level_size(nb)
    out = np.full((l * l, k), pad_value, dtype=np.float64)
    out[:nb] = table
    return out.reshape(l, l * k)


def two_level_take(packed: jax.Array, idx: jax.Array, k: int) -> jax.Array:
    """Gather rows of the packed [L, L*K] table at flat indices ``idx``.

    Returns shape idx.shape + (K,).  ``idx`` must lie in [0, L*L).
    """
    l = packed.shape[0]
    shape = idx.shape
    t = int(np.prod(shape)) if shape else 1
    idx = idx.reshape(t)
    hi = idx // l
    lo = idx - hi * l
    iota = jnp.arange(l, dtype=idx.dtype)
    oh_hi = (hi[:, None] == iota[None, :]).astype(packed.dtype)   # [T, L]
    oh_lo = (lo[:, None] == iota[None, :]).astype(packed.dtype)   # [T, L]
    tmp = jax.lax.dot(oh_hi, packed,
                      precision=jax.lax.Precision.HIGHEST)        # [T, L*K]
    tmp = tmp.reshape(t, l, k)
    val = jnp.sum(oh_lo[:, :, None] * tmp, axis=1)                # [T, K]
    return val.reshape(shape + (k,))


def onehot_accumulate(hist: jax.Array, idx: jax.Array, w: jax.Array) -> jax.Array:
    """hist[idx] += w via factored one-hot matmuls.

    ``hist`` has length L*L (padded, see :func:`pack_table`); ``idx``/``w``
    any matching shape.  Exact: each (hi, lo) pair lands in one cell.
    """
    n = hist.shape[0]
    l = int(math.isqrt(n))
    assert l * l == n, f"hist length {n} must be a padded square"
    t = int(np.prod(idx.shape)) if idx.shape else 1
    idx = idx.reshape(t)
    w = w.reshape(t).astype(hist.dtype)
    hi = idx // l
    lo = idx - hi * l
    iota = jnp.arange(l, dtype=idx.dtype)
    oh_hi = (hi[:, None] == iota[None, :]).astype(hist.dtype)     # [T, L]
    oh_lo = (lo[:, None] == iota[None, :]).astype(hist.dtype)     # [T, L]
    h2 = jax.lax.dot(
        (oh_hi * w[:, None]).T, oh_lo,
        precision=jax.lax.Precision.HIGHEST)                      # [L, L]
    return hist + h2.reshape(n)


def padded_hist_size(nb: int) -> int:
    l = level_size(nb)
    return l * l
