"""Compensated (Kahan/Neumaier) accumulation for float32 device loops.

The reference accumulates observables in float64 (Julia default).  The
device compute dtype here is float32; summing 1e6-1e9 weights of similar sign
in float32 loses ~log2(n)/2 bits.  A Neumaier-compensated carry restores
effectively-float64 accuracy at two extra adds per element.

Used by all three solvers for the per-block observable / normalization
accumulators carried through ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class KSum(NamedTuple):
    """A compensated accumulator: value ``s`` plus running compensation ``c``."""

    s: jax.Array
    c: jax.Array

    @property
    def value(self) -> jax.Array:
        return self.s + self.c


def kzeros(shape, dtype=jnp.float32) -> KSum:
    z = jnp.zeros(shape, dtype)
    return KSum(z, z)


def kzeros_like(x) -> KSum:
    z = jnp.zeros_like(x)
    return KSum(z, z)


def kadd(acc: KSum, x: jax.Array) -> KSum:
    """Neumaier update: works even when |x| > |s|."""
    t = acc.s + x
    big = jnp.where(jnp.abs(acc.s) >= jnp.abs(x), acc.s, x)
    small = jnp.where(jnp.abs(acc.s) >= jnp.abs(x), x, acc.s)
    c = acc.c + ((big - t) + small)
    return KSum(t, c)


def tree_kzeros(tree) -> "jax.Array":
    return jax.tree_util.tree_map(kzeros_like, tree)


def tree_kadd(acc, tree):
    return jax.tree_util.tree_map(
        kadd, acc, tree, is_leaf=lambda x: isinstance(x, KSum)
    )


def tree_kvalue(acc):
    return jax.tree_util.tree_map(
        lambda k: k.value, acc, is_leaf=lambda x: isinstance(x, KSum)
    )
