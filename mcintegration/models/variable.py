"""Variable pools (the adaptive-distribution models).

Re-design of the reference's ``Dist`` module
(/root/reference/src/distribution/{variable,sampler,distribution}.jl).

Semantics preserved:

- a pool is a set of slots sharing ONE learned 1-D map (Vegas grid for
  ``Continuous``, categorical distribution for ``Discrete``), so unbounded
  dimensionality shares a single trained map (variable.jl:87-153, 272-328);
- ``offset`` reserves leading slots the MC never touches (user-set
  "external" variables, variable.jl:93);
- ``CompositeVar`` bundles pools that are created/shifted jointly with
  product probability (variable.jl:397-507);
- ``FermiK`` samples D-dim momenta in the shell kF±δk with exact Jacobians
  (variable.jl:1-35, sampler.jl:109-250); like the reference it is supported
  by the :mcmc solver only (test/bubble_FermiK.jl:2).

Architectural inversion vs the reference: the pool here is a *spec + trained
state* object on the host (numpy float64 grids/histograms, trained once per
iteration), while sampling happens on device over dense batched arrays
``value[..., nslots]`` / ``prob[..., nslots]`` produced by the pure jittable
``dev_*`` methods below.  There is no mutate-in-place walker; each solver
carries the batch state functionally.

Each leaf pool exposes, for traced (device) code:

- ``dev_draw(params, key, shape)``   -> (value, gidx, prob): fresh draw from
  the learned map.  ``prob`` is the sampling density (Continuous/FermiK) or
  mass (Discrete); proposal prob of create = 1/prob  (sampler.jl:293-305).
- ``dev_density(params, value, gidx)`` -> prob of an existing value
  (used by `remove` proposals, sampler.jl:318-323).
- ``dev_shift(params, key, value, gidx, prob)`` -> (value', gidx', prob',
  prop): Metropolis shift proposal with Hastings factor ``prop``
  (sampler.jl:336-386: default = fresh redraw, prop = prob_old/prob_new).

and for host code: ``train()``, ``clear_statistics()``,
``add_statistics(histogram)``, ``device_params()``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..common import MAX_ORDER
from ..common import DENS_FLOOR_F32
from ..ops.grid import (
    build_cdf,
    sample_continuous,
    sample_continuous_packed,
    sample_discrete,
    sample_discrete_cdf,
    train_discrete,
    train_grid,
    uniform_open01,
)
from ..ops.lookup import pack_table, two_level_take

HIST_FLOOR = 1.0e-10  # clearStatistics! floor (variable.jl:565)


def is_variable(v) -> bool:
    return isinstance(v, (Continuous, Discrete, FermiK, CompositeVar))


class _LeafVar:
    """Common host-side state for non-composite pools."""

    offset: int
    alpha: float
    adapt: bool
    size: int

    # number of float32 values stored per slot (FermiK: D)
    value_width: int = 0  # 0 => scalar slot value

    def clear_statistics(self):
        self.histogram.fill(HIST_FLOOR)

    def add_statistics(self, histogram):
        """Merge a device-produced histogram into the host accumulator.

        Non-finite bins (f32 overflow from an extreme first-iteration sample)
        are replaced by the largest finite bin — training consumes ratios,
        so this only caps how fast a bin can attract grid nodes.
        """
        h = np.asarray(histogram, dtype=np.float64)
        if not np.all(np.isfinite(h)):
            finite = h[np.isfinite(h)]
            cap = finite.max() if finite.size else 1.0
            h = np.nan_to_num(h, nan=cap, posinf=cap, neginf=0.0)
        self.histogram += h

    def train(self):
        raise NotImplementedError

    def device_params(self, dtype=jnp.float32):
        raise NotImplementedError

    @property
    def nhist(self) -> int:
        return self.histogram.shape[0]


class Continuous(_LeafVar):
    """Pool of floats in [lower, upper) sampled through a learned Vegas map.

    Mirrors ``Dist.Continuous`` (variable.jl:87-153).  ``Continuous(bounds)``
    with a list of (lower, upper) pairs returns a :class:`CompositeVar` of
    independent pools, mirroring variable.jl:174-187.

    ``ninc`` semantics differ from the reference: here ``ninc`` counts grid
    INCREMENTS (``linspace(lower, upper, ninc+1)``), while the reference's
    ``ninc`` counts grid points (``LinRange(lower, upper, ninc)`` =>
    ``ninc-1`` increments, variable.jl:137); the default is 1024 increments
    (reference: 1000 points) — a power of two so the packed lookup tables
    stay dense and the Pallas chain kernels can use lattice-roll draws.  A
    config ported from the reference with an explicit ``ninc`` therefore
    gets one more increment; adaptive training makes this immaterial.
    """

    value_dtype = jnp.float32
    n_uniform_draw = 1

    def __new__(cls, lower=None, upper=None, size=MAX_ORDER, **kwargs):
        if lower is None:
            return super().__new__(cls)  # copy/pickle protocol path
        if upper is None or isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            # vectorized ctor: Continuous([(a,b), (c,d), ...])
            bounds = lower
            if upper is not None:
                raise TypeError("pass bounds as first argument only")
            grids = kwargs.pop("grid", [None] * len(bounds))
            nincs = kwargs.pop("ninc", [1024] * len(bounds))
            if np.isscalar(nincs):
                nincs = [nincs] * len(bounds)
            members = [
                Continuous(b[0], b[1], size, ninc=nincs[i], grid=grids[i], **kwargs)
                for i, b in enumerate(bounds)
            ]
            return CompositeVar(
                *members,
                adapt=kwargs.get("adapt", True),
                offset=kwargs.get("offset", 0),
                size=size,
            )
        return super().__new__(cls)

    def __init__(self, lower, upper=None, size=MAX_ORDER, *, offset=0, alpha=2.0,
                 adapt=True, ninc=1024, grid=None):
        if upper is None:
            return  # composite path handled in __new__
        lower, upper = float(lower), float(upper)
        assert upper > lower, f"upper={upper} must exceed lower={lower}"
        assert offset + 1 < size
        self.lower = lower
        self.upper = upper
        self.range = upper - lower
        self.offset = int(offset)
        self.alpha = float(alpha)
        self.adapt = bool(adapt)
        self.size = int(size)
        if grid is None:
            # ninc = number of INCREMENTS (the reference's ninc counts grid
            # points, variable.jl:137 -> ninc-1 increments).  Default 1024:
            # a power of two keeps the packed lookup tables fully dense
            # (L*L = ninc) and lets the Pallas chain kernel express map
            # draws as cyclic lattice rolls.
            grid = np.linspace(lower, upper, int(ninc) + 1, dtype=np.float64)
        self.grid = np.asarray(grid, dtype=np.float64).copy()
        self.ninc = self.grid.shape[0] - 1
        self.histogram = np.full(self.ninc, HIST_FLOOR, dtype=np.float64)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} Continuous variable in [{self.lower}, {self.upper})."

    # ---- host side --------------------------------------------------
    def train(self):
        """Grid refinement (variable.jl:206-239)."""
        if not self.adapt:
            return
        self.grid = train_grid(self.grid, self.histogram, self.alpha)
        self.clear_statistics()

    def device_params(self, dtype=jnp.float32):
        inc = np.diff(self.grid)  # float64 differences, then cast: no f32 cancellation
        # packed (grid_i, inc_i) rows for the one-hot lookup (ops/lookup.py);
        # pad inc with 1.0 so padded bins can never divide by zero
        tab = np.stack([self.grid[:-1], inc], axis=1)
        packed = pack_table(tab, pad_value=1.0)
        return {"tab": jnp.asarray(packed, dtype)}

    def fixed_values(self, dtype=np.float32):
        """Deterministic initial values for offset (user-pinned) slots.

        The reference initializes pool data to an interior linspace
        (variable.jl:141); users overwrite offset slots by hand.
        """
        n = self.size
        t = self.lower + self.range * (np.arange(1, n + 1) - 0.5) / n
        return t.astype(dtype)

    # ---- device side ------------------------------------------------
    def dev_draw(self, params, key, shape):
        y = uniform_open01(key, shape)
        return sample_continuous_packed(y, params["tab"], self.ninc)

    def dev_density(self, params, value, gidx):
        inc = two_level_take(params["tab"], gidx, 2)[..., 1]
        return 1.0 / (self.ninc * inc)

    def dev_shift(self, params, key, value, gidx, prob):
        nv, ng, nprob = self.dev_draw(params, key, value.shape)
        prop = prob / nprob  # = Δx_new/Δx_old (sampler.jl:383-385)
        return nv, ng, nprob, prop


class Discrete(_LeafVar):
    """Pool of integers in [lower, upper] with a learned categorical map.

    Mirrors ``Dist.Discrete`` (variable.jl:272-328).  ``Discrete(bounds)``
    with a list of (lower, upper) pairs returns a :class:`CompositeVar`
    (variable.jl:342-353).
    """

    value_dtype = jnp.int32
    n_uniform_draw = 1

    def __new__(cls, lower=None, upper=None, size=MAX_ORDER, **kwargs):
        if lower is None:
            return super().__new__(cls)  # copy/pickle protocol path
        if isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            first = lower[0]
            if isinstance(first, (list, tuple, np.ndarray)):
                bounds = lower
                dists = kwargs.pop("distribution", [None] * len(bounds))
                members = [
                    Discrete(int(b[0]), int(b[1]), size, distribution=dists[i], **kwargs)
                    for i, b in enumerate(bounds)
                ]
                return CompositeVar(
                    *members,
                    adapt=kwargs.get("adapt", True),
                    offset=kwargs.get("offset", 0),
                    size=size,
                )
            # Discrete((l, u)) tuple form (variable.jl:326-328)
            lower, upper = int(lower[0]), int(lower[1])
        return super().__new__(cls)

    def __init__(self, lower, upper=None, size=MAX_ORDER, *, distribution=None,
                 offset=0, alpha=2.0, adapt=True):
        if isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            if isinstance(lower[0], (list, tuple, np.ndarray)):
                return  # composite path handled in __new__
            lower, upper = int(lower[0]), int(lower[1])
        lower, upper = int(lower), int(upper)
        assert upper >= lower
        assert offset + 1 < size
        self.lower = lower
        self.upper = upper
        self.nbin = upper - lower + 1
        self.offset = int(offset)
        self.alpha = float(alpha)
        self.adapt = bool(adapt)
        self.size = int(size)
        self.histogram = np.full(self.nbin, HIST_FLOOR, dtype=np.float64)
        if distribution is None:
            distribution = np.ones(self.nbin, dtype=np.float64)
        else:
            distribution = np.asarray(distribution, dtype=np.float64)
            assert distribution.shape[0] == self.nbin
        self.distribution, self.accumulation = build_cdf(distribution)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} Discrete variable in [{self.lower}, ..., {self.upper}]."

    # ---- host side --------------------------------------------------
    def train(self):
        if not self.adapt:
            return
        self.distribution, self.accumulation = train_discrete(self.histogram, self.alpha)
        self.clear_statistics()

    def device_params(self, dtype=jnp.float32):
        return {
            "cdf": jnp.asarray(self.accumulation, dtype),
            "dist_tab": jnp.asarray(pack_table(self.distribution), dtype),
            "lower": jnp.int32(self.lower),
        }

    def fixed_values(self, dtype=np.int32):
        n = self.size
        vals = self.lower + (np.arange(n) % self.nbin)
        return vals.astype(dtype)

    # ---- device side ------------------------------------------------
    def dev_draw(self, params, key, shape):
        u = uniform_open01(key, shape)
        gidx, prob = sample_discrete_cdf(u, params["cdf"], params["dist_tab"],
                                         self.nbin)
        value = params["lower"] + gidx
        return value, gidx, prob

    def dev_density(self, params, value, gidx):
        return two_level_take(params["dist_tab"], gidx, 1)[..., 0]

    def dev_shift(self, params, key, value, gidx, prob):
        nv, ng, nprob = self.dev_draw(params, key, value.shape)
        prop = prob / nprob  # dist[old]/dist[new] (sampler.jl:57-71)
        return nv, ng, nprob, prop


class FermiK(_LeafVar):
    """Pool of D-dim momenta sampled near the Fermi surface |K| ∈ (kF-δk, kF+δk).

    Mirrors ``Dist.FermiK`` (variable.jl:1-35, sampler.jl:109-250).  Not
    adaptive; supported by the :mcmc solver only, matching the reference's
    capability boundary (test/bubble_FermiK.jl:2).
    """

    value_dtype = jnp.float32
    adapt = False

    def __init__(self, dim, kF, delta_k, maxK, size=MAX_ORDER, *, offset=0):
        assert dim in (2, 3), "FermiK supports D=2 or 3"
        assert offset + 1 < size
        self.dim = int(dim)
        self.value_width = self.dim
        self.kF = float(kF)
        self.delta_k = float(delta_k)
        self.maxK = float(maxK)
        self.offset = int(offset)
        self.size = int(size)
        self.alpha = 0.0
        self.histogram = np.full(1, HIST_FLOOR, dtype=np.float64)  # no adaptation

    def __repr__(self):
        return f"{self.dim}D FermiK variable in [0, {self.maxK})."

    # ---- host side --------------------------------------------------
    def train(self):
        return

    def device_params(self, dtype=jnp.float32):
        return {
            "kF": jnp.asarray(self.kF, dtype),
            "dk": jnp.asarray(self.delta_k, dtype),
        }

    def fixed_values(self, dtype=np.float32):
        return np.full((self.size, self.dim), self.kF / math.sqrt(self.dim), dtype)

    # ---- device side ------------------------------------------------
    def dev_draw(self, params, key, shape):
        """Fresh draw in the shell: sampler.jl:109-145. prob=0 marks reject."""
        kF, dk = params["kF"], params["dk"]
        u = uniform_open01(key, shape + (3,))
        kamp = kF + (u[..., 0] - 0.5) * 2.0 * dk
        phi = 2.0 * jnp.pi * u[..., 1]
        if self.dim == 3:
            theta = jnp.pi * u[..., 2]
            st, ct = jnp.sin(theta), jnp.cos(theta)
            value = jnp.stack(
                [kamp * jnp.cos(phi) * st, kamp * jnp.sin(phi) * st, kamp * ct],
                axis=-1,
            )
            prop = 2 * dk * 2 * jnp.pi * jnp.pi * st * kamp**2
        else:
            value = jnp.stack([kamp * jnp.cos(phi), kamp * jnp.sin(phi)], axis=-1)
            prop = 2 * dk * 2 * jnp.pi * kamp
        bad = kamp <= 0.0
        prob = jnp.where(bad, 0.0, 1.0 / jnp.maximum(prop, DENS_FLOOR_F32))
        gidx = jnp.zeros(shape, jnp.int32)
        return value, gidx, prob

    def dev_density(self, params, value, gidx):
        """Density of an existing K (remove! proposal): sampler.jl:157-186."""
        kF, dk = params["kF"], params["dk"]
        kamp = jnp.sqrt(jnp.sum(value * value, axis=-1))
        inside = (kamp > kF - dk) & (kamp < kF + dk)
        if self.dim == 3:
            sin_t = jnp.sqrt(value[..., 0] ** 2 + value[..., 1] ** 2) / jnp.maximum(kamp, DENS_FLOOR_F32)
            ok = inside & (sin_t >= 1.0e-15)
            dens = 1.0 / jnp.maximum(2 * dk * 2 * jnp.pi * jnp.pi * sin_t * kamp**2, DENS_FLOOR_F32)
        else:
            ok = inside
            dens = 1.0 / jnp.maximum(2 * dk * 2 * jnp.pi * kamp, DENS_FLOOR_F32)
        return jnp.where(ok, dens, 0.0)

    def dev_shift(self, params, key, value, gidx, prob):
        """Three-way shift: scale / rotate / jitter (sampler.jl:196-244)."""
        kF, dk = params["kF"], params["dk"]
        shape = value.shape[:-1]
        u = uniform_open01(key, shape + (4,))
        sel = u[..., 0]
        lam = 1.5
        # branch 1: radial scale
        ratio = 1.0 / lam + u[..., 1] * (lam - 1.0 / lam)
        v_scale = value * ratio[..., None]
        prop_scale = ratio if self.dim == 3 else jnp.ones_like(ratio)
        # branch 2: uniform re-orientation at fixed |K|
        kamp = jnp.sqrt(jnp.sum(value * value, axis=-1))
        phi = u[..., 1] * 2.0 * jnp.pi
        if self.dim == 3:
            theta = jnp.arccos(jnp.clip(1.0 - 2.0 * u[..., 2], -1.0, 1.0))
            st, ct = jnp.sin(theta), jnp.cos(theta)
            v_rot = jnp.stack(
                [kamp * jnp.cos(phi) * st, kamp * jnp.sin(phi) * st, kamp * ct], axis=-1
            )
        else:
            v_rot = jnp.stack([kamp * jnp.cos(phi), kamp * jnp.sin(phi)], axis=-1)
        # branch 3: component jitter
        uj = uniform_open01(jax.random.fold_in(key, 7), shape + (self.dim,))
        v_jit = value + (uj - 0.5) * dk
        b1 = sel < 1.0 / 3.0
        b2 = (~b1) & (sel < 2.0 / 3.0)
        new_value = jnp.where(
            b1[..., None], v_scale, jnp.where(b2[..., None], v_rot, v_jit)
        )
        prop = jnp.where(b1, prop_scale, 1.0)
        # mcmc never consumes FermiK slot probs (the reference's stored probs
        # are likewise unused/corrupt there, sampler.jl:209); keep prob as-is.
        return new_value, gidx, prob, prop


class CompositeVar:
    """A joint bundle of leaf pools created/shifted together.

    Mirrors ``Dist.CompositeVar`` (variable.jl:397-507): the slot probability
    is the product of the members' slot probabilities, and adaptive training
    recurses into the members.
    """

    def __init__(self, *members, adapt=True, offset=0, size=MAX_ORDER):
        assert all(is_variable(v) for v in members), "all arguments must be variables"
        assert all(not isinstance(v, CompositeVar) for v in members), \
            "CompositeVar members cannot be composite"
        for v in members:
            if not isinstance(v, FermiK):
                v.adapt = adapt
            v.offset = offset
        self.vars = tuple(members)
        self.adapt = bool(adapt)
        self.offset = int(offset)
        self.size = int(size)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} CompositeVar with {len(self.vars)} components."

    def __len__(self):
        return len(self.vars)

    def __getitem__(self, i):
        return self.vars[i]

    def __iter__(self):
        return iter(self.vars)

    # host side
    def train(self):
        for v in self.vars:
            v.train()

    def clear_statistics(self):
        for v in self.vars:
            v.clear_statistics()


def leaves_of(var) -> tuple:
    """Flatten a (possibly composite) variable into its leaf pools."""
    if isinstance(var, CompositeVar):
        return var.vars
    return (var,)
