"""Shared device-side machinery for the three solvers.

Compiles a :class:`~mcintegration.configuration.Configuration` into a
static :class:`Spec` (shapes, dof masks, leaf layout) plus per-iteration
device parameters (grids/CDFs/reweight as jnp arrays), and provides the
batched pool-state primitives that replace the reference's mutate-in-place
pool operations (src/distribution/sampler.jl):

- pools are dicts of dense arrays ``{"val": [..., nslots(, D)],
  "gidx": [..., ndraw], "prob": [..., ndraw]}`` per leaf, batched over
  walkers/samples;
- ``probability`` / ``padding_probability`` (src/distribution/variable.jl:
  587-678) become masked products over a static dof mask;
- histogram accumulation (variable.jl:196-200, 362-367) becomes a
  scatter-add over gidx with solver-specific weights.

User integrands are pure JAX functions evaluated under ``vmap`` over the
sample batch — the key architectural inversion vs the reference's
one-point-per-call closure (SURVEY.md §7.1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..configuration import Configuration
from ..models.variable import CompositeVar, FermiK, leaves_of


class UserConfig:
    """The lightweight config object passed into user integrands.

    Exposes the commonly used attributes of the reference ``Configuration``
    (userdata, dof, N, norm, maxdof).  It is a static trace-time object; any
    arrays inside ``userdata`` become constants of the compiled kernel.
    """

    def __init__(self, cfg: Configuration):
        self.userdata = cfg.userdata
        self.dof = cfg.dof
        self.N = cfg.N
        self.norm = cfg.norm
        self.maxdof = cfg.maxdof


class WeightBuffer:
    """Mutable weights buffer shim for ``inplace=True`` integrands.

    The reference's inplace mode writes weights into a preallocated array
    (src/vegas/montecarlo.jl:141-144); in JAX the same user code shape works
    by recording the assignments at trace time.
    """

    def __init__(self, n: int, dtype):
        self.n = n
        self.dtype = dtype
        self._vals = [jnp.zeros((), dtype)] * n

    def __setitem__(self, i, v):
        self._vals[i] = v

    def __getitem__(self, i):
        return self._vals[i]

    def __len__(self):
        return self.n

    def stack(self):
        return jnp.stack([jnp.asarray(v, self.dtype) for v in self._vals])


@dataclasses.dataclass
class LeafInfo:
    group: int          # which var-type (dof column) this leaf belongs to
    leaf: Any           # the host-side variable object
    offset: int         # leading user-pinned slots
    ndraw: int          # = maxdof of the group: slots the MC owns
    nslots: int         # offset + ndraw (visible to the integrand)
    nhist: int          # histogram bins


class Spec:
    """Static compilation of a Configuration for device kernels."""

    def __init__(self, cfg: Configuration, dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.N = cfg.N
        self.norm = cfg.norm
        self.nvar = cfg.nvar
        self.maxdof = list(cfg.maxdof)
        self.uconfig = UserConfig(cfg)

        self.leaves: List[LeafInfo] = []
        self.group_leaves: List[List[int]] = [[] for _ in range(cfg.nvar)]
        for gi, v in enumerate(cfg.var):
            for leaf in leaves_of(v):
                li = LeafInfo(
                    group=gi,
                    leaf=leaf,
                    offset=getattr(leaf, "offset", 0),
                    ndraw=cfg.maxdof[gi],
                    nslots=getattr(leaf, "offset", 0) + cfg.maxdof[gi],
                    nhist=leaf.nhist,
                )
                self.group_leaves[gi].append(len(self.leaves))
                self.leaves.append(li)

        nd = cfg.N + 1
        # dof mask [nd, nvar, max_maxdof]: True where slot pos < dof[i][v]
        mm = max(self.maxdof) if self.maxdof else 0
        self.max_maxdof = mm
        used = np.zeros((nd, cfg.nvar, max(mm, 1)), dtype=bool)
        for i in range(nd):
            for v in range(cfg.nvar):
                used[i, v, : cfg.dof[i][v]] = True
        self.mask_used = jnp.asarray(used)
        # padding mask: slot used by the FULL space but not by integrand i
        full = np.zeros((cfg.nvar, max(mm, 1)), dtype=bool)
        for v in range(cfg.nvar):
            full[v, : cfg.maxdof[v]] = True
        self.mask_pad = jnp.asarray(full[None, :, :] & ~used)
        self.mask_full = jnp.asarray(full)
        # integrands whose dof == maxdof need no padding factor (all True rows)
        self.pad_trivial = [bool(np.all(~(full[None] & ~used)[i])) for i in range(nd)]
        self.all_pad_trivial = all(self.pad_trivial[: cfg.N + 1])

        self.dof_np = np.asarray(cfg.dof, dtype=np.int32)  # [nd, nvar]

    # ------------------------------------------------------------------
    def device_params(self):
        """Per-iteration device constants: leaf map params + reweight."""
        return {
            "leaf": [li.leaf.device_params(self.dtype) for li in self.leaves],
            "reweight": jnp.asarray(self.cfg.reweight, self.dtype),
        }

    def fixed_leaf_values(self, li: LeafInfo):
        fv = li.leaf.fixed_values()
        return jnp.asarray(fv[: li.offset])

    # ------------------------------------------------------------------
    # pool state: list over leaves of {"val","gidx","prob"}
    # ------------------------------------------------------------------
    def draw_all(self, params, key, batch_shape: Tuple[int, ...]):
        """Fresh draw of every MC-owned slot of every leaf (initialize!).

        Reference: Dist.initialize! (variable.jl:576-580).
        Returns pools: list of dicts with val [..., ndraw(,D)],
        gidx [..., ndraw] int32, prob [..., ndraw].
        """
        pools = []
        for i, li in enumerate(self.leaves):
            k = jax.random.fold_in(key, i)
            shape = batch_shape + (li.ndraw,)
            val, gidx, prob = li.leaf.dev_draw(params["leaf"][i], k, shape)
            pools.append({"val": val, "gidx": gidx, "prob": prob})
        return pools

    def view(self, pools, sample_idx=None):
        """Build the user-facing variable view for one sample.

        ``pools`` must already be per-sample (no batch dims) — solvers vmap
        the integrand over the batch.  A leaf view is the full slot array:
        fixed offset slots followed by the drawn slots.
        """
        views = []
        for gi, v in enumerate(self.cfg.var):
            member_views = []
            for lidx in self.group_leaves[gi]:
                li = self.leaves[lidx]
                drawn = pools[lidx]["val"]
                if li.offset > 0:
                    fixed = self.fixed_leaf_values(li)
                    full = jnp.concatenate([fixed, drawn], axis=0)
                else:
                    full = drawn
                member_views.append(full)
            if isinstance(v, CompositeVar):
                views.append(tuple(member_views))
            else:
                views.append(member_views[0])
        if len(views) == 1:
            return views[0]
        return tuple(views)

    # ------------------------------------------------------------------
    # probability algebra (reference variable.jl:587-678)
    # ------------------------------------------------------------------
    def slot_probs(self, pools):
        """Per-group slot probabilities [..., max_maxdof], padded with 1."""
        mm = max(self.max_maxdof, 1)
        out = []
        for gi in range(self.nvar):
            lidxs = self.group_leaves[gi]
            p = pools[lidxs[0]]["prob"]
            for lidx in lidxs[1:]:
                p = p * pools[lidx]["prob"]
            ndraw = self.leaves[lidxs[0]].ndraw
            if ndraw < mm:
                pad_shape = p.shape[:-1] + (mm - ndraw,)
                p = jnp.concatenate([p, jnp.ones(pad_shape, p.dtype)], axis=-1)
            out.append(p)
        return jnp.stack(out, axis=-2)  # [..., nvar, mm]

    def padding_probability(self, slotp, i: int):
        """prod of probs over slots NOT used by integrand i (variable.jl:628-641)."""
        if self.pad_trivial[i]:
            return jnp.ones(slotp.shape[:-2], slotp.dtype)
        m = self.mask_pad[i]
        return jnp.prod(jnp.where(m, slotp, 1.0), axis=(-1, -2))

    def probability(self, slotp, i: int):
        """prod of probs over slots used by integrand i (variable.jl:606-619)."""
        m = self.mask_used[i]
        return jnp.prod(jnp.where(m, slotp, 1.0), axis=(-1, -2))

    def total_probability(self, slotp):
        m = self.mask_full
        return jnp.prod(jnp.where(m, slotp, 1.0), axis=(-1, -2))

    # ------------------------------------------------------------------
    # integrand evaluation
    # ------------------------------------------------------------------
    def make_eval(self, integrand: Callable, inplace: bool, weight_dtype):
        """Return f(pools_per_sample) -> weights [N] for vegas/vegasmc."""
        uc = self.uconfig
        n = self.N

        def _eval(pools):
            v = self.view(pools)
            if inplace:
                buf = WeightBuffer(n, weight_dtype)
                integrand(v, buf, uc)
                w = buf.stack()
            else:
                w = pack_weights(integrand(v, uc), n, weight_dtype)
            return _finite_guard(w)

        return _eval

    def make_eval_one(self, integrand: Callable, idx: int, weight_dtype):
        """Return f(pools_per_sample) -> scalar weight of integrand ``idx``
        (mcmc convention: integrand(idx, var, config), mcmc/montecarlo.jl:34)."""
        uc = self.uconfig

        def _eval(pools):
            v = self.view(pools)
            w = jnp.asarray(integrand(idx, v, uc), weight_dtype)
            return _finite_guard(w)

        return _eval


def _finite_guard(w):
    """Zero out non-finite integrand values.

    In float32 a singular integrand can overflow to inf within ~1 ulp of its
    singular point (the reference runs in float64 where this is a
    measure-zero hazard); an inf/NaN weight would poison every accumulator.
    The zeroed region is O(ulp)-measure, far below the statistical error —
    and users should still prefer numerically stable forms (see README).
    """
    if jnp.iscomplexobj(w):
        ok = jnp.isfinite(jnp.real(w)) & jnp.isfinite(jnp.imag(w))
    else:
        ok = jnp.isfinite(w)
    return jnp.where(ok, w, 0)


def pack_weights(w, n: int, dtype):
    """Normalize a user integrand return (scalar/tuple/list/array) to [n]."""
    if isinstance(w, (tuple, list)):
        assert len(w) == n, f"integrand returned {len(w)} weights, expected {n}"
        return jnp.stack([jnp.asarray(x, dtype) for x in w])
    w = jnp.asarray(w, dtype)
    if w.ndim == 0:
        assert n == 1, f"integrand returned a scalar but {n} integrands are defined"
        return w[None]
    assert w.shape == (n,), f"integrand returned shape {w.shape}, expected ({n},)"
    return w


def gather_slot(arr, idx):
    """arr [W, ndraw(, D)], idx [W] -> the per-walker slot entry [W(, D)].

    Masked reduction over the (small, static) slot axis instead of
    take_along_axis.
    """
    nd = arr.shape[1]
    oh = idx[:, None] == jnp.arange(nd, dtype=idx.dtype)
    if arr.ndim == 3:
        return jnp.sum(jnp.where(oh[..., None], arr, 0), axis=1)
    return jnp.sum(jnp.where(oh, arr, 0), axis=1)


def scatter_slot(arr, idx, value):
    """Functional update of one slot per walker (masked select, no scatter)."""
    nd = arr.shape[1]
    oh = idx[:, None] == jnp.arange(nd, dtype=idx.dtype)
    if arr.ndim == 3:
        return jnp.where(oh[..., None], value[:, None, :], arr)
    return jnp.where(oh, value[:, None], arr)


def take_rows(table, idx):
    """Row lookup ``table[idx]`` for a small static table via one-hot matmul.

    ``table``: [K] or [K, cols] (K small — dof tables, neighbor lists,
    reweight vectors); ``idx``: [...] int.  Exact for float32 tables and for
    integer tables with small values (0/1 one-hot coefficients select a
    single row).  No gather instruction is emitted.
    """
    squeeze = table.ndim == 1
    t = table[:, None] if squeeze else table
    k = t.shape[0]
    oh = (idx[..., None] == jnp.arange(k, dtype=idx.dtype))
    if jnp.issubdtype(t.dtype, jnp.integer):
        out = jnp.sum(jnp.where(oh[..., None], t, 0), axis=-2)
    else:
        out = jnp.sum(oh[..., None].astype(t.dtype) * t, axis=-2)
    return out[..., 0] if squeeze else out


def accumulate_hists(spec: Spec, hists, pools, slot_weights):
    """Scatter-add per-leaf histogram contributions.

    ``slot_weights``: [batch..., nvar, max_maxdof] accumulation weight for
    each (group, slot); each leaf of a group receives the same weight at its
    own gidx (CompositeVar accumulate! recursion, variable.jl:474-478).
    Histograms are padded to a square size and updated through the factored
    one-hot matmul (ops/lookup.py).
    Returns updated hists list (adapt-gated).
    """
    from ..ops.lookup import onehot_accumulate

    new_hists = []
    for lidx, li in enumerate(spec.leaves):
        h = hists[lidx]
        if not getattr(li.leaf, "adapt", False):
            new_hists.append(h)
            continue
        w = slot_weights[..., li.group, : li.ndraw]
        gidx = pools[lidx]["gidx"]
        new_hists.append(onehot_accumulate(h, gidx, w))
    return new_hists


def zero_hists(spec: Spec, dtype=jnp.float32):
    from ..ops.lookup import padded_hist_size

    return [jnp.zeros(padded_hist_size(li.nhist), dtype) for li in spec.leaves]


def fetch_stats(outs):
    """One batched device->host fetch of an iteration's statistics pytree.

    ``jax.device_get`` starts the copies for the whole tree before
    blocking, instead of one blocking transfer per output.  Multi-host
    runs keep their shard-aware gather path (gather_rows /
    process_allgather).
    """
    if jax.process_count() > 1:
        return outs
    return jax.device_get(outs)


def kernel_platform(mesh) -> str:
    """Platform of the devices a solver kernel runs on."""
    devs = (np.asarray(mesh.devices).ravel() if mesh is not None
            else jax.devices())
    return devs[0].platform


def no_gpu_reason(mesh) -> str:
    """``backend_reason`` when the fused kernels cannot run natively."""
    plat = kernel_platform(mesh)
    if plat == "cpu":
        return ("no GPU device (interpret-mode Pallas is slower than XLA; "
                "pass backend='pallas' to force it)")
    return f"the fused kernels run on CUDA GPUs, not on '{plat}'"


def lower_or_reason(fn, *args) -> str:
    """Lower ``fn`` for the default device; '' on success, else a one-line
    ``backend_reason``.  Triton rejects an integrand op it cannot express
    while lowering, so this check runs before any iteration."""
    try:
        jax.jit(fn).lower(*args)
    except Exception as e:  # any lowering error routes the spec to XLA
        msg = str(e).strip().splitlines()[0][:200] if str(e).strip() else ""
        return (f"the integrand does not lower in the Triton kernel "
                f"({type(e).__name__}: {msg})")
    return ""
