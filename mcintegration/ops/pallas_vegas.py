"""Fused stratified-Vegas kernel for the :vegas solver (Pallas, Triton route).

Replaces the XLA ``run_block`` pipeline of ``solvers/vegas.py`` with one
GPU kernel that keeps the whole sample pipeline in registers:

    counter-hash RNG -> strata permutation -> Vegas-map gather
    -> x = g + dy*inc -> user integrand (traced inside the kernel)
    -> obs reduction + histogram accumulation

The XLA path writes and reads per-sample intermediates and spends
Threefry's rounds on every uniform; the kernel reads only the map tables
(a few KB, cache resident) and writes small per-program partials.

Layout.  A *chunk* is ``nb`` strata rows x ``m`` samples per stratum (the
stratification unit of solvers/vegas.py).  The grid is (block, program);
program ``p`` of block ``b`` loops over chunks ``p*G .. p*G+G-1`` and,
inside each chunk, over tiles of ``R`` strata rows x ``m`` samples.
Nothing carries between programs: each writes its own compensated partial of
every observable and its own histogram, and XLA adds the ``P`` partials
of a block in a fixed order.  No float atomics, so a fixed seed gives the
same bits on every run.

Random bits are a counter hash (lowbias32 ``_mix32``) keyed by (block
key, chunk, stream, sample index), so they do not depend on which program
draws them, nor on the number of blocks or devices.

Histograms.  Stratum row ``k`` of a chunk lands in bin ``perm(k) =
(a*k + s) mod nb`` (a bijection); the kernel scatters each tile's row sums
back to natural bin order with a one-hot product over the factored index
``bin = hi*L + lo`` (``hist2d += (onehot(hi) * row)^T @ onehot(lo)``).
The float operand is split into three bfloat16 parts, so the tensor-core
products reproduce its 24 mantissa bits.

Numerical contract: the estimator of the XLA path
(vegas/montecarlo.jl:117-185 — obs[i] += w_i*pad_i*jac, histogram weight
(|w_i| jac)^2, stratified variance reduction) on a different random
stream, so the two agree statistically, not bit for bit.

Eligibility (checked by solvers/vegas.py, which falls back to XLA with a
reason): every drawn leaf Continuous and stratifiable with one shared bin
count, measurefreq=1, float32 weights, no custom measure.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import ksum

_N_MULT = 64      # multiplier-table width, matches solvers/vegas.py
TILE = 2048       # samples per register tile (strata rows x m)
M_MAX = 128       # samples per stratum per chunk, as solvers/vegas.py
NUM_WARPS = 4
MAX_STRATA = 4096  # histogram side L <= 64 keeps hist2d in registers
PROGRAMS_PER_DEVICE = 1024  # blocks x programs in flight

_GOLD = 0x9E3779B9


def _u32(v):
    return jnp.uint32(v & 0xFFFFFFFF)


def _mix32(x):
    """lowbias32 avalanche mixer (32-bit finalizer), uint32 in/out."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def stream_keys(kd0, kd1, counter):
    """Two key words for one (key, counter) pair, e.g. (block key, chunk)."""
    c = counter.astype(jnp.uint32)
    k1 = _mix32(kd0 ^ _mix32(c * _u32(_GOLD) + _u32(0x243F6A88)))
    k2 = _mix32(kd1 + _mix32(c ^ _u32(0x13198A2E)))
    return k1, k2


def random_bits(k1, k2, salt, idx):
    """32 random bits for each uint32 counter in ``idx``; ``salt`` (uint32
    scalar) separates the streams drawn from one key pair."""
    return _mix32(_mix32(idx ^ k1) + (k2 ^ salt))


def uniform01(bits):
    """Uniform in (0, 1) from 32 random bits, at the 2^-24 grain of
    ops/grid.uniform_open01 (never exactly 0 or 1)."""
    b24 = (bits >> jnp.uint32(8)).astype(jnp.int32)
    return (b24.astype(jnp.float32) + 0.5) * jnp.float32(2.0 ** -24)


def _rem(x, d: int):
    """x mod d for non-negative int32 x (``%`` adds sign fix-ups that the
    Triton lowering rejects)."""
    return jax.lax.rem(x, jnp.int32(d))


def salt_of(stream: int):
    return _u32((stream + 1) * 0x85EBCA6B)


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def hist_side(nbins: int) -> int:
    """Side L of the factored histogram (power of two, >= 16 for the
    tensor-core product, L*L >= nbins)."""
    return max(16, pow2_at_least(int(np.ceil(np.sqrt(max(nbins, 1))))))


def onehot_hist(bins, w, L):
    """[L, L] histogram of weights ``w`` at flat ``bins`` (both 1-D).

    ``(onehot(hi) * w)^T @ onehot(lo)`` with the float weights split into
    three bfloat16 parts: each product is exact and accumulates in f32.
    """
    hi = jax.lax.div(bins, jnp.int32(L))
    lo = bins - hi * L
    oh_hi_t = hi[None, :] == jax.lax.broadcasted_iota(
        jnp.int32, (L, 1), 0)                                  # [L, T]
    oh_lo = (lo[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, L), 1)).astype(jnp.bfloat16)            # [T, L]
    acc = None
    rest = w
    for _ in range(3):
        part = rest.astype(jnp.bfloat16)
        rest = rest - part.astype(jnp.float32)
        a = jnp.where(oh_hi_t, part[None, :], jnp.bfloat16(0))
        d = jnp.dot(a, oh_lo, preferred_element_type=jnp.float32)
        acc = d if acc is None else acc + d
    return acc


class SlotView:
    """The slot axis of one batched leaf: ``x[k]`` is slot k's sample tile.

    Triton has no slicing of register tensors, so the slots stay separate
    arrays; indexing, slicing, ``len`` and iteration behave as on the
    per-sample slot array of Spec.view.  It is not a tuple, so integrands
    that tell CompositeVar members (tuples) from leaves keep working.
    """

    __slots__ = ("_slots",)

    def __init__(self, slots):
        self._slots = tuple(slots)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return SlotView(self._slots[k])
        return self._slots[k]

    def __len__(self):
        return len(self._slots)

    def __iter__(self):
        return iter(self._slots)

    @property
    def dtype(self):
        return self._slots[0].dtype

    @property
    def shape(self):
        return (len(self._slots),) + tuple(self._slots[0].shape)


def build_view(spec):
    """User-facing variable view over batched leaf values.

    ``leaf_vals[lidx]`` is a tuple of per-slot arrays; a leaf's view is a
    :class:`SlotView` of its fixed (offset) slots, as constant fills,
    followed by its drawn slots, so ``x[0]`` indexes a slot exactly as in
    the per-sample view of Spec.view.  CompositeVar groups become tuples
    of member views.
    """
    from ..models.variable import CompositeVar

    def _view(leaf_vals):
        shape = next(v[0].shape for v in leaf_vals if len(v))
        views = []
        for gi, v in enumerate(spec.cfg.var):
            members = []
            for lidx in spec.group_leaves[gi]:
                li = spec.leaves[lidx]
                fv = np.asarray(li.leaf.fixed_values()[: li.offset])
                fixed = tuple(jnp.full(shape, fv[k].item(), jnp.float32)
                              for k in range(li.offset))
                members.append(SlotView(fixed + tuple(leaf_vals[lidx])))
            views.append(tuple(members) if isinstance(v, CompositeVar)
                         else members[0])
        return views[0] if len(views) == 1 else tuple(views)

    return _view


def make_eval_batched(spec, integrand, inplace, weight_dtype):
    """Batched integrand eval on per-slot sample tiles.

    The XLA path vmaps the integrand per sample.  Reference-style
    integrands are elementwise in the samples, so one call on the tiles
    computes the same weights without a vmap; solvers verify that
    equivalence numerically at build time (:func:`validate_batched`) and
    fall back to XLA on any mismatch.
    """
    from ..solvers.engine import WeightBuffer, _finite_guard

    uc = spec.uconfig
    n = spec.N
    _view = build_view(spec)

    def _eval(leaf_vals):
        v = _view(leaf_vals)
        shape = next(x[0].shape for x in leaf_vals if len(x))
        if inplace:
            buf = WeightBuffer(n, weight_dtype)
            integrand(v, buf, uc)
            ws = [buf[i] for i in range(n)]
        else:
            w = integrand(v, uc)
            ws = list(w) if isinstance(w, (tuple, list)) else [w]
            if len(ws) == 1 and n > 1:
                ws = [ws[0][i] for i in range(n)]
        assert len(ws) == n, f"integrand returned {len(ws)} weights, want {n}"
        return [_finite_guard(jnp.broadcast_to(
            jnp.asarray(wi, weight_dtype), shape)) for wi in ws]

    return _eval


def validate_batched(spec, eval_batched, eval_fn) -> bool:
    """Prove batched eval == per-sample vmapped eval on random points.

    Evaluates both on a tiny in-domain batch in one jitted program; any
    mismatch (an integrand that is not elementwise across samples, or one
    that indexes a slot array in a way a tuple view does not support)
    disables the kernel.
    """
    try:
        rng = np.random.default_rng(12345)
        stacked = []
        for li in spec.leaves:
            lo = float(getattr(li.leaf, "lower", 0.0))
            rg = float(getattr(li.leaf, "range", 1.0))
            u = rng.uniform(0.05, 0.95, (li.ndraw, 4, 2))
            stacked.append(jnp.asarray(lo + rg * u, jnp.float32))

        def per_sample(vals):
            return eval_fn([{"val": v} for v in vals])

        @jax.jit
        def probe(stacked):
            tiles = [tuple(a[k] for k in range(a.shape[0])) for a in stacked]
            wb = jnp.stack(eval_batched(tiles))
            wv = jax.vmap(jax.vmap(per_sample, in_axes=-1, out_axes=-1),
                          in_axes=-1, out_axes=-1)(stacked)
            return jnp.allclose(wb, wv, rtol=1e-5, atol=1e-6)

        return bool(probe(stacked))
    except Exception:
        return False


def eligible(spec, plans, *, measure, measurefreq, weight_dtype,
             why=None) -> bool:
    """Can the fused kernel run this spec?  On a False return a one-line
    reason is appended to ``why`` (surfaced as ``Result.backend_reason``)."""
    from ..models.variable import Continuous

    def no(reason):
        if why is not None:
            why.append(reason)
        return False

    if measurefreq != 1:
        return no(f"measurefreq={measurefreq} != 1 runs on the XLA path")
    if weight_dtype != jnp.float32:
        return no(f"weight dtype {jnp.dtype(weight_dtype).name} runs on the "
                  "XLA path (kernel accumulators are float32)")
    if measure is not None:
        return no("custom measures run on the XLA path")
    drawn = [(li, plan) for li, plan in zip(spec.leaves, plans)
             if li.ndraw > 0]
    if not drawn:
        return no("no MC-owned slots to draw")
    if any(not isinstance(li.leaf, Continuous) or plan is None
           for li, plan in drawn):
        return no("a drawn pool has no stratified sampling plan "
                  "(Discrete pools run on the XLA :vegas path)")
    nbs = {plan["nb"] for _, plan in drawn}
    if len(nbs) != 1:
        return no("drawn pools have mismatched strata counts")
    nb = nbs.pop()
    if nb > MAX_STRATA:
        return no(f"strata count {nb} > {MAX_STRATA} (register histogram)")
    return True


def chunk_layout(nb: int, nevalperblock: int, nblock: int):
    """(m, G, P): samples per stratum per chunk, chunks per program and
    programs per block for ``nevalperblock`` samples per block, sized so
    ``nblock`` blocks (all of them, on every mesh size) fill one card."""
    m = 1
    while m * 2 <= min(M_MAX, max(1, nevalperblock // nb)):
        m *= 2
    nchunks = max(1, -(-nevalperblock // (nb * m)))
    pmax = max(1, PROGRAMS_PER_DEVICE // max(nblock, 1))
    g = -(-nchunks // pmax)
    p = -(-nchunks // g)
    return m, g, p


def build_run_all(spec, plans, eval_batched: Callable, *, m: int,
                  chunks_per_program: int, programs: int,
                  interpret: bool = False):
    """Return run_all(params, kd[B, 2] uint32) -> (obs [B, N], norm [B],
    per-block hists: list of [B, padded_hist_size]).
    """
    from .lookup import padded_hist_size

    n = spec.N
    leaves = spec.leaves
    dleaf = [i for i, li in enumerate(leaves) if li.ndraw > 0]
    slot_map = [(lidx, s) for lidx in dleaf for s in range(leaves[lidx].ndraw)]
    nb = plans[dleaf[0]]["nb"]
    R = min(max(16, TILE // m), max(16, pow2_at_least(nb)))
    nbp = -(-nb // R) * R
    ntiles = nbp // R
    L = hist_side(nbp)
    used = np.asarray(spec.mask_used)[:n]            # [n, nvar, mm] static
    hist_leaves = [
        lidx for lidx in dleaf
        if getattr(leaves[lidx].leaf, "adapt", False)
        and any(used[:, leaves[lidx].group, s].any()
                for s in range(leaves[lidx].ndraw))]
    G, P = chunks_per_program, programs
    f32 = jnp.float32
    a_tab_np = np.stack([np.asarray(plans[lidx]["a_tab"])[s]
                         for (lidx, s) in slot_map]).astype(np.int32)

    def kernel(kd_ref, atab_ref, *refs):
        nd = len(dleaf)
        pg_refs = dict(zip(dleaf, refs[:nd]))
        pi_refs = dict(zip(dleaf, refs[nd:2 * nd]))
        obs_ref = refs[2 * nd]
        hist_ref = refs[2 * nd + 1] if hist_leaves else None

        b = pl.program_id(0)
        p = pl.program_id(1)
        kd0 = kd_ref[b, 0]
        kd1 = kd_ref[b, 1]
        rows0 = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (R, m), 1)

        def chunk_body(g, carry):
            t = p * G + g
            k1, k2 = stream_keys(kd0, kd1, t)
            # per-(slot, chunk) strata permutation perm(k) = (a*k + s) mod nb
            svals, avals = [], []
            zero = jnp.uint32(0)
            for k in range(len(slot_map)):
                sb = random_bits(k1, k2, salt_of(2 * k), zero)
                jb = random_bits(k1, k2, salt_of(2 * k + 1), zero)
                svals.append(_rem((sb >> jnp.uint32(1)).astype(jnp.int32), nb))
                j = _rem((jb >> jnp.uint32(1)).astype(jnp.int32), _N_MULT)
                avals.append(atab_ref[k, j])

            def tile_body(r, carry):
                obs, hists = carry
                rows = r * R + rows0
                valid = rows < nb
                rowmask = valid.astype(f32)[:, None]                 # [R,1]
                ctr = (rows[:, None] * m + cols).astype(jnp.uint32)  # [R,m]
                xs, invp, perms = {}, {}, {}
                for k, (lidx, slot) in enumerate(slot_map):
                    perm = jnp.where(valid,
                                     _rem(avals[k] * rows + svals[k], nb),
                                     rows)
                    pg = pg_refs[lidx][perm]
                    pi = pi_refs[lidx][perm]
                    dy = uniform01(random_bits(
                        k1, k2, salt_of(2 * len(slot_map) + k), ctr))
                    xs[(lidx, slot)] = pg[:, None] + dy * pi[:, None]
                    invp[(lidx, slot)] = (nb * pi)[:, None]
                    perms[(lidx, slot)] = perm
                jac = None
                for key in xs:
                    jac = invp[key] if jac is None else jac * invp[key]
                gprob = {}
                for gi in range(spec.nvar):
                    for slot in range(spec.maxdof[gi]):
                        q = None
                        for lidx in spec.group_leaves[gi]:
                            qi = 1.0 / invp[(lidx, slot)]
                            q = qi if q is None else q * qi
                        gprob[(gi, slot)] = q

                leaf_vals = [tuple(xs[(lidx, s)] for s in range(li.ndraw))
                             for lidx, li in enumerate(leaves)]
                weights = eval_batched(leaf_vals)          # n x [R, m]

                # obs[i] += w_i * padding_i * jac (montecarlo.jl:148-165)
                new_obs = []
                for i in range(n):
                    factor = jac * rowmask
                    if not spec.pad_trivial[i]:
                        for gi in range(spec.nvar):
                            for slot in range(spec.cfg.dof[i][gi],
                                              spec.maxdof[gi]):
                                factor = factor * gprob[(gi, slot)]
                    rowsum = jnp.sum(weights[i] * factor, axis=1)
                    new_obs.append(ksum.kadd(obs[i], jnp.sum(rowsum)))

                # histograms: (|w_i| jac)^2 summed over the integrands that
                # use the slot, per stratum row, scattered back through perm
                new_hists = list(hists)
                if hist_leaves:
                    wj2 = [jnp.minimum(jnp.abs(w) * jac, 1e17) ** 2
                           for w in weights]
                    for h, lidx in enumerate(hist_leaves):
                        li = leaves[lidx]
                        for slot in range(li.ndraw):
                            mask = used[:, li.group, slot]
                            if not mask.any():
                                continue
                            sw = None
                            for i in range(n):
                                if mask[i]:
                                    sw = wj2[i] if sw is None else sw + wj2[i]
                            row = jnp.sum(sw, axis=1) * valid.astype(f32)
                            new_hists[h] = new_hists[h] + onehot_hist(
                                perms[(lidx, slot)], row, L)
                return tuple(new_obs), tuple(new_hists)

            return jax.lax.fori_loop(0, ntiles, tile_body, carry)

        z = jnp.zeros((), f32)
        obs0 = tuple(ksum.KSum(z, z) for _ in range(n))
        hist0 = tuple(jnp.zeros((L, L), f32) for _ in hist_leaves)
        obs, hists = jax.lax.fori_loop(0, G, chunk_body, (obs0, hist0))
        for i in range(n):
            obs_ref[b, p, i] = obs[i].value
        for h in range(len(hist_leaves)):
            hist_ref[b, p, h] = hists[h]

    def run_all(params, kd):
        B = kd.shape[0]
        pgs, pis = [], []
        for lidx in dleaf:
            tab = params["leaf"][lidx]["tab"]
            Lt = tab.shape[0]
            flat = tab.reshape(Lt * Lt, 2)[:nb]
            # padded rows sample in-domain (weights are masked to zero)
            pad = jnp.broadcast_to(flat[:1], (nbp - nb, 2))
            flat = jnp.concatenate([flat, pad], axis=0)
            pgs.append(flat[:, 0])
            pis.append(flat[:, 1])
        out_shape = [jax.ShapeDtypeStruct((B, P, n), jnp.float32)]
        if hist_leaves:
            out_shape.append(jax.ShapeDtypeStruct(
                (B, P, len(hist_leaves), L, L), jnp.float32))
        outs = pl.pallas_call(
            kernel,
            grid=(B, P),
            out_shape=out_shape,
            backend="triton",
            interpret=interpret,
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                               num_stages=1),
            name="vegas_strata",
        )(kd, jnp.asarray(a_tab_np), *pgs, *pis)
        obs_b = add_in_order(outs[0])
        hist_out = {}
        if hist_leaves:
            hb = add_in_order(outs[1])                       # [B, nh, L, L]
            for h, lidx in enumerate(hist_leaves):
                hist_out[lidx] = hb[:, h].reshape(B, L * L)[:, :nb]
        hists = []
        for lidx, li in enumerate(leaves):
            size = padded_hist_size(li.nhist)
            h = hist_out.get(lidx)
            if h is None:
                hists.append(jnp.zeros((B, size), jnp.float32))
            else:
                hists.append(jnp.pad(h, ((0, 0), (0, size - h.shape[1]))))
        norm_b = jnp.full((B,), float(nb * m * G * P), jnp.float32)
        return obs_b, norm_b, hists

    return run_all


def add_in_order(x):
    """Sum axis 1 of ``x`` (per-program partials) as a fixed pairwise tree
    of elementwise adds: each block's sum is the same bits whatever the
    number of blocks or devices beside it (a reduction's order may follow
    the shape it is compiled for)."""
    q = x.shape[1]
    width = pow2_at_least(q)
    if width > q:
        pad = [(0, 0)] * x.ndim
        pad[1] = (0, width - q)
        x = jnp.pad(x, pad)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]
