"""The :vegas+ solver — Vegas importance sampling with adaptive hypercube
stratification (Lepage 2021 "vegas+", cf. the m-CUBES GPU scheme).

Plain Vegas learns a *separable* density prod_d rho_d(x_d); integrands with
correlated structure (e.g. 1/(1-cos x cos y cos z), whose mass lives along a
diagonal) keep large variance no matter how good the 1-D maps are.  vegas+
adds a coarse d-dimensional grid of N_st^D hypercubes in the mapped y-space
and adaptively reallocates samples toward high-variance cubes (Neyman
allocation), which attacks exactly the non-separable variance.

Design (everything static-shaped; no per-sample gather/scatter):

- per-iteration sample counts ``n_c`` are a DEVICE INPUT [ncubes] computed
  on the host from the previous iteration's per-cube variance — shapes never
  change, so the kernel compiles once;
- samples are laid out cube-major, so the sample->cube map is
  ``cumsum(scatter of ones at cube boundaries)`` and any per-cube quantity
  expands to per-sample via a cumsum of boundary deltas — O(T) elementwise;
- per-cube accumulation uses the factored one-hot matmul
  (ops/lookup.py: onehot_accumulate), per-dim Vegas-map lookups use
  two_level_take;
- the sampling density is p(x) = [n_c N_st^D / T] * prod_d rho_d(x_d), and
  the estimator/normalization semantics match the :vegas solver exactly
  (reference src/vegas/montecarlo.jl:148-165), so Result/statistics are
  unchanged.

Host-side reallocation (float64): d_c = sqrt(acc_c / n_c) damped by ^beta
(beta=0.75, Lepage 2021 Eq.(24)) with a 2-sample floor, renormalized to the
chunk size.

Round 2 (VERDICT item 9): Discrete pools ride along as NON-stratified
passenger dims (drawn iid from their learned categorical map; their
density multiplies the joint p), and dof < maxdof works through the same
padding algebra as :vegas — the estimator ``w_i * pad_i / p`` is unbiased
for ANY joint density p because the pad factor (the map density of the
slots integrand i does not use) integrates to one over the unused dims,
so stratification coupling the dims is harmless (variable.jl:628-657
semantics, generalized).

Restrictions: Continuous slots are all stratified (their count D <= 10);
FermiK remains unsupported (as in all vegas-family solvers).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import ksum
from ..ops.grid import uniform_open01
from ..ops.lookup import onehot_accumulate, padded_hist_size, two_level_take
from ..models.variable import Continuous
from .engine import Spec, fetch_stats, zero_hists
from ..parallel.mesh import distribute_rows, gather_rows, ordered_psum


class VegasPlusIteration:
    """One compiled per-iteration kernel for the :vegasplus solver."""

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000,
                 mesh=None, max_chunk=131072, weight_dtype=jnp.float32,
                 obs_proto=None, nstrat=None, max_cubes=16384, beta=0.75,
                 backend="auto"):
        self.spec = spec
        self.block = block
        self.mesh = mesh
        self.beta = beta
        from ..models.variable import Discrete
        for li in spec.leaves:
            if not isinstance(li.leaf, (Continuous, Discrete)):
                raise NotImplementedError(
                    ":vegasplus supports Continuous and Discrete pools; "
                    "FermiK is :mcmc-only (test/bubble_FermiK.jl:2)")

        self.backend = "xla"
        self.backend_reason = (":vegasplus has no fused kernel"
                               if backend == "pallas" else "")

        # stratification dimensions: one per Continuous (leaf, slot);
        # Discrete slots are non-stratified passengers drawn iid from
        # their learned categorical map
        self.dims = []       # (lidx, slot) stratified
        self.passengers = [] # (lidx, slot) iid
        for lidx, li in enumerate(spec.leaves):
            target = (self.passengers if isinstance(li.leaf, Discrete)
                      else self.dims)
            for slot in range(li.ndraw):
                target.append((lidx, slot))
        D = len(self.dims)
        if D == 0:
            raise NotImplementedError(
                ":vegasplus stratifies over Continuous slots and this spec "
                "has none; a pure-Discrete integrand gains nothing from "
                "hypercube stratification — use :vegas")
        assert D <= 10, (
            f"vegasplus supports up to 10 stratified (Continuous) "
            f"dimensions, got {D}")

        c = max(1, min(int(nevalperblock), max_chunk))
        if nstrat is None:
            nstrat = max(2, int((max_cubes) ** (1.0 / D)))
            while nstrat**D > max_cubes:
                nstrat -= 1
            nstrat = max(nstrat, 1 if D > 8 else 2)
        ncubes = nstrat**D
        c = max(c, 2 * ncubes)
        nchunks = max(1, -(-int(nevalperblock) // c))
        self.nstrat = nstrat
        self.ncubes = ncubes
        self.chunk = c
        self.nchunks = nchunks
        self.nevalperblock = c * nchunks
        self.counts = self._uniform_counts()
        n = spec.N
        mf = measurefreq
        uc = spec.uconfig

        eval_fn = spec.make_eval(integrand, inplace, weight_dtype)

        if measure is None:
            obs_zero = np.zeros((n,), weight_dtype)

            def measure_contrib(vals, relw):
                return relw
        else:
            obs_zero = jax.tree_util.tree_map(
                lambda x: np.zeros(np.shape(x), weight_dtype), obs_proto)

            def measure_contrib(vals, relw):
                return measure(spec.view([{"val": v} for v in vals]), relw, uc)

        strides = [nstrat**d for d in range(D)]

        c_pad = padded_hist_size(c)

        def expand(per_cube, boundaries):
            """[ncubes] -> piecewise-constant [c] (cube-major sample layout).

            Scatter-free: boundary deltas land through the factored one-hot
            accumulate (ops/lookup.py) and a cumsum turns them into the
            per-sample step function.
            """
            per_cube = per_cube.astype(jnp.float32)
            deltas = per_cube - jnp.concatenate(
                [per_cube[:1] * 0, per_cube[:-1]])
            starts = jnp.concatenate([jnp.zeros((1,), boundaries.dtype),
                                      boundaries[:-1]])
            arr = onehot_accumulate(jnp.zeros((c_pad,), jnp.float32),
                                    jnp.clip(starts, 0, c - 1), deltas)[:c]
            return jnp.cumsum(arr)

        def run_block(params, kd_row):
            block_key = jax.random.wrap_key_data(kd_row)
            counts = params["counts"]                     # [ncubes] int32
            boundaries = jnp.cumsum(counts)               # inclusive
            nsamp = expand(counts, boundaries)
            cube_f = (expand(jnp.arange(ncubes), boundaries)
                      + 0.5).astype(jnp.int32)

            def chunk_body(carry, t):
                obs_acc, norm_acc, hists, sig_acc = carry
                key_t = jax.random.fold_in(block_key, t)

                leaf_cols = [[None] * li.ndraw for li in spec.leaves]
                slot_rho = {}                             # (lidx, slot) -> [c]
                prob_map = None
                iys = []
                for d, (lidx, slot) in enumerate(self.dims):
                    li = spec.leaves[lidx]
                    ninc = li.leaf.ninc
                    coord = (cube_f // strides[d]) % nstrat
                    u = uniform_open01(
                        jax.random.fold_in(key_t, 11 + d), (c,))
                    y = (coord.astype(jnp.float32) + u) / nstrat
                    tt = y * ninc
                    iy = jnp.clip(tt.astype(jnp.int32), 0, ninc - 1)
                    dy = tt - iy
                    gi = two_level_take(params["leaf"][lidx]["tab"], iy, 2)
                    x = gi[:, 0] + dy * gi[:, 1]
                    rho = 1.0 / (ninc * gi[:, 1])
                    leaf_cols[lidx][slot] = x
                    slot_rho[(lidx, slot)] = rho
                    prob_map = rho if prob_map is None else prob_map * rho
                    iys.append((lidx, slot, iy))
                # Discrete passengers: iid draws from the learned map;
                # their density joins p but not the stratification
                prob_pass = None
                for d, (lidx, slot) in enumerate(self.passengers):
                    li = spec.leaves[lidx]
                    val, gidx, pr = li.leaf.dev_draw(
                        params["leaf"][lidx],
                        jax.random.fold_in(key_t, 211 + d), (c,))
                    leaf_cols[lidx][slot] = val
                    slot_rho[(lidx, slot)] = pr
                    prob_pass = pr if prob_pass is None else prob_pass * pr
                    iys.append((lidx, slot, gidx))

                leaf_vals = [jnp.stack(cols, axis=0) for cols in leaf_cols]
                # sampling density p(x) = (n_c * ncubes / T) * prod_strat
                #                         rho_d * prod_passenger rho
                dens = nsamp * (float(ncubes) / c) * prob_map
                if prob_pass is not None:
                    dens = dens * prob_pass
                jac = 1.0 / dens

                def _per_sample(vals):
                    return eval_fn([{"val": v} for v in vals])

                weights = jax.vmap(_per_sample, in_axes=-1, out_axes=-1)(
                    leaf_vals)                            # [n, c]
                # padding algebra (variable.jl:628-657): relw_i = w_i *
                # pad_i / p with pad_i the map density of the slots
                # integrand i does NOT use — unbiased under any joint p
                # because pad_i integrates to 1 over the unused dims
                gprob = {}
                for (lidx, slot), rho in slot_rho.items():
                    g = spec.leaves[lidx].group
                    key_gs = (g, slot)
                    gprob[key_gs] = (rho if key_gs not in gprob
                                     else gprob[key_gs] * rho)
                relw_rows = []
                pads = []
                for i in range(n):
                    factor = jac
                    pad_i = None
                    if not spec.pad_trivial[i]:
                        for g in range(spec.nvar):
                            for slot in range(spec.cfg.dof[i][g],
                                              spec.maxdof[g]):
                                pad_i = (gprob[(g, slot)] if pad_i is None
                                         else pad_i * gprob[(g, slot)])
                    pads.append(pad_i)
                    if pad_i is not None:
                        factor = factor * pad_i
                    relw_rows.append(weights[i]
                                     * factor.astype(weights.dtype))
                relw = jnp.stack(relw_rows, axis=0)       # [n, c]

                if mf > 1:
                    ne = t * c + jnp.arange(c) + 1
                    mw = ((ne % mf) == 0).astype(jnp.float32)
                    relw_m = relw * mw[None, :]
                    count = jnp.sum(mw)
                else:
                    relw_m = relw
                    count = jnp.asarray(float(c), jnp.float32)

                contrib = jax.vmap(measure_contrib, in_axes=(-1, -1),
                                   out_axes=-1)(leaf_vals, relw_m)
                obs_acc = ksum.tree_kadd(
                    obs_acc, jax.tree_util.tree_map(
                        lambda x: jnp.sum(x, axis=-1), contrib))
                norm_acc = ksum.kadd(norm_acc, count)

                # per-cube second moments for Neyman reallocation (clipped:
                # an untrained map near a singularity must not overflow f32).
                # pad factors join the score so unused-slot noise steers the
                # allocation the same way it inflates the variance
                denom = (prob_map if prob_pass is None
                         else prob_map * prob_pass)
                score = None
                for i in range(n):
                    s = jnp.abs(weights[i])
                    if pads[i] is not None:
                        s = s * pads[i]
                    score = s if score is None else score + s
                wj_map = jnp.minimum(score / denom, 1e17)
                sig_acc = onehot_accumulate(sig_acc, cube_f, wj_map**2)

                # per-dim Vegas-map histograms: |relw_i|^2 summed over the
                # integrands that USE the slot (vegas.py hist masking)
                used = np.asarray(spec.mask_used)[:n]     # static
                wj2_rows = jnp.minimum(jnp.abs(relw), 1e17) ** 2   # [n, c]
                for (lidx, slot, iy) in iys:
                    li = spec.leaves[lidx]
                    if not getattr(li.leaf, "adapt", False):
                        continue
                    mask = used[:, li.group, slot]        # [n] static
                    if not mask.any():
                        continue
                    wj2 = jnp.sum(
                        wj2_rows * jnp.asarray(mask, wj2_rows.dtype)[:, None],
                        axis=0)
                    hists[lidx] = onehot_accumulate(hists[lidx], iy, wj2)
                return (obs_acc, norm_acc, hists, sig_acc), None

            obs0 = ksum.tree_kzeros(obs_zero)
            norm0 = ksum.kzeros(())
            hists0 = zero_hists(spec)
            sig0 = jnp.zeros(padded_hist_size(ncubes), jnp.float32)
            (obs_acc, norm_acc, hists, sig_acc), _ = jax.lax.scan(
                chunk_body, (obs0, norm0, hists0, sig0),
                jnp.arange(self.nchunks))
            return (ksum.tree_kvalue(obs_acc),
                    norm_acc.value, hists, sig_acc)

        def run_all(params, kd):
            obs_b, norm_b, hists_b, sig_b = jax.vmap(
                run_block, in_axes=(None, 0))(params, kd)
            hists = [jnp.sum(h, axis=0) for h in hists_b]
            sig = jnp.sum(sig_b, axis=0)
            return obs_b, norm_b, hists, sig

        if mesh is not None and np.prod(
                [mesh.shape[a] for a in mesh.axis_names]) > 1:
            axis = mesh.axis_names[0]

            def sharded(params, kd):
                def local(params, kd):
                    obs_b, norm_b, hists, sig = run_all(params, kd)
                    hists = [ordered_psum(h, axis) for h in hists]
                    sig = ordered_psum(sig, axis)
                    return obs_b, norm_b, hists, sig

                return jax.shard_map(
                    local, mesh=mesh, in_specs=(P(), P(axis)),
                    out_specs=(P(axis), P(axis), P(), P()),
                    check_vma=False)(params, kd)

            self.raw_fn = sharded
            self._fn = jax.jit(sharded)
        else:
            self.raw_fn = run_all
            self._fn = jax.jit(run_all)

    def _uniform_counts(self) -> np.ndarray:
        base = self.chunk // self.ncubes
        counts = np.full(self.ncubes, base, dtype=np.int64)
        counts[: self.chunk - base * self.ncubes] += 1
        return counts

    def _reallocate(self, sig: np.ndarray):
        """Neyman reallocation with ^beta damping (Lepage 2021 Eq.(24))."""
        acc = np.asarray(sig[: self.ncubes], dtype=np.float64)
        d = np.sqrt(np.maximum(acc / np.maximum(self.counts, 1), 0.0))
        if d.sum() <= 0 or not np.all(np.isfinite(d)):
            return
        d = (d / d.sum()) ** self.beta
        d /= d.sum()
        counts = np.maximum(2, np.floor(d * self.chunk).astype(np.int64))
        # fix the total back to the chunk size
        excess = counts.sum() - self.chunk
        if excess > 0:
            order = np.argsort(-counts)
            for i in order:
                take = min(counts[i] - 2, excess)
                counts[i] -= take
                excess -= take
                if excess <= 0:
                    break
        elif excess < 0:
            counts[np.argmax(counts)] += -excess
        if counts.sum() == self.chunk:
            self.counts = counts

    def reset_state(self):
        """Kernel-cache hook: drop adaptive stratification state so a
        cached kernel starts bit-identical to a fresh build (same-seed
        determinism)."""
        self.counts = self._uniform_counts()

    def run(self, params, key):
        params = dict(params)
        params["counts"] = jnp.asarray(self.counts, jnp.int32)
        kd = np.asarray(jax.random.key_data(jax.random.split(key, self.block)))
        kd = distribute_rows(self.mesh, kd)
        obs_b, norm_b, hists, sig = fetch_stats(self._fn(params, kd))
        obs_b = jax.tree_util.tree_map(gather_rows, obs_b)
        norm_b = gather_rows(norm_b).astype(np.float64)
        hists = [np.asarray(h, dtype=np.float64)[: li.nhist]
                 for h, li in zip(hists, self.spec.leaves)]
        self._reallocate(np.asarray(sig, dtype=np.float64))
        neval = self.block * self.nevalperblock
        return {
            "obs_blocks": obs_b,
            "norm_blocks": norm_b,
            "hists": hists,
            "neval": neval,
        }
