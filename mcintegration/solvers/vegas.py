"""The :vegas solver — stratified Vegas importance sampling, batched.

Reference semantics (src/vegas/montecarlo.jl:72-191): every step redraws ALL
``maxdof`` slots through the learned maps, computes jac = prod 1/prob,
evaluates the full weight vector once, accumulates
``obs[i] += w[i] * padding_probability[i] * jac`` and per-slot histogram
weight ``(|w[i]|*jac)^2``; ``normalization`` counts measured samples.  No
Metropolis accept/reject: every sample counts.

Design — the key throughput idea is **stratification**: under the Vegas
map the bin index iy = floor(y*N) of a uniform y is itself uniform over the
N increments, so a chunk of c = N*m samples can allocate exactly m samples
per increment, laid out as a dense [N, m] tensor.  The per-sample random
table gather becomes a single [N]-row lookup; cross-dimension independence
is restored by a random affine permutation sigma(b) = (a*b + s) mod N of
the strata per (pool, slot) per chunk (a: host-chosen coprime, s: fresh
each chunk), whose inverse is again affine, so histogram row-sums
un-permute with one O(N) take — no scatter anywhere.  This is classical
stratified VEGAS (Lepage 2021; cf. the m-CUBES GPU scheme) and is
variance-reducing vs iid.  On a CUDA GPU the same algorithm runs as one
fused Triton kernel (ops/pallas_vegas.py).

Pools that cannot stratify (chunk not a multiple of their bin count, or
Discrete) draw per-sample through the factored one-hot lookup
(ops/lookup.py).  Blocks (the reference's error-bar lanes,
src/main.jl:296-320) are vmapped and sharded over the device mesh; each
block returns its own histogram, and the host adds the blocks in a fixed
order, so a fixed seed gives the same bits on any mesh size.  Per-block
sums use Kahan-compensated float32 (ops/ksum.py).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import ksum
from ..ops.grid import uniform_open01
from ..ops.lookup import level_size, onehot_accumulate, two_level_take
from ..models.variable import Continuous, Discrete, FermiK
from .engine import (Spec, fetch_stats, kernel_platform, lower_or_reason,
                     no_gpu_reason, zero_hists)
from ..parallel.mesh import distribute_rows, gather_rows, mesh_size


def _tree_sum_last(tree):
    return jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=-1), tree)


def _coprime_multipliers(rng: np.random.Generator, nb: int, count: int):
    """Random multipliers coprime to nb (so b -> (a*b+s) mod nb permutes)."""
    out = []
    while len(out) < count:
        a = int(rng.integers(1, max(nb, 2)))
        if math.gcd(a, nb) == 1:
            out.append(a)
    return out


class VegasIteration:
    """One compiled per-iteration kernel for the :vegas solver."""

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000,
                 mesh=None, max_chunk=131072, weight_dtype=jnp.float32,
                 obs_proto=None, backend="auto"):
        self.spec = spec
        self.block = block
        self.mesh = mesh
        for li in spec.leaves:
            if isinstance(li.leaf, FermiK) and li.ndraw > 0:
                raise NotImplementedError(
                    "FermiK pools are supported by the :mcmc solver only "
                    "(reference capability boundary, test/bubble_FermiK.jl:2)")

        # ---- chunk shaping: prefer c = ninc * m with m a lane multiple ----
        nincs = sorted({li.leaf.ninc for li in spec.leaves
                        if isinstance(li.leaf, Continuous) and li.ndraw > 0},
                       reverse=True)
        c = max(1, min(nevalperblock, max_chunk))
        if nincs and c >= nincs[0]:
            nb0 = nincs[0]
            m = max(1, c // nb0)
            if m >= 128:
                m = (m // 128) * 128
            c = nb0 * m
        nchunks = max(1, -(-nevalperblock // c))
        self.chunk = c
        self.nchunks = nchunks
        self.nevalperblock = c * nchunks
        self.measurefreq = measurefreq
        self.weight_dtype = weight_dtype

        # ---- per-leaf sampling plan ----
        host_rng = np.random.default_rng(spec.cfg.seed + 77)
        plans = []  # per leaf: None (per-sample draw) or stratification info
        for li in spec.leaves:
            leaf = li.leaf
            if (isinstance(leaf, Continuous) and li.ndraw > 0
                    and c % leaf.ninc == 0):
                nb = leaf.ninc
                # a fresh multiplier is drawn per (slot, chunk) from this
                # table so strata "lattice lines" change direction every
                # chunk — keeps cross-dimension coverage diverse and block
                # error bars honest for corner-singular integrands
                n_mult = 64
                a_list = _coprime_multipliers(host_rng, nb, n_mult * li.ndraw)
                plans.append({
                    "nb": nb,
                    "m": c // nb,
                    "a_tab": jnp.asarray(a_list, jnp.int32).reshape(
                        li.ndraw, n_mult),
                    "ainv_tab": jnp.asarray(
                        [pow(a, -1, nb) for a in a_list], jnp.int32).reshape(
                        li.ndraw, n_mult),
                    "n_mult": n_mult,
                    "lpad": level_size(nb),
                })
            else:
                plans.append(None)
        self.plans = plans

        eval_fn = spec.make_eval(integrand, inplace, weight_dtype)

        # ---- fused Triton kernel (ops/pallas_vegas.py) on a CUDA GPU;
        # the XLA pipeline below serves every other spec and platform ----
        self.backend = "xla"
        self.backend_reason = ("backend='xla' requested" if backend == "xla"
                               else "")
        pallas_run_all = None
        if backend != "xla":
            pallas_run_all = self._build_kernel(
                integrand, eval_fn, measure, inplace, measurefreq,
                weight_dtype, nevalperblock, force=backend == "pallas")

        n = spec.N
        mf = measurefreq
        uc = spec.uconfig

        if measure is None:
            obs_zero = np.zeros((n,), weight_dtype)

            def measure_contrib(vals, relw):
                return relw  # obs[i] += relative weight (montecarlo.jl:151-153)
        else:
            obs_zero = jax.tree_util.tree_map(
                lambda x: np.zeros(np.shape(x), weight_dtype), obs_proto)

            def measure_contrib(vals, relw):
                pools = [{"val": v} for v in vals]
                return measure(spec.view(pools), relw, uc)

        def draw_leaf_slot(params, key, lidx, slot):
            """Returns (x [c], prob [c], hist_info) for one MC-owned slot."""
            li = spec.leaves[lidx]
            plan = plans[lidx]
            if plan is not None:
                nb, m = plan["nb"], plan["m"]
                j = jax.random.randint(jax.random.fold_in(key, 3), (), 0,
                                       plan["n_mult"])
                sel = (jnp.arange(plan["n_mult"]) == j)
                a = jnp.sum(jnp.where(sel, plan["a_tab"][slot], 0))
                s = jax.random.randint(jax.random.fold_in(key, 0), (), 0, nb)
                perm = (a * jnp.arange(nb) + s) % nb
                gi = two_level_take(params["leaf"][lidx]["tab"], perm, 2)
                pg, pi = gi[:, 0:1], gi[:, 1:2]                  # [nb,1]
                dy = uniform_open01(jax.random.fold_in(key, 1), (nb, m))
                x = (pg + dy * pi).reshape(c)
                prob = jnp.broadcast_to(1.0 / (nb * pi), (nb, m)).reshape(c)
                return x, prob, ("strat", lidx, slot, (s, j))
            # per-sample draw through the learned map (ops/lookup.py path)
            val, gidx, prob = li.leaf.dev_draw(params["leaf"][lidx],
                                               jax.random.fold_in(key, 2), (c,))
            return val, prob, ("direct", lidx, slot, gidx)

        def hist_update(hists, info, slot_w):
            """Accumulate (|w| jac)^2 at the slot's bins (montecarlo.jl:170-185)."""
            kind, lidx, slot, aux = info
            li = spec.leaves[lidx]
            if not getattr(li.leaf, "adapt", False):
                return hists
            h = hists[lidx]
            if kind == "strat":
                plan = plans[lidx]
                nb, m, lpad = plan["nb"], plan["m"], plan["lpad"]
                s, j = aux
                sel = (jnp.arange(plan["n_mult"]) == j)
                ainv = jnp.sum(jnp.where(sel, plan["ainv_tab"][slot], 0))
                row = slot_w.reshape(nb, m).sum(axis=1)           # perm space
                rowp = jnp.zeros(lpad * lpad, h.dtype).at[:nb].set(row)
                inv = (ainv * (jnp.arange(nb) - s)) % nb
                contrib = two_level_take(rowp.reshape(lpad, lpad), inv, 1)[:, 0]
                hists[lidx] = h.at[:nb].add(contrib)
            else:
                gidx = aux
                hists[lidx] = onehot_accumulate(h, gidx, slot_w)
            return hists

        c_ = c
        used_np = None

        def run_block(params, kd_row):
            block_key = jax.random.wrap_key_data(kd_row)

            def chunk_body(carry, t):
                obs_acc, norm_acc, hists = carry
                key_t = jax.random.fold_in(block_key, t)

                # -- redraw every MC-owned slot of every leaf --
                leaf_vals = []            # per leaf [nslots, c]
                slot_prob = {}            # (lidx, slot) -> [c]
                hist_infos = []
                for lidx, li in enumerate(spec.leaves):
                    cols = []
                    for slot in range(li.ndraw):
                        k = jax.random.fold_in(key_t, 101 + lidx * 64 + slot)
                        x, p, info = draw_leaf_slot(params, k, lidx, slot)
                        cols.append(x)
                        slot_prob[(lidx, slot)] = p
                        hist_infos.append(info)
                    # offset (user-pinned) slots are prepended by spec.view
                    if cols:
                        leaf_vals.append(jnp.stack(cols, axis=0))
                    else:  # pool unused by every integrand
                        leaf_vals.append(jnp.zeros((0, c_), jnp.float32))

                # -- group slot probabilities (CompositeVar = leaf product) --
                gprob = {}                # (group, slot) -> [c]
                for g in range(spec.nvar):
                    for slot in range(spec.maxdof[g]):
                        p = None
                        for lidx in spec.group_leaves[g]:
                            q = slot_prob[(lidx, slot)]
                            p = q if p is None else p * q
                        gprob[(g, slot)] = p

                total_p = None
                for p in gprob.values():
                    total_p = p if total_p is None else total_p * p
                jac = (1.0 / total_p if total_p is not None
                       else jnp.ones((c_,), jnp.float32))

                # -- evaluate all integrands, vmapped over the sample axis --
                def _per_sample(vals):
                    return eval_fn([{"val": v} for v in vals])

                weights = jax.vmap(_per_sample, in_axes=-1, out_axes=-1)(
                    leaf_vals)                            # [n, c]

                # -- padding probabilities (variable.jl:628-657) --
                relw_rows = []
                for i in range(n):
                    factor = jac
                    if not spec.pad_trivial[i]:
                        for g in range(spec.nvar):
                            for slot in range(spec.cfg.dof[i][g],
                                              spec.maxdof[g]):
                                factor = factor * gprob[(g, slot)]
                    relw_rows.append(weights[i] * factor.astype(weights.dtype))
                relw = jnp.stack(relw_rows, axis=0)       # [n, c]

                # -- measurement gate (montecarlo.jl:148) --
                if mf > 1:
                    ne = t * c_ + jnp.arange(c_) + 1
                    mw = ((ne % mf) == 0).astype(jnp.float32)
                    relw_m = relw * mw[None, :]
                    count = jnp.sum(mw)
                else:
                    relw_m = relw
                    count = jnp.asarray(float(c_), jnp.float32)

                contrib = jax.vmap(measure_contrib, in_axes=(-1, -1),
                                   out_axes=-1)(leaf_vals, relw_m)
                obs_acc = ksum.tree_kadd(obs_acc, _tree_sum_last(contrib))
                norm_acc = ksum.kadd(norm_acc, count)

                # -- histograms: slot weight = sum_i (|w_i| jac)^2 1[used];
                # clipped so an untrained map near a singularity cannot
                # overflow the f32 accumulator (training uses only ratios) --
                wj2 = jnp.minimum(jnp.abs(weights) * jac[None, :], 1e17) ** 2
                used = np.asarray(spec.mask_used)[:n]          # static
                idx = 0
                for lidx, li in enumerate(spec.leaves):
                    for slot in range(li.ndraw):
                        mask = used[:, li.group, slot]         # [n] static
                        if mask.any():
                            sw = jnp.sum(
                                wj2 * jnp.asarray(mask, wj2.dtype)[:, None],
                                axis=0)
                            hists = hist_update(hists, hist_infos[idx], sw)
                        idx += 1
                return (obs_acc, norm_acc, hists), None

            obs0 = ksum.tree_kzeros(obs_zero)
            norm0 = ksum.kzeros(())
            hists0 = zero_hists(spec)
            (obs_acc, norm_acc, hists), _ = jax.lax.scan(
                chunk_body, (obs0, norm0, hists0), jnp.arange(self.nchunks))
            return ksum.tree_kvalue(obs_acc), norm_acc.value, hists

        def run_all(params, block_keys):
            # per-block histograms; run() adds the blocks on the host in a
            # fixed order, so the sum does not depend on the mesh size
            return jax.vmap(run_block, in_axes=(None, 0))(params, block_keys)

        if pallas_run_all is not None:
            run_all = pallas_run_all

        if mesh is not None and np.prod(
                [mesh.shape[a] for a in mesh.axis_names]) > 1:
            axis = mesh.axis_names[0]

            def sharded(params, block_keys):
                return jax.shard_map(
                    run_all, mesh=mesh,
                    in_specs=(P(), P(axis)),
                    out_specs=(P(axis), P(axis), P(axis)),
                    check_vma=False,
                )(params, block_keys)

            self.raw_fn = sharded
            self._fn = jax.jit(sharded)
        else:
            self.raw_fn = run_all
            self._fn = jax.jit(run_all)

    def _build_kernel(self, integrand, eval_fn, measure, inplace,
                      measurefreq, weight_dtype, nevalperblock, force):
        """The fused kernel's run_all if the platform and spec allow it;
        otherwise None, with ``backend_reason`` saying why."""
        from ..ops import pallas_vegas

        spec, mesh, plans, block = self.spec, self.mesh, self.plans, self.block
        interp = kernel_platform(mesh) != "gpu"
        why: list = []
        if interp and not force:
            self.backend_reason = no_gpu_reason(mesh)
            return None
        if not pallas_vegas.eligible(spec, plans, measure=measure,
                                     measurefreq=measurefreq,
                                     weight_dtype=weight_dtype, why=why):
            self.backend_reason = why[0]
            return None
        eval_b = pallas_vegas.make_eval_batched(spec, integrand, inplace,
                                                weight_dtype)
        if not pallas_vegas.validate_batched(spec, eval_b, eval_fn):
            self.backend_reason = (
                "the batched-integrand probe did not reproduce the "
                "per-sample evaluation (integrand not batch-rewritable)")
            return None
        nb0 = next(p["nb"] for li, p in zip(spec.leaves, plans)
                   if li.ndraw > 0)
        # the layout follows the global block count, so each block is
        # computed the same way on any mesh size
        m, g, nprog = pallas_vegas.chunk_layout(nb0, nevalperblock, block)
        run_k = pallas_vegas.build_run_all(
            spec, plans, eval_b, m=m, chunks_per_program=g, programs=nprog,
            interpret=interp)
        # an integrand op the Triton route cannot express fails here, at
        # build time, instead of mid-run
        if not interp:
            self.backend_reason = lower_or_reason(
                run_k, spec.device_params(),
                np.zeros((block // mesh_size(mesh), 2), np.uint32))
            if self.backend_reason:
                return None
        self.chunk = nb0 * m
        self.nchunks = g * nprog
        self.nevalperblock = self.chunk * self.nchunks
        self.backend = "pallas"
        return run_k

    def reset_state(self):
        """Kernel-cache hook (main._KERNEL_CACHE): no run-to-run state."""
        return None

    def run(self, params, key):
        """Execute one iteration; returns host-side numpy statistics."""
        kd = np.asarray(jax.random.key_data(jax.random.split(key, self.block)))
        kd = distribute_rows(self.mesh, kd)
        obs_b, norm_b, hists = fetch_stats(self._fn(params, kd))
        obs_b = jax.tree_util.tree_map(gather_rows, obs_b)
        norm_b = gather_rows(norm_b).astype(np.float64)
        hists = [np.asarray(gather_rows(h), dtype=np.float64)
                 .sum(axis=0)[: li.nhist]
                 for h, li in zip(hists, self.spec.leaves)]
        neval = self.block * self.nevalperblock
        return {
            "obs_blocks": obs_b,      # pytree with leading [block] axis
            "norm_blocks": norm_b,    # [block] measured-sample counts
            "hists": hists,           # per-leaf histogram sums
            "neval": neval,
        }
