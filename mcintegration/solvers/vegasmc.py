"""The :vegasmc solver — hybrid Vegas + Markov-chain over vectorized walkers.

Reference semantics (src/vegas_mc/montecarlo.jl:112-241, updates.jl:45-106):
one walker samples the joint distribution

    p(x) = r_norm * pad_norm(x) + sum_i |w_i(x)| * r_i * pad_i(x)

with a single update type ``changeVariable``: shift one random slot of one
random variable type through the learned map, re-evaluate ALL integrand
weights, and Metropolis-accept with R = prop * p_new / p_old.  Measurements
after a 1% warmup accumulate ``obs[i] += w_i * pad_i / p`` and
``normalization += pad_norm / p``; visited tallies drive reweighting; the
per-slot histogram weight is ``(|w_i|^2 / prob_i) * pad_i / p``.

Design: W independent walkers advance in lockstep inside one
``lax.scan`` of vmapped transitions; walkers are grouped into ``block``
lanes for the reference's block error bars, and the walker axis is sharded
over the device mesh.  Each walker picks its own variable type and slot
(masked proposals across var types), so the kernel is bit-for-bit the
reference chain law, just W chains wide.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..common import TINY_F32
from ..ops import ksum
from ..ops.grid import uniform_open01
from ..parallel.mesh import distribute_rows, gather_rows, ordered_psum
from .engine import (
    Spec,
    accumulate_hists,
    fetch_stats,
    gather_slot,
    kernel_platform,
    lower_or_reason,
    no_gpu_reason,
    scatter_slot,
    take_rows,
    zero_hists,
)


def choose_walkers(neval: int, block: int, nwalkers, min_steps: int,
                   max_walkers: int = 65536):
    """Pick (W, nsteps) with W a multiple of block and W*nsteps ≈ neval."""
    if nwalkers is None:
        w = max(block, min(int(neval) // max(min_steps, 1), max_walkers))
    else:
        w = max(int(nwalkers), block)
    w = (w // block) * block
    nsteps = max(int(neval) // w, 8)
    return w, nsteps


class VegasMCIteration:
    """One compiled per-iteration kernel for the :vegasmc solver."""

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000,
                 mesh=None, weight_dtype=jnp.float32, obs_proto=None,
                 nwalkers=None, min_steps_per_walker=256, backend="auto",
                 warmup=0.01):
        self.spec = spec
        self.block = block
        self.mesh = mesh
        from ..models.variable import FermiK
        for li in spec.leaves:
            if isinstance(li.leaf, FermiK) and li.ndraw > 0:
                raise NotImplementedError(
                    "FermiK pools are supported by the :mcmc solver only "
                    "(reference capability boundary, test/bubble_FermiK.jl:2)")
        ndev = 1
        if mesh is not None:
            ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        assert block % ndev == 0, f"block={block} must divide over {ndev} devices"
        neval = nevalperblock * block
        Wg, nsteps = choose_walkers(neval, block * ndev, nwalkers,
                                    min_steps_per_walker)
        # all shapes below are per-device (shard_map-local)
        W = Wg // ndev
        block = block // ndev
        self.nwalkers = Wg
        self.nsteps = nsteps
        self.neval = Wg * nsteps
        # burn-in discard: measure only after `warmup` fraction of each
        # walker's chain (reference: fixed 1%, montecarlo.jl:213).  Larger
        # values pay for unbiasedness when the proposal map is badly
        # mismatched (frozen-map robustness regime, important_sampling.md).
        assert 0.0 <= warmup < 1.0, f"warmup fraction must be in [0,1), got {warmup}"
        self.warmup = float(warmup)

        # ---- fused Triton chain kernel (ops/pallas_chain.py) on a CUDA
        # GPU; the XLA scan below serves every other spec and platform ----
        self.backend = "xla"
        self.backend_reason = ("backend='xla' requested" if backend == "xla"
                               else "")
        if backend != "xla" and self._try_build_kernel(
                integrand, measure, inplace, measurefreq, weight_dtype,
                neval, block, ndev, nwalkers, min_steps_per_walker,
                force=backend == "pallas"):
            return
        n = spec.N
        nd = n + 1
        nvar = spec.nvar
        norm = spec.norm
        wb = W // block
        mf = measurefreq
        # measure once ne >= warmup*neval (reference fixes 1%, montecarlo.jl:213)
        warmup = int(nsteps * self.warmup)

        eval_fn = spec.make_eval(integrand, inplace, weight_dtype)
        # var types the chain may update (maxdof > 0), static
        eligible = [g for g in range(nvar) if spec.maxdof[g] > 0]
        maxdof_arr = jnp.asarray([max(spec.maxdof[g], 1) for g in range(nvar)],
                                 jnp.float32)

        if measure is None:
            obs_zero = np.zeros((n,), weight_dtype)
            def measure_contrib(pools, relw):
                return relw
        else:
            obs_zero = jax.tree_util.tree_map(
                lambda x: np.zeros(np.shape(x), weight_dtype), obs_proto)
            uc = spec.uconfig
            def measure_contrib(pools, relw):
                return measure(spec.view(pools), relw, uc)

        def joint_probability(params, weights, pad):
            """p = r_norm*pad_norm + sum_i |w_i|*r_i*pad_i (montecarlo.jl:161-166)."""
            r = params["reweight"]
            p = r[norm] * pad[:, norm]
            p = p + jnp.sum(jnp.abs(weights) * r[None, :n] * pad[:, :n], axis=-1)
            return p

        def paddings(slotp):
            return jnp.stack(
                [spec.padding_probability(slotp, i) for i in range(nd)], axis=-1)

        def propose_shift(params, key, pools, vi):
            """Per-walker changeVariable proposal across all var types.

            Returns (new_pools, prop [W]).  Each group's shift is computed for
            every walker; the per-walker ``vi`` mask selects which group's
            proposal actually lands (identity elsewhere).
            """
            u_slot = uniform_open01(jax.random.fold_in(key, 1), (W,))
            new_pools = [dict(p) for p in pools]
            prop = jnp.ones((W,), jnp.float32)
            for g in eligible:
                idx_g = jnp.minimum(
                    (u_slot * maxdof_arr[g]).astype(jnp.int32), spec.maxdof[g] - 1)
                sel = (vi == g)
                prop_g = jnp.ones((W,), jnp.float32)
                for lidx in spec.group_leaves[g]:
                    li = spec.leaves[lidx]
                    pool = pools[lidx]
                    ov = gather_slot(pool["val"], idx_g)
                    og = gather_slot(pool["gidx"], idx_g)
                    op = gather_slot(pool["prob"], idx_g)
                    k = jax.random.fold_in(key, 100 + lidx)
                    nv, ng, npb, prop_l = li.leaf.dev_shift(
                        params["leaf"][lidx], k, ov, og, op)
                    prop_g = prop_g * prop_l
                    selx = sel
                    new_pools[lidx] = {
                        "val": scatter_slot(new_pools[lidx]["val"], idx_g,
                                            jnp.where(_bsel(selx, nv), nv, ov)),
                        "gidx": scatter_slot(new_pools[lidx]["gidx"], idx_g,
                                             jnp.where(selx, ng, og)),
                        "prob": scatter_slot(new_pools[lidx]["prob"], idx_g,
                                             jnp.where(selx, npb, op)),
                    }
                prop = jnp.where(sel, prop_g, prop)
            return new_pools, prop

        def step(carry, t):
            (pools, weights, pad, p, obs_acc, norm_acc, visited_acc, hists,
             prop_cnt, acc_cnt, base_key) = carry
            key = jax.random.fold_in(base_key, t)

            # -- changeVariable (updates.jl:45-106) --
            u_vi = uniform_open01(jax.random.fold_in(key, 0), (W,))
            vi_pick = jnp.minimum((u_vi * len(eligible)).astype(jnp.int32),
                                  len(eligible) - 1)
            vi = take_rows(jnp.asarray(eligible, jnp.int32), vi_pick)

            prop_pools, prop = propose_shift(params_ref[0], key, pools, vi)
            new_weights = jax.vmap(eval_fn)(prop_pools)
            new_slotp = spec.slot_probs(prop_pools)
            new_pad = paddings(new_slotp)
            new_p = joint_probability(params_ref[0], new_weights, new_pad)

            r_ratio = prop * new_p / p
            u_acc = uniform_open01(jax.random.fold_in(key, 2), (W,))
            accept = (u_acc < r_ratio) & (prop > TINY_F32)

            pools = [
                {k2: jnp.where(_b(accept, npv[k2]), npv[k2], opv[k2])
                 for k2 in opv}
                for opv, npv in zip(pools, prop_pools)
            ]
            weights = jnp.where(accept[:, None], new_weights, weights)
            pad = jnp.where(accept[:, None], new_pad, pad)
            p = jnp.where(accept, new_p, p)

            # proposal / acceptance tallies per var type (updates.jl:90-92)
            vi_onehot = (vi[:, None] == jnp.arange(nvar)[None, :]).astype(jnp.float32)
            prop_cnt = prop_cnt + jnp.sum(vi_onehot, axis=0)
            acc_cnt = acc_cnt + jnp.sum(vi_onehot * accept[:, None].astype(jnp.float32), axis=0)

            # -- per-step histogram accumulation (montecarlo.jl:198-211) --
            slotp = spec.slot_probs(pools)
            prob_i = jnp.stack([spec.probability(slotp, i) for i in range(n)],
                               axis=-1)                                  # [W,n]
            wf2 = jnp.minimum(
                (jnp.abs(weights) ** 2 / prob_i) * pad[:, :n] / p[:, None],
                1e34)
            mask = spec.mask_used[:n].astype(wf2.dtype)
            # HIGHEST: a TF32 contraction would round the weights that
            # train the map to ~3 digits on the GPU
            slot_w = jnp.einsum("wn,nvm->wvm", wf2, mask,
                                precision=jax.lax.Precision.HIGHEST)
            hists = accumulate_hists(spec, hists, pools, slot_w)

            # -- measurement (montecarlo.jl:213-232) --
            measured = ((t % mf) == 0) & (t >= warmup)
            mw = measured.astype(jnp.float32)
            r = params_ref[0]["reweight"]
            relw = weights * (pad[:, :n] / p[:, None]).astype(weights.dtype)
            contrib = jax.vmap(measure_contrib)(pools, relw)
            contrib_b = jax.tree_util.tree_map(
                lambda x: (x * mw).reshape((block, wb) + x.shape[1:]).sum(axis=1),
                contrib)
            obs_acc = ksum.tree_kadd(obs_acc, contrib_b)

            norm_w = pad[:, norm] / p
            norm_acc = ksum.kadd(
                norm_acc, (norm_w * mw).reshape(block, wb).sum(axis=1))

            vis_user = jnp.sum(
                jnp.abs(weights * pad[:, :n] * r[None, :n]) / p[:, None] * mw,
                axis=0)
            vis_norm = jnp.sum(r[norm] * norm_w * mw)[None]
            visited_acc = ksum.kadd(visited_acc,
                                    jnp.concatenate([vis_user, vis_norm]))

            return (pools, weights, pad, p, obs_acc, norm_acc, visited_acc,
                    hists, prop_cnt, acc_cnt, base_key), None

        params_ref = [None]  # closed-over mutable cell, set per trace below

        def run_all(params, key):
            params_ref[0] = params
            init_key = jax.random.fold_in(key, 0)
            pools = spec.draw_all(params, init_key, (W,))
            weights = jax.vmap(eval_fn)(pools)
            slotp = spec.slot_probs(pools)
            pad = paddings(slotp)
            p = joint_probability(params, weights, pad)

            carry = (
                pools, weights, pad, p,
                ksum.tree_kzeros(jax.tree_util.tree_map(
                    lambda x: jnp.zeros((block,) + x.shape, x.dtype), obs_zero)),
                ksum.kzeros((block,)),
                ksum.kzeros((nd,)),
                zero_hists(spec),
                jnp.zeros((nvar,), jnp.float32),
                jnp.zeros((nvar,), jnp.float32),
                jax.random.fold_in(key, 1),
            )
            carry, _ = jax.lax.scan(step, carry, jnp.arange(self.nsteps))
            (_, _, _, _, obs_acc, norm_acc, visited_acc, hists,
             prop_cnt, acc_cnt, _) = carry
            return (ksum.tree_kvalue(obs_acc), norm_acc.value,
                    visited_acc.value, hists, prop_cnt, acc_cnt)

        if mesh is not None and np.prod([mesh.shape[a] for a in mesh.axis_names]) > 1:
            axis = mesh.axis_names[0]

            def sharded(params, kd):
                def local(params, kd):
                    key0 = jax.random.wrap_key_data(kd[0])
                    obs_b, norm_b, visited, hists, pc, ac = run_all(params, key0)
                    visited = ordered_psum(visited, axis)
                    hists = [ordered_psum(h, axis) for h in hists]
                    pc = ordered_psum(pc, axis)
                    ac = ordered_psum(ac, axis)
                    return obs_b, norm_b, visited, hists, pc, ac

                return jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(P(), P(axis)),
                    out_specs=(P(axis), P(axis), P(), P(), P(), P()),
                    check_vma=False,
                )(params, kd)

            self.raw_fn = sharded
            self._fn = jax.jit(sharded)
            self._ndev = ndev
        else:
            self.raw_fn = lambda params, kd: run_all(
                params, jax.random.wrap_key_data(kd[0]))
            self._fn = jax.jit(self.raw_fn)
            self._ndev = 1

    def _try_build_kernel(self, integrand, measure, inplace, measurefreq,
                          weight_dtype, neval, block, ndev, nwalkers,
                          min_steps, force) -> bool:
        """Build the fused chain kernel if the platform and spec allow it;
        otherwise leave ``backend_reason`` saying why and return False."""
        from ..ops import pallas_chain, pallas_vegas

        spec, mesh = self.spec, self.mesh
        interp = kernel_platform(mesh) != "gpu"
        why: list = []
        if interp and not force:
            self.backend_reason = no_gpu_reason(mesh)
            return False
        if not pallas_chain.chain_eligible(spec, measure=measure,
                                           weight_dtype=weight_dtype, why=why):
            self.backend_reason = why[0]
            return False
        nprog, nsteps = pallas_chain.chain_walkers(
            neval // ndev, block, None if nwalkers is None
            else int(nwalkers) // ndev, min_steps)
        eval_b = pallas_vegas.make_eval_batched(spec, integrand, inplace,
                                                weight_dtype)
        if not pallas_vegas.validate_batched(
                spec, eval_b, spec.make_eval(integrand, inplace,
                                             weight_dtype)):
            self.backend_reason = (
                "the batched-integrand probe did not reproduce the "
                "per-sample evaluation (integrand not batch-rewritable)")
            return False
        run_k = pallas_chain.build_chain_run_all(
            spec, eval_b, programs=nprog, nsteps=nsteps, mf=measurefreq,
            warmup=int(nsteps * self.warmup), interpret=interp)
        # an integrand op the Triton route cannot express fails here, at
        # build time, instead of mid-run
        if not interp:
            self.backend_reason = lower_or_reason(
                run_k, spec.device_params(), np.zeros((block, 2), np.uint32))
            if self.backend_reason:
                return False
        self.nwalkers = block * nprog * pallas_chain.WALKERS * ndev
        self.nsteps = nsteps
        self.neval = self.nwalkers * nsteps
        self.backend = "pallas"
        self.backend_reason = ""
        self._ndev = ndev
        if ndev > 1:
            axis = mesh.axis_names[0]

            def sharded(params, kd):
                def local(params, kd):
                    o, nb, vis, hists, pc, ac = run_k(params, kd)
                    return (o, nb, ordered_psum(vis, axis),
                            [ordered_psum(h, axis) for h in hists],
                            ordered_psum(pc, axis), ordered_psum(ac, axis))

                return jax.shard_map(
                    local, mesh=mesh, in_specs=(P(), P(axis)),
                    out_specs=(P(axis), P(axis), P(), P(), P(), P()),
                    check_vma=False)(params, kd)

            self.raw_fn = sharded
        else:
            self.raw_fn = run_k
        self._fn = jax.jit(self.raw_fn)
        return True

    def reset_state(self):
        """Kernel-cache hook (main._KERNEL_CACHE): no run-to-run state."""
        return None

    def run(self, params, key):
        # the kernel takes one key per block, the XLA scan one per device
        nrows = self.block if self.backend == "pallas" else self._ndev
        kd = np.asarray(jax.random.key_data(jax.random.split(key, nrows)))
        keys = distribute_rows(self.mesh if self._ndev > 1 else None, kd)
        obs_b, norm_b, visited, hists, prop_cnt, acc_cnt = fetch_stats(
            self._fn(params, keys))
        obs_b = jax.tree_util.tree_map(gather_rows, obs_b)
        norm_b = gather_rows(norm_b).astype(np.float64)
        spec = self.spec
        nd = spec.N + 1
        nvar = spec.nvar
        propose = np.zeros((3, nd, max(nd, nvar)))
        accept = np.zeros((3, nd, max(nd, nvar)))
        propose[1, 0, :nvar] = np.asarray(prop_cnt, dtype=np.float64)
        accept[1, 0, :nvar] = np.asarray(acc_cnt, dtype=np.float64)
        return {
            "obs_blocks": obs_b,
            "norm_blocks": norm_b,
            "visited": np.asarray(visited, dtype=np.float64),
            "hists": [np.asarray(h, dtype=np.float64)[: li.nhist]
                      for h, li in zip(hists, self.spec.leaves)],
            "propose": propose,
            "accept": accept,
            "neval": self.neval,
        }


def _b(mask, ref):
    """Broadcast a [W] bool mask against a pool array [W, ...]."""
    return mask.reshape(mask.shape + (1,) * (ref.ndim - 1))


def _bsel(mask, ref):
    """Broadcast a [W] bool mask against a slot value [W(, D)]."""
    return mask.reshape(mask.shape + (1,) * (ref.ndim - 1))
