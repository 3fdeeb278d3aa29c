"""The :mcmc solver — Metropolis over the extended (integrand index, vars) space.

Reference semantics (src/mcmc/montecarlo.jl:72-184, updates.jl):
per-walker state is (curr, weight, probability = |weight|*reweight[curr]);
the update set is {changeIntegrand, swapVariable, changeVariable x 2*nvar}
(montecarlo.jl:117-120); only the CURRENT integrand is evaluated per step;
changeIntegrand jumps along the neighbor graph, creating/removing the
dof-difference variables with proposal prod(create)/prod(remove) and the
neighbor-count ratio; measurements past burn-in accumulate
``normalization += 1/reweight[norm]`` in the normalization sector and
``obs[curr] += weight/probability`` otherwise; histograms count visits.

Design: W walkers advance in one ``lax.scan``.  The update KIND is chosen
per step from the chain key with the reference's selection probabilities
(1, 1, 2*nvar)/(2*nvar+2) and dispatched through ``lax.cond``-free masking: a
per-step scalar selects one branch via ``lax.switch`` so only that update's
integrand evaluations run (kernel selection independent of chain state is a
valid MCMC composition; the reference draws the kernel per step from the same
distribution).  Per-walker integrand dispatch (walkers sit in different
integrands) uses ``lax.switch`` under ``vmap``, which evaluates all N
integrands and selects — the documented cost of per-walker heterogeneity
(SURVEY.md §7.3); fine for small integrand bundles, use :vegasmc for wide
ones with shared variables.

Like the reference, rejected changeIntegrand moves keep the freshly created
slot values (createRollback! is a no-op, sampler.jl:306): slots beyond the
current dof never influence the chain law.
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
from .engine import (Spec, accumulate_hists, fetch_stats, gather_slot,
                     scatter_slot, take_rows, zero_hists)
from .vegasmc import choose_walkers

# tally contractions must not round through TF32 on the GPU
_EXACT = jax.lax.Precision.HIGHEST


class MCMCIteration:
    """One compiled per-iteration kernel for the :mcmc solver."""

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None,
                 measurefreq=1, block=16, nevalperblock=10000,
                 mesh=None, weight_dtype=jnp.float32, obs_proto=None,
                 thermal_ratio=0.1, nwalkers=None, min_steps_per_walker=256,
                 backend="auto"):
        self.spec = spec
        self.block = block
        self.mesh = mesh
        ndev = 1
        if mesh is not None:
            ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        assert block % ndev == 0
        neval = nevalperblock * block
        Wg, nsteps = choose_walkers(neval, block * ndev, nwalkers,
                                    min_steps_per_walker)
        W = Wg // ndev            # per-device walkers
        block = block // ndev     # per-device block lanes
        self.nwalkers = Wg
        self.nsteps = nsteps
        nburnin = int(np.floor(nsteps * thermal_ratio))
        self.nburnin = nburnin
        self.neval = Wg * (nsteps + nburnin)

        self.backend = "xla"
        self.backend_reason = ("backend='xla' requested" if backend == "xla"
                               else ":mcmc has no fused kernel")
        n = spec.N
        nd = n + 1
        nvar = spec.nvar
        norm = spec.norm
        wb = W // block
        mf = measurefreq
        ncol = max(nd, nvar)

        uc = spec.uconfig
        dof_tab = jnp.asarray(spec.dof_np)                      # [nd, nvar]
        # padded neighbor table (configuration.jl:201-227 adjacency)
        max_deg = max(len(a) for a in spec.cfg.neighbor)
        nb_tab = np.zeros((nd, max_deg), dtype=np.int32)
        nb_deg = np.zeros((nd,), dtype=np.int32)
        for i, adj in enumerate(spec.cfg.neighbor):
            nb_deg[i] = len(adj)
            nb_tab[i, : len(adj)] = adj
        nb_tab = jnp.asarray(nb_tab)
        nb_deg = jnp.asarray(nb_deg)

        # per-integrand weight evaluation: integrand(idx, var, config)
        def eval_idx(pools_one, idx):
            branches = [
                (lambda i: lambda p: jnp.asarray(integrand(i, spec.view(p), uc),
                                                 weight_dtype))(i)
                for i in range(n)
            ] + [lambda p: jnp.zeros((), weight_dtype)]  # norm sector
            return jax.lax.switch(idx, branches, pools_one)

        def eval_all(pools, idx):
            return jax.vmap(eval_idx)(pools, idx)

        if measure is None:
            obs_zero = np.zeros((n,), weight_dtype)

            def measure_contrib(pools_one, idx, relw):
                onehot = (jnp.arange(n) == idx).astype(weight_dtype)
                return onehot * relw
        else:
            obs_zero = jax.tree_util.tree_map(
                lambda x: np.zeros(np.shape(x), weight_dtype), obs_proto)

            def measure_contrib(pools_one, idx, relw):
                branches = [
                    (lambda i: lambda args: jax.tree_util.tree_map(
                        lambda z: jnp.asarray(z, weight_dtype),
                        measure(i, spec.view(args[0]), args[1], uc)))(i)
                    for i in range(n)
                ] + [lambda args: jax.tree_util.tree_map(
                    lambda z: jnp.zeros(np.shape(z), weight_dtype), obs_proto)]
                return jax.lax.switch(idx, branches, (pools_one, relw))

        eligible = [g for g in range(nvar) if spec.maxdof[g] > 0]

        # ---------------- update kernels --------------------------------
        def upd_change_integrand(key, state):
            """updates.jl:1-70 vectorized over walkers."""
            pools, curr, weight, prob = state
            u = uniform_open01(jax.random.fold_in(key, 0), (W, 2))
            deg_c = take_rows(nb_deg, curr)
            pick = jnp.minimum((u[:, 0] * deg_c).astype(jnp.int32), deg_c - 1)
            rows = take_rows(nb_tab, curr)                 # [W, max_deg]
            new = gather_slot(rows, pick)
            currdof = take_rows(dof_tab, curr)             # [W, nvar]
            newdof = take_rows(dof_tab, new)
            prop = deg_c.astype(jnp.float32) / take_rows(nb_deg, new).astype(jnp.float32)

            new_pools = [dict(p) for p in pools]
            for g in range(nvar):
                mm = spec.maxdof[g]
                if mm == 0:
                    continue
                pos = jnp.arange(mm)[None, :]
                created = (pos >= currdof[:, g:g + 1]) & (pos < newdof[:, g:g + 1])
                removed = (pos >= newdof[:, g:g + 1]) & (pos < currdof[:, g:g + 1])
                for lidx in spec.group_leaves[g]:
                    li = spec.leaves[lidx]
                    pool = new_pools[lidx]
                    k = jax.random.fold_in(key, 100 + lidx)
                    nv, ng, npb, = li.leaf.dev_draw(
                        params_ref[0]["leaf"][lidx], k, (W, mm))
                    old_dens = li.leaf.dev_density(
                        params_ref[0]["leaf"][lidx], pool["val"], pool["gidx"])
                    # prop *= prod(create)  * prod(remove)   (updates.jl:15-26)
                    prop = prop * jnp.prod(
                        jnp.where(created, 1.0 / jnp.maximum(npb, TINY_F32), 1.0), axis=1)
                    prop = prop * jnp.where(
                        jnp.any(created & (npb <= 0.0), axis=1), 0.0, 1.0)
                    prop = prop * jnp.prod(
                        jnp.where(removed, old_dens, 1.0), axis=1)
                    cm = created
                    if nv.ndim == 3:
                        cm = created[..., None]
                    new_pools[lidx] = {
                        "val": jnp.where(cm, nv, pool["val"]),
                        "gidx": jnp.where(created, ng, pool["gidx"]),
                        "prob": jnp.where(created, npb, pool["prob"]),
                    }

            new_weight = eval_all(new_pools, new)
            new_prob = jnp.where(
                new == norm,
                params_ref[0]["reweight"][norm],
                jnp.abs(new_weight) * take_rows(params_ref[0]["reweight"], new))
            ratio = prop * new_prob / jnp.maximum(prob, TINY_F32)
            u_acc = uniform_open01(jax.random.fold_in(key, 1), (W,))
            acc = (u_acc < ratio) & (prop > TINY_F32)

            # created slots keep their fresh values even on reject (see module
            # docstring); curr/weight/probability commit on accept only.
            curr2 = jnp.where(acc, new, curr)
            weight2 = jnp.where(acc, new_weight, weight)
            prob2 = jnp.where(acc, new_prob, prob)
            # tallies propose/accept[0, curr, new] (updates.jl:48-50)
            oh_c = jax.nn.one_hot(curr, nd, dtype=jnp.float32)
            oh_n = jax.nn.one_hot(new, ncol, dtype=jnp.float32)
            t_prop = jnp.einsum("wi,wj->ij", oh_c, oh_n, precision=_EXACT)
            t_acc = jnp.einsum("wi,wj->ij", oh_c * acc[:, None].astype(jnp.float32),
                               oh_n, precision=_EXACT)
            return (new_pools, curr2, weight2, prob2), (t_prop, t_acc)

        def upd_change_variable(key, state):
            """updates.jl:72-109 vectorized over walkers."""
            pools, curr, weight, prob = state
            u = uniform_open01(jax.random.fold_in(key, 0), (W, 2))
            vi = jnp.minimum((u[:, 0] * nvar).astype(jnp.int32), nvar - 1)
            currdof = take_rows(dof_tab, curr)
            dof_vi = gather_slot(currdof, vi)
            active = (curr != norm) & (dof_vi > 0)

            new_pools = [dict(p) for p in pools]
            prop = jnp.ones((W,), jnp.float32)
            for g in eligible:
                idx_g = jnp.minimum((u[:, 1] * dof_vi.astype(jnp.float32))
                                    .astype(jnp.int32), spec.maxdof[g] - 1)
                sel = active & (vi == g)
                for lidx in spec.group_leaves[g]:
                    li = spec.leaves[lidx]
                    pool = pools[lidx]
                    ov = gather_slot(pool["val"], idx_g)
                    og = gather_slot(pool["gidx"], idx_g)
                    op = gather_slot(pool["prob"], idx_g)
                    k = jax.random.fold_in(key, 100 + lidx)
                    nv, ng, npb, prop_l = li.leaf.dev_shift(
                        params_ref[0]["leaf"][lidx], k, ov, og, op)
                    prop = jnp.where(sel, prop * prop_l, prop)
                    selv = sel.reshape(sel.shape + (1,) * (nv.ndim - 1))
                    new_pools[lidx] = {
                        "val": scatter_slot(new_pools[lidx]["val"], idx_g,
                                            jnp.where(selv, nv, ov)),
                        "gidx": scatter_slot(new_pools[lidx]["gidx"], idx_g,
                                             jnp.where(sel, ng, og)),
                        "prob": scatter_slot(new_pools[lidx]["prob"], idx_g,
                                             jnp.where(sel, npb, op)),
                    }

            new_weight = eval_all(new_pools, curr)
            new_prob = jnp.abs(new_weight) * take_rows(params_ref[0]["reweight"], curr)
            ratio = prop * new_prob / jnp.maximum(prob, TINY_F32)
            u_acc = uniform_open01(jax.random.fold_in(key, 1), (W,))
            acc = active & (u_acc < ratio) & (prop > TINY_F32)

            pools2 = [
                {k2: jnp.where(_bmask(acc, npv[k2]), npv[k2], opv[k2]) for k2 in opv}
                for opv, npv in zip(pools, new_pools)
            ]
            weight2 = jnp.where(acc, new_weight, weight)
            prob2 = jnp.where(acc, new_prob, prob)
            af = acc.astype(jnp.float32)
            oh_c = jax.nn.one_hot(curr, nd, dtype=jnp.float32) * active[:, None].astype(jnp.float32)
            oh_v = jax.nn.one_hot(vi, ncol, dtype=jnp.float32)
            t_prop = jnp.einsum("wi,wj->ij", oh_c, oh_v, precision=_EXACT)
            t_acc = jnp.einsum("wi,wj->ij", oh_c * af[:, None], oh_v,
                               precision=_EXACT)
            return (pools2, curr, weight2, prob2), (t_prop, t_acc)

        def upd_swap_variable(key, state):
            """updates.jl:111-147 vectorized over walkers."""
            pools, curr, weight, prob = state
            u = uniform_open01(jax.random.fold_in(key, 0), (W, 3))
            vi = jnp.minimum((u[:, 0] * nvar).astype(jnp.int32), nvar - 1)
            currdof = take_rows(dof_tab, curr)
            dof_vi = gather_slot(currdof, vi)
            active = (curr != norm) & (dof_vi > 0)

            new_pools = [dict(p) for p in pools]
            for g in eligible:
                dv = dof_vi.astype(jnp.float32)
                idx1 = jnp.minimum((u[:, 1] * dv).astype(jnp.int32), spec.maxdof[g] - 1)
                idx2 = jnp.minimum((u[:, 2] * dv).astype(jnp.int32), spec.maxdof[g] - 1)
                sel = active & (vi == g) & (idx1 != idx2)
                for lidx in spec.group_leaves[g]:
                    pool = new_pools[lidx]
                    upd = {}
                    for k2 in ("val", "gidx", "prob"):
                        a = pool[k2]
                        v1 = gather_slot(a, idx1)
                        v2 = gather_slot(a, idx2)
                        selv = sel.reshape(sel.shape + (1,) * (v1.ndim - 1))
                        a = scatter_slot(a, idx1, jnp.where(selv, v2, v1))
                        a = scatter_slot(a, idx2, jnp.where(selv, v1, v2))
                        upd[k2] = a
                    new_pools[lidx] = upd

            new_weight = eval_all(new_pools, curr)
            new_prob = jnp.abs(new_weight) * take_rows(params_ref[0]["reweight"], curr)
            ratio = new_prob / jnp.maximum(prob, TINY_F32)
            u_acc = uniform_open01(jax.random.fold_in(key, 1), (W,))
            acc = active & (u_acc < ratio)

            pools2 = [
                {k2: jnp.where(_bmask(acc, npv[k2]), npv[k2], opv[k2]) for k2 in opv}
                for opv, npv in zip(pools, new_pools)
            ]
            weight2 = jnp.where(acc, new_weight, weight)
            prob2 = jnp.where(acc, new_prob, prob)
            af = acc.astype(jnp.float32)
            oh_c = jax.nn.one_hot(curr, nd, dtype=jnp.float32) * active[:, None].astype(jnp.float32)
            oh_v = jax.nn.one_hot(vi, ncol, dtype=jnp.float32)
            t_prop = jnp.einsum("wi,wj->ij", oh_c, oh_v, precision=_EXACT)
            t_acc = jnp.einsum("wi,wj->ij", oh_c * af[:, None], oh_v,
                               precision=_EXACT)
            return (pools2, curr, weight2, prob2), (t_prop, t_acc)

        # update-kind probabilities: [CI, swap, CV] = (1, 1, 2*nvar)/(2*nvar+2)
        # (montecarlo.jl:117-120)
        l_tot = 2 * nvar + 2
        p_ci, p_sw = 1.0 / l_tot, 1.0 / l_tot

        def step(carry, t):
            (pools, curr, weight, prob, obs_acc, norm_acc, visited_acc, hists,
             prop_acc, acc_acc, base_key) = carry
            key = jax.random.fold_in(base_key, t)

            # visited tally every step, incl. burn-in (montecarlo.jl:137)
            visited_acc = ksum.kadd(
                visited_acc,
                jnp.sum(jax.nn.one_hot(curr, nd, dtype=jnp.float32), axis=0))

            u_kind = uniform_open01(jax.random.fold_in(key, 9), ())
            kind = jnp.where(u_kind < p_ci, 0,
                             jnp.where(u_kind < p_ci + p_sw, 1, 2))
            state = (pools, curr, weight, prob)
            (pools, curr, weight, prob), (t_prop, t_acc) = jax.lax.switch(
                kind,
                [lambda s, k=key: upd_change_integrand(k, s),
                 lambda s, k=key: upd_swap_variable(k, s),
                 lambda s, k=key: upd_change_variable(k, s)],
                state)
            kind_row = jax.nn.one_hot(
                jnp.where(kind == 0, 0, jnp.where(kind == 1, 2, 1)), 3,
                dtype=jnp.float32)
            prop_acc = prop_acc + kind_row[:, None, None] * t_prop[None]
            acc_acc = acc_acc + kind_row[:, None, None] * t_acc[None]

            # -- measurement (montecarlo.jl:145-170) --
            measured = ((t % mf) == 0) & (t >= nburnin)
            mw = measured.astype(jnp.float32)

            in_norm = (curr == norm)
            ok = (~in_norm) & (prob > TINY_F32)
            relw = jnp.where(ok, weight / jnp.where(ok, prob, 1.0).astype(weight.dtype), 0)
            contrib = jax.vmap(measure_contrib)(pools, jnp.minimum(curr, n - 1), relw)
            contrib = jax.tree_util.tree_map(
                lambda x: x * _bmask(ok, x).astype(x.dtype), contrib)
            contrib_b = jax.tree_util.tree_map(
                lambda x: (x * mw).reshape((block, wb) + x.shape[1:]).sum(axis=1),
                contrib)
            obs_acc = ksum.tree_kadd(obs_acc, contrib_b)

            norm_w = jnp.where(in_norm, 1.0 / params_ref[0]["reweight"][norm], 0.0)
            norm_acc = ksum.kadd(norm_acc,
                                 (norm_w * mw).reshape(block, wb).sum(axis=1))

            # histogram: 1.0 per used slot of the current integrand
            # (montecarlo.jl:148-155)
            used_flat = jnp.asarray(spec.mask_used, jnp.float32).reshape(nd, -1)
            slot_w = take_rows(used_flat, curr).reshape(
                (W,) + spec.mask_used.shape[1:]) \
                * (mw * (~in_norm).astype(jnp.float32))[:, None, None]
            hists = accumulate_hists(spec, hists, pools, slot_w)

            return (pools, curr, weight, prob, obs_acc, norm_acc, visited_acc,
                    hists, prop_acc, acc_acc, base_key), None

        params_ref = [None]

        def run_all(params, key):
            params_ref[0] = params
            init_key = jax.random.fold_in(key, 0)
            pools = spec.draw_all(params, init_key, (W,))
            curr = jnp.zeros((W,), jnp.int32)  # start in integrand 0 (montecarlo.jl:76)
            weight = eval_all(pools, curr)
            prob = jnp.abs(weight) * params["reweight"][0]

            # masked re-init for walkers whose start weight vanished
            # (montecarlo.jl:103-113, 10 retries batched)
            def retry(i, st):
                pools, weight, prob = st
                bad = prob <= TINY_F32
                k = jax.random.fold_in(init_key, i + 1)
                fresh = spec.draw_all(params, k, (W,))
                pools = [
                    {k2: jnp.where(_bmask(bad, f[k2]), f[k2], o[k2]) for k2 in o}
                    for o, f in zip(pools, fresh)
                ]
                w2 = eval_all(pools, curr)
                weight = jnp.where(bad, w2, weight)
                prob = jnp.abs(weight) * params["reweight"][0]
                return pools, weight, prob

            pools, weight, prob = jax.lax.fori_loop(
                0, 10, retry, (pools, weight, prob))

            carry = (
                pools, curr, weight, prob,
                ksum.tree_kzeros(jax.tree_util.tree_map(
                    lambda x: jnp.zeros((block,) + x.shape, x.dtype), obs_zero)),
                ksum.kzeros((block,)),
                ksum.kzeros((nd,)),
                zero_hists(spec),
                jnp.zeros((3, nd, ncol), jnp.float32),
                jnp.zeros((3, nd, ncol), jnp.float32),
                jax.random.fold_in(key, 1),
            )
            carry, _ = jax.lax.scan(step, carry,
                                    jnp.arange(self.nsteps + nburnin))
            (_, _, _, _, obs_acc, norm_acc, visited_acc, hists,
             prop_acc, acc_acc, _) = carry
            return (ksum.tree_kvalue(obs_acc), norm_acc.value,
                    visited_acc.value, hists, prop_acc, acc_acc)

        if ndev > 1:
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

    def reset_state(self):
        """Kernel-cache hook (main._KERNEL_CACHE): no run-to-run state."""
        return None

    def run(self, params, key):
        spec = self.spec
        nd = spec.N + 1
        nvar = spec.nvar
        nmax = max(nd, nvar)
        kd = np.asarray(jax.random.key_data(
            jax.random.split(key, self._ndev)))
        keys = distribute_rows(self.mesh if self._ndev > 1 else None, kd)
        obs_b, norm_b, visited, hists, prop_acc, acc_acc = fetch_stats(
            self._fn(params, keys))
        obs_b = jax.tree_util.tree_map(gather_rows, obs_b)
        norm_b = gather_rows(norm_b).astype(np.float64)
        propose = np.asarray(prop_acc, dtype=np.float64)
        accept = np.asarray(acc_acc, dtype=np.float64)
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


def _bmask(mask, ref):
    return mask.reshape(mask.shape + (1,) * (ref.ndim - 1))
