"""Fused Markov-chain kernel for the :vegasmc solver (Pallas, Triton route).

The XLA pipeline (solvers/vegasmc.py) advances W walkers through a
``lax.scan`` of several small kernels per step, each of which reads and
writes the walker state in device memory.  Here one program owns a tile
of ``T`` walkers and runs the whole step loop inside itself: the walker
state and every accumulator stay in registers, and each program writes
its partial sums once, at the end.

Chain law is the reference's changeVariable update
(src/vegas_mc/montecarlo.jl:112-241, updates.jl:45-106), exactly as in
the XLA path: shift one random slot of one random var type through the
learned map (each walker gathers its own bin from the map table, so any
``ninc`` works), re-evaluate all weights, Metropolis-accept with
R = prop * p_new / p_old, then accumulate histogram / visited /
normalization / observable statistics every step.

Accumulators: per-walker Neumaier-compensated sums (ops/ksum.py) keep f32
rounding at O(1 ulp) of each walker's total over long chains.  Histograms
accumulate per program in an [L, L] register tile through the factored
one-hot product of ops/pallas_vegas.onehot_hist; programs write their own
partials, which XLA adds in a fixed order.  No float atomics: a fixed seed
gives the same bits on every run.

Random bits: the counter hash of ops/pallas_vegas keyed by (block key,
step, stream, walker index within the block), independent of the program
layout.

Scope (else the XLA path, with ``Result.backend_reason``): Continuous
pools, float32 weights, the default measure.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..common import TINY_F32
from . import ksum
from .pallas_vegas import (_GOLD, _mix32, _rem, _u32, add_in_order, hist_side,
                           onehot_hist, random_bits, salt_of, uniform01)

WALKERS = 64        # walkers per program, one per thread
NUM_WARPS = 2       # fastest of the tile sweep in PERF.md
MAX_WALKERS = 2 ** 18   # walkers per device the kernel path may use
MAX_NINC = 4096     # histogram side L <= 64 keeps hist2d in registers


def chain_eligible(spec, *, measure, weight_dtype, why=None) -> bool:
    """Static checks for the fused chain kernel; on a False return a
    one-line reason is appended to ``why``."""
    from ..models.variable import Continuous

    def no(reason):
        if why is not None:
            why.append(reason)
        return False

    if weight_dtype != jnp.float32:
        return no(f"weight dtype {jnp.dtype(weight_dtype).name} runs on the "
                  "XLA path (kernel accumulators are float32)")
    if measure is not None:
        return no("custom measures run on the XLA path")
    drawn = [li for li in spec.leaves if li.ndraw > 0]
    if not drawn:
        return no("no MC-owned slots to draw")
    for li in drawn:
        if not isinstance(li.leaf, Continuous):
            return no(f"{type(li.leaf).__name__} pools run on the XLA path")
        if li.leaf.ninc > MAX_NINC:
            return no(f"Continuous ninc={li.leaf.ninc} > {MAX_NINC} "
                      "(register histogram)")
    return True


def chain_walkers(neval: int, block: int, nwalkers, min_steps: int):
    """(programs per block, steps) for the kernel path: walkers a multiple
    of block*WALKERS, at most MAX_WALKERS, each walking >= min_steps."""
    if nwalkers is None:
        w = min(int(neval) // max(min_steps, 1), MAX_WALKERS)
    else:
        w = int(nwalkers)
    nprog = max(1, w // (block * WALKERS))
    nsteps = max(int(neval) // (block * nprog * WALKERS), 8)
    return nprog, nsteps


def build_chain_run_all(spec, eval_batched: Callable, *, programs: int,
                        nsteps: int, mf: int, warmup: int,
                        interpret: bool = False):
    """Return run_all(params, kd [B, 2] uint32) with the
    VegasMCIteration.run_all output contract: (obs [B, n], norm [B],
    visited [nd], hists, prop_cnt [nvar], acc_cnt [nvar]).
    """
    from .lookup import padded_hist_size

    n = spec.N
    nd = n + 1
    norm = spec.norm
    nvar = spec.nvar
    leaves = spec.leaves
    dleaf = [i for i, li in enumerate(leaves) if li.ndraw > 0]
    eligible_groups = [g for g in range(nvar) if spec.maxdof[g] > 0]
    used_np = np.asarray(spec.mask_used)          # [nd, nvar, mm] static
    pad_np = np.asarray(spec.mask_pad)
    hist_leaves = [i for i in dleaf
                   if getattr(leaves[i].leaf, "adapt", False)]
    Ls = {i: hist_side(leaves[i].leaf.ninc) for i in hist_leaves}
    warmup = min(int(warmup), nsteps - 1)
    T = WALKERS
    P = programs
    f32 = jnp.float32
    # stats columns: obs[n] | norm | visited[nd] | proposed[nvar] | accepted
    K = n + 1 + nd + 2 * nvar

    def kernel(kd_ref, rw_ref, *refs):
        nl = len(dleaf)
        pg_refs = dict(zip(dleaf, refs[:nl]))
        pi_refs = dict(zip(dleaf, refs[nl:2 * nl]))
        stats_ref = refs[2 * nl]
        hist_refs = refs[2 * nl + 1:]

        b = pl.program_id(0)
        p = pl.program_id(1)
        k1 = _mix32(kd_ref[b, 0] ^ _u32(0x243F6A88))
        k2 = _mix32(kd_ref[b, 1] + _u32(0x13198A2E))
        wctr = (p * T + jax.lax.broadcasted_iota(jnp.int32, (T,), 0)
                ).astype(jnp.uint32)
        rw = [rw_ref[i] for i in range(nd)]

        def draw_u(t, stream):
            salt = _mix32(t.astype(jnp.uint32) * _u32(_GOLD)
                          ^ salt_of(stream))
            return uniform01(random_bits(k1, k2, salt, wctr))

        def draw_leaf(lidx, t, stream):
            """Vegas-map draw (sampler.jl:293-305): bin and offset from one
            uniform, then a gather of the bin's (grid, inc)."""
            ninc = leaves[lidx].leaf.ninc
            y = draw_u(t, stream) * ninc
            iy = jnp.minimum(y.astype(jnp.int32), ninc - 1)
            dy = y - iy.astype(f32)
            pg = pg_refs[lidx][iy]
            pi = pi_refs[lidx][iy]
            return pg + dy * pi, iy, 1.0 / (ninc * pi)

        def group_slot_probs(probs):
            gp = {}
            for g in range(nvar):
                for slot in range(spec.maxdof[g]):
                    q = None
                    for lidx in spec.group_leaves[g]:
                        qi = probs[(lidx, slot)]
                        q = qi if q is None else q * qi
                    gp[(g, slot)] = q
            return gp

        def masked_prod(gp, mask_row):
            f = None
            for g in range(nvar):
                for slot in range(spec.maxdof[g]):
                    if mask_row[g, slot]:
                        f = gp[(g, slot)] if f is None else f * gp[(g, slot)]
            return f if f is not None else jnp.ones((T,), f32)

        def joint_p(weights, pads):
            q = rw[norm] * pads[norm]
            for i in range(n):
                q = q + jnp.abs(weights[i]) * rw[i] * pads[i]
            return q

        def eval_all(vals):
            return eval_batched([tuple(vals[(lidx, s)]
                                       for s in range(li.ndraw))
                                 for lidx, li in enumerate(leaves)])

        # ---- initialize! (variable.jl:576-580): fresh draw everywhere ----
        vals, gidxs, probs = {}, {}, {}
        t_init = jnp.int32(nsteps)          # a step counter no step uses
        stream = 0
        for lidx in dleaf:
            for slot in range(leaves[lidx].ndraw):
                x, iy, pr = draw_leaf(lidx, t_init, stream)
                stream += 1
                vals[(lidx, slot)] = x
                gidxs[(lidx, slot)] = iy
                probs[(lidx, slot)] = pr
        weights = eval_all(vals)
        gp = group_slot_probs(probs)
        pads = [masked_prod(gp, pad_np[i]) for i in range(nd)]
        zero = jnp.zeros((T,), f32)
        keys = list(vals)
        carry = (
            tuple(vals[k] for k in keys), tuple(gidxs[k] for k in keys),
            tuple(probs[k] for k in keys), tuple(weights), tuple(pads),
            joint_p(weights, pads),
            tuple(ksum.KSum(zero, zero) for _ in range(n + 1)),  # obs, norm
            tuple(zero for _ in range(nd + 2 * nvar)),   # visited, pc, ac
            tuple(jnp.zeros((Ls[l], Ls[l]), f32) for l in hist_leaves),
        )

        def step(t, carry):
            (cv, cg, cp, weights, pads, pj, sums, counts, hists) = carry
            vals = dict(zip(keys, cv))
            gidxs = dict(zip(keys, cg))
            probs = dict(zip(keys, cp))
            weights, pads = list(weights), list(pads)

            # -- changeVariable proposal (updates.jl:45-106) --
            if len(eligible_groups) > 1:
                vi = jnp.minimum(
                    (draw_u(t, 0) * len(eligible_groups)).astype(jnp.int32),
                    len(eligible_groups) - 1)
            else:
                vi = jnp.zeros((T,), jnp.int32)
            u_slot = draw_u(t, 1)
            nvals, ngidxs, nprobs = dict(vals), dict(gidxs), dict(probs)
            prop = jnp.ones((T,), f32)
            for gi_, g in enumerate(eligible_groups):
                md = spec.maxdof[g]
                idx_g = jnp.minimum((u_slot * md).astype(jnp.int32), md - 1)
                sel = vi == gi_
                prop_g = jnp.ones((T,), f32)
                for lidx in spec.group_leaves[g]:
                    x, iy, pr = draw_leaf(lidx, t, 3 + lidx)
                    for slot in range(md):
                        hit = sel & (idx_g == slot)
                        prop_g = jnp.where(
                            hit, prop_g * (probs[(lidx, slot)] / pr), prop_g)
                        nvals[(lidx, slot)] = jnp.where(
                            hit, x, nvals[(lidx, slot)])
                        ngidxs[(lidx, slot)] = jnp.where(
                            hit, iy, ngidxs[(lidx, slot)])
                        nprobs[(lidx, slot)] = jnp.where(
                            hit, pr, nprobs[(lidx, slot)])
                prop = jnp.where(sel, prop_g, prop)

            new_weights = eval_all(nvals)
            ngp = group_slot_probs(nprobs)
            new_pads = [masked_prod(ngp, pad_np[i]) for i in range(nd)]
            new_p = joint_p(new_weights, new_pads)
            accept = ((draw_u(t, 2) < prop * new_p / pj)
                      & (prop > TINY_F32))
            for k in keys:
                vals[k] = jnp.where(accept, nvals[k], vals[k])
                gidxs[k] = jnp.where(accept, ngidxs[k], gidxs[k])
                probs[k] = jnp.where(accept, nprobs[k], probs[k])
            weights = [jnp.where(accept, nw, w)
                       for nw, w in zip(new_weights, weights)]
            pads = [jnp.where(accept, npd, pd)
                    for npd, pd in zip(new_pads, pads)]
            pj = jnp.where(accept, new_p, pj)

            # -- proposal / acceptance tallies per var type --
            counts = list(counts)
            af = accept.astype(f32)
            for gi_, g in enumerate(eligible_groups):
                selg = (vi == gi_).astype(f32)
                counts[nd + g] = counts[nd + g] + selg
                counts[nd + nvar + g] = counts[nd + nvar + g] + selg * af

            # -- histograms every step (montecarlo.jl:198-211) --
            hists = list(hists)
            gp2 = group_slot_probs(probs)
            for h, lidx in enumerate(hist_leaves):
                li = leaves[lidx]
                for slot in range(li.ndraw):
                    sw = None
                    for i in range(n):
                        if used_np[i, li.group, slot]:
                            prob_i = masked_prod(gp2, used_np[i])
                            wf2 = jnp.minimum(weights[i] * weights[i]
                                              / prob_i * pads[i] / pj, 1e34)
                            sw = wf2 if sw is None else sw + wf2
                    if sw is not None:
                        hists[h] = hists[h] + onehot_hist(
                            gidxs[(lidx, slot)], sw, Ls[lidx])

            # -- measurement (montecarlo.jl:213-232) --
            # 1.0 on measured steps: integer arithmetic, because the Triton
            # lowering mistypes a scalar bool -> float conversion
            mw = (jnp.clip(t - warmup + 1, 0, 1)
                  * (1 - jnp.minimum(_rem(t, mf), 1))).astype(f32)
            sums = list(sums)
            for i in range(n):
                sums[i] = ksum.kadd(sums[i], weights[i] * (pads[i] / pj) * mw)
                counts[i] = counts[i] + (jnp.abs(weights[i]) * pads[i]
                                         * rw[i] / pj * mw)
            norm_w = pads[norm] / pj
            sums[n] = ksum.kadd(sums[n], norm_w * mw)
            counts[norm] = counts[norm] + rw[norm] * norm_w * mw
            return (tuple(vals[k] for k in keys),
                    tuple(gidxs[k] for k in keys),
                    tuple(probs[k] for k in keys), tuple(weights),
                    tuple(pads), pj, tuple(sums), tuple(counts),
                    tuple(hists))

        carry = jax.lax.fori_loop(0, nsteps, step, carry)
        sums, counts, hists = carry[6], carry[7], carry[8]
        for i, acc in enumerate(sums):
            stats_ref[b, p, i] = jnp.sum(acc.s) + jnp.sum(acc.c)
        for j, c in enumerate(counts):
            stats_ref[b, p, n + 1 + j] = jnp.sum(c)
        for h in range(len(hist_leaves)):
            hist_refs[h][b, p] = hists[h]

    def run_all(params, kd):
        B = kd.shape[0]
        pgs, pis = [], []
        for lidx in dleaf:
            tab = params["leaf"][lidx]["tab"]
            Lt = tab.shape[0]
            flat = tab.reshape(Lt * Lt, 2)[: leaves[lidx].leaf.ninc]
            pgs.append(flat[:, 0])
            pis.append(flat[:, 1])
        out_shape = [jax.ShapeDtypeStruct((B, P, K), f32)] + [
            jax.ShapeDtypeStruct((B, P, Ls[l], Ls[l]), f32)
            for l in hist_leaves]
        outs = pl.pallas_call(
            kernel,
            grid=(B, P),
            out_shape=out_shape,
            backend="triton",
            interpret=interpret,
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                               num_stages=1),
            name="vegasmc_chain",
        )(kd, params["reweight"].astype(f32), *pgs, *pis)
        per_block = add_in_order(outs[0])                       # [B, K]
        tot = jnp.sum(per_block, axis=0)
        visited = tot[n + 1:n + 1 + nd]
        pc = tot[n + 1 + nd:n + 1 + nd + nvar]
        ac = tot[n + 1 + nd + nvar:]
        hist_out = {}
        for h, lidx in enumerate(hist_leaves):
            hb = jnp.sum(add_in_order(outs[1 + h]), axis=0)     # [L, L]
            hist_out[lidx] = hb.reshape(-1)[: leaves[lidx].leaf.ninc]
        hists = []
        for lidx, li in enumerate(leaves):
            size = padded_hist_size(li.nhist)
            h = hist_out.get(lidx)
            hists.append(jnp.zeros((size,), f32) if h is None
                         else jnp.pad(h, (0, size - h.shape[0])))
        return per_block[:, :n], per_block[:, n], visited, hists, pc, ac

    return run_all
