"""The ``integrate`` driver — user entry point.

Reference: ``integrate`` (src/main.jl:71-218).  The iteration structure is
preserved — niter rounds of (blocks -> reduce -> reweight -> train) — but the
parallel decomposition is redesigned (SURVEY.md §2.3): blocks are vmapped
lanes sharded over a 1-D device mesh, per-iteration statistics come back
through a single collective, and every host/devicen computes identical
reweight/train updates (no root/worker asymmetry).

Host-side per-iteration math (reweighting src/main.jl:322-356, block
statistics src/main.jl:296-320, grid training) runs in float64 numpy.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .configuration import Configuration
from .statistics import Result, mean_std, report
from .solvers.engine import Spec
from .solvers.vegas import VegasIteration
from .utils import ProgressBar, StopWatch, green, red, yellow
from .parallel.mesh import default_mesh


# ---------------------------------------------------------------------------
# Iteration-kernel cache.
#
# Julia's method JIT compiles `montecarlo` once per session; here every
# integrate() call used to build a fresh jax.jit wrapper, re-tracing the
# fused kernel from scratch (~9 s at 32 integrands) even though an
# identically-shaped kernel was traced moments earlier.  Caching the built
# iteration object on (integrand identity, structural signature) restores
# the compile-once behavior for the common benchmark/production pattern of
# repeated integrate() calls over the same problem shape.  All run-to-run
# inputs (grids, reweight, RNG keys) flow through run(params, key), so a
# cache hit is bit-identical to a fresh build; vegasplus additionally
# carries adaptive lane-allocation state across run() calls and is reset on
# every hit (reset_state) to keep same-seed determinism.
# ---------------------------------------------------------------------------
_KERNEL_CACHE: "dict" = {}
_KERNEL_CACHE_MAX = 16  # LRU cap; raise/lower for workloads cycling through
                        # many distinct problem shapes (each entry pins its
                        # compiled executables + baked device constants)


def clear_kernel_cache():
    """Drop every cached iteration kernel (and its device-resident baked
    constants).  Long-lived processes that cycle through many distinct
    problem shapes can call this between phases to release HBM."""
    _KERNEL_CACHE.clear()


_LEAF_SIG_FIELDS = ("ninc", "nbin", "lower", "upper", "range", "offset",
                    "size", "alpha", "adapt", "nhist", "dim", "kF",
                    "delta_k", "maxK", "value_width")


def _value_sig(v, _depth=0):
    """Hashable signature of a captured value, or None if uncacheable.

    Scalars hash by value; arrays by (shape, dtype, content digest);
    containers recurse.  Anything else (mutable objects, dicts with
    non-str keys, ...) returns None so the caller refuses to cache."""
    import types
    if _depth > 4:
        return None
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return ("s", v)
    if isinstance(v, types.ModuleType):
        # functions defined under local imports close over the module
        # object itself; identity-by-name is sound (reassigning module
        # attributes mid-run is out of contract, same as jit)
        return ("mod", v.__name__)
    if isinstance(v, (np.ndarray, np.generic)) or hasattr(v, "__jax_array__") \
            or type(v).__module__.startswith("jax"):
        try:
            a = np.asarray(v)
        except Exception:
            return None
        import hashlib
        return ("a", a.shape, a.dtype.name,
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
    if isinstance(v, (tuple, list)):
        sub = tuple(_value_sig(x, _depth + 1) for x in v)
        return None if any(s is None for s in sub) else ("t", type(v).__name__, sub)
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            return None
        sub = tuple((k, _value_sig(v[k], _depth + 1)) for k in sorted(v))
        return None if any(s is None for _, s in sub) else ("d", sub)
    import types
    if isinstance(v, types.FunctionType):
        return _callable_sig(v, _depth + 1)
    return None


def _callable_sig(fn, _depth=0):
    """Signature of a callable's captured state (closure cells, instance
    attributes), or None if any captured value is unhashable.

    The cache key already holds a weakref to the callable itself, which
    pins identity; this adds the *contents* so a lambda over a mutated
    closure cell, or a callable object whose attributes changed, misses
    the cache instead of silently reusing a stale trace (jit-style
    'captured values are baked in' semantics, made safe)."""
    import types
    if _depth > 4:
        return None
    if isinstance(fn, types.MethodType):
        inner = _callable_sig(fn.__func__, _depth + 1)
        self_sig = _value_sig(getattr(fn, "__self__", None), _depth + 1)
        if self_sig is None:
            self_sig = _instance_sig(fn.__self__, _depth + 1)
        return None if inner is None or self_sig is None \
            else ("m", inner, self_sig)
    if isinstance(fn, types.FunctionType):
        parts = [("code", id(fn.__code__))]
        closure = fn.__closure__
        if closure:
            for cell in closure:
                try:
                    cv = cell.cell_contents
                except ValueError:
                    return None
                s = _value_sig(cv, _depth + 1)
                if s is None:
                    return None
                parts.append(s)
        if fn.__dict__:
            s = _value_sig(dict(fn.__dict__), _depth + 1)
            if s is None:
                return None
            parts.append(("attrs", s))
        return ("f", tuple(parts))
    if callable(fn):
        # callable object: key on type + instance attributes
        inst = _instance_sig(fn, _depth + 1)
        return None if inst is None else ("o", type(fn).__qualname__, inst)
    return None


def _instance_sig(obj, _depth=0):
    d = getattr(obj, "__dict__", None)
    if d is None:
        return ("i", type(obj).__qualname__)
    s = _value_sig(dict(d), _depth)
    return None if s is None else ("i", type(obj).__qualname__, s)


def _leaf_sig(leaf):
    vals = []
    for f in _LEAF_SIG_FIELDS:
        if not hasattr(leaf, f):
            continue
        s = _value_sig(getattr(leaf, f))
        if s is None:   # unhashable leaf field: make the key unique
            return (type(leaf).__name__, "nocache", id(leaf), object())
        vals.append((f, s))
    return (type(leaf).__name__,) + tuple(vals)


def _tree_sig(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return (str(treedef),) + tuple(
        (np.shape(x), np.asarray(x).dtype.name) for x in leaves)


def _cache_key(config, kernel_kind, integrand, measure, **knobs):
    """Structural cache key, or None when caching would be unsound."""
    if config.userdata is not None:
        # userdata is captured as a traced constant inside the kernel; two
        # configs with different userdata must not share a compiled kernel
        return None
    # captured-state signatures: a callable whose closure cells / instance
    # attributes changed between calls must not hit the old trace; if the
    # captured state is unhashable we refuse to cache at all
    fn_sig = _callable_sig(integrand)
    if fn_sig is None:
        return None
    ms_sig = None
    if measure is not None:
        ms_sig = _callable_sig(measure)
        if ms_sig is None:
            return None
    try:
        import weakref
        fn_ref = weakref.ref(integrand)
        ms_ref = weakref.ref(measure) if measure is not None else None
    except TypeError:
        return None
    mesh = knobs.pop("mesh")
    mesh_sig = None
    if mesh is not None:
        mesh_sig = (tuple(mesh.axis_names),
                    tuple(int(mesh.shape[a]) for a in mesh.axis_names),
                    tuple(d.id for d in np.asarray(mesh.devices).ravel()))
    return (
        kernel_kind, fn_ref, fn_sig, ms_ref, ms_sig, mesh_sig,
        tuple(sorted(knobs.items())),
        int(config.seed), config.N, config.norm,
        tuple(tuple(int(x) for x in row) for row in config.dof),
        tuple(tuple(int(x) for x in row) for row in config.neighbor),
        tuple(_leaf_sig(leaf) for _, leaf in config.var_leaves()),
        _tree_sig(config.observable),
    )


def _standardize_block(neval, nblock, nworker):
    """Round block count to a multiple of the worker count.

    Reference: _standardize_block (src/main.jl:220-234) with MPI ranks
    replaced by mesh devices.
    """
    neval = int(neval)
    nblock = int(nblock)
    assert neval > nblock, f"neval={neval} should be larger than block={nblock}"
    if nblock > nworker:
        nblock = (nblock // nworker) * nworker
    else:
        nblock = nworker
    nevalperblock = neval // nblock
    return nevalperblock, nblock


def do_reweight(config: Configuration, gamma: float, reweight_goal):
    """Visited-count reweighting (src/main.jl:322-346)."""
    avgstep = float(np.sum(config.visited))
    for vi in range(len(config.visited)):
        v = config.visited[vi]
        if v <= 1:
            config.reweight[vi] *= avgstep**gamma
        else:
            config.reweight[vi] *= (avgstep / v) ** gamma
    if reweight_goal is not None:
        goal = np.asarray(reweight_goal, dtype=np.float64)
        config.reweight *= goal / goal.sum()
    config.reweight /= config.reweight.sum()


def integrate(integrand: Callable, *,
              solver: str = "vegasmc",
              config: Optional[Configuration] = None,
              neval=1e4,
              niter: int = 10,
              block: int = 16,
              verbose: int = -1,
              gamma: float = 1.0,
              adapt: bool = True,
              debug: bool = False,
              reweight_goal=None,
              ignore: Optional[int] = None,
              measure: Optional[Callable] = None,
              measurefreq: int = 1,
              thermal_ratio: float = 0.1,
              inplace: bool = False,
              parallel: str = "auto",
              print: int = -1,  # legacy alias of verbose (src/main.jl:92-93)
              timer=None,
              mesh=None,
              nwalkers: Optional[int] = None,
              min_steps_per_walker: int = 256,
              warmup: Optional[float] = None,
              dtype=jnp.float32,
              backend: str = "auto",
              cache: bool = True,
              **kwargs):
    """Calculate the integrals; returns a :class:`Result`.

    Mirrors the reference keyword surface (src/main.jl:71-90); extra
    knobs: ``mesh`` (a jax Mesh whose first axis shards the
    block/walker dimension), ``nwalkers``/``min_steps_per_walker`` (Markov
    solvers), ``warmup`` (:vegasmc burn-in fraction discarded per chain
    per iteration; default 0.01 like the reference — raise toward ~0.5
    for deliberately frozen, badly mismatched proposals so the chains can
    mix before measuring), ``dtype`` (device compute dtype), and ``backend``
    ('auto'/'pallas'/'xla'): 'auto' uses the solver's fused Triton kernel
    on a CUDA GPU when the spec is eligible, 'xla' forces the portable XLA
    pipeline, 'pallas' insists on the fused kernel (in interpret mode off
    the GPU; the reason is recorded if the solver has none).
    ``kwargs`` are passed through to :class:`Configuration`.

    The returned :class:`Result` records which compute path actually ran
    in ``result.backend`` ('pallas' or 'xla'); when a solver with a fused
    kernel fell back to XLA, ``result.backend_reason`` says why, and the
    same note is printed once at ``verbose >= 0``.

    **Kernel caching.** Repeated ``integrate()`` calls over the same
    problem shape reuse the compiled iteration kernel (jit-style: up to
    ``main._KERNEL_CACHE_MAX`` = 16 entries, LRU).  Like ``jax.jit``,
    values the integrand captures (closure cells, callable-object
    attributes) are baked into the trace; the cache folds a content hash
    of that captured state into its key, and refuses to cache callables
    whose captured state it cannot hash — but values reached through
    *module globals* are invisible to it.  An integrand that reads a
    mutated global between calls must pass ``cache=False`` (or call
    :func:`clear_kernel_cache`).
    """
    verbose = max(print, verbose)
    if config is None:
        config = Configuration(**kwargs)
    if gamma > 1.0 and verbose >= 0:
        import sys
        sys.stderr.write(red("learning rate gamma should be less than 1.0") + "\n")
    if ignore is None:
        ignore = 1 if adapt else 0

    timers = list(timer) if timer is not None else []
    if verbose > 0:
        timers.append(StopWatch(verbose, lambda cfg, *_: cfg.report()))
    # Mid-iteration observability (reference polls StopWatch every 1000
    # steps inside the hot loop, src/vegas_mc/montecarlo.jl:233-237): with
    # timers active, split each iteration into sub-dispatches so the
    # watch can fire with live acceptance tables between them.  Silent
    # runs keep the single-dispatch fast path.  Markov solvers run K
    # shorter chains per block lane (statistically valid; slightly more
    # warmup overhead — a diagnostic-mode tradeoff).  The split count is a
    # WALL-CLOCK policy: after the first iteration's wall time is known,
    # the kernel is re-split so sub-dispatches last about half the
    # shortest timer interval (capped at 256 splits to bound dispatch
    # overhead), so `print`-second report intervals are honored regardless
    # of iteration length — the analogue of the reference's every-1000-
    # steps in-loop poll (src/utility/stopwatch.jl:11-29).
    nsplit = 4 if timers else 1

    # the reference's parallel=:thread/:nothread toggles intra-process
    # threading; the analog here is the device mesh ('none' disables it)
    if mesh is None and parallel in ("auto", "thread", ":thread",
                                     "nothread", ":nothread"):
        mesh = default_mesh()
    nworker = 1
    if mesh is not None:
        nworker = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    nevalperblock, block = _standardize_block(neval, block, nworker)

    weight_dtype = jnp.complex64 if config.type is complex else dtype
    spec = Spec(config, dtype=dtype)

    if debug:
        from .debug import probe_integrand
        probe_integrand(spec, integrand, measure, inplace,
                        str(solver).lstrip(":"), weight_dtype)

    solver = str(solver).lstrip(":")
    kernel_kind = solver
    if solver in ("vegas+", "vegasplus"):
        solver = "vegas"  # downstream (reweight/train) semantics are :vegas

    def build_kernel(npb):
        key = None if not cache else _cache_key(
            config, kernel_kind, integrand, measure,
            mesh=mesh, npb=int(npb), block=int(block),
            measurefreq=int(measurefreq), inplace=bool(inplace),
            weight_dtype=str(np.dtype(weight_dtype)), dtype=str(np.dtype(dtype)),
            nwalkers=nwalkers, min_steps_per_walker=int(min_steps_per_walker),
            warmup=warmup, thermal_ratio=float(thermal_ratio),
            backend=str(backend))
        if key is not None and key in _KERNEL_CACHE:
            it = _KERNEL_CACHE.pop(key)
            _KERNEL_CACHE[key] = it          # LRU: move to back
            # rebind THIS call's spec: a cached kernel must see the new
            # call's live config, not the one it was built around (all
            # closure-captured spec uses are structural and identical by
            # key)
            it.spec = spec
            it.reset_state()
            return it
        it = _build_kernel_fresh(npb)
        if key is not None:
            _KERNEL_CACHE[key] = it
            while len(_KERNEL_CACHE) > _KERNEL_CACHE_MAX:
                _KERNEL_CACHE.pop(next(iter(_KERNEL_CACHE)))
        return it

    def _build_kernel_fresh(npb):
        if kernel_kind in ("vegas+", "vegasplus"):
            from .solvers.vegasplus import VegasPlusIteration
            return VegasPlusIteration(
                spec, integrand, measure=measure, inplace=inplace,
                measurefreq=measurefreq, block=block, nevalperblock=npb,
                mesh=mesh, weight_dtype=weight_dtype,
                obs_proto=config.observable, backend=backend)
        if kernel_kind == "vegas":
            return VegasIteration(
                spec, integrand, measure=measure, inplace=inplace,
                measurefreq=measurefreq, block=block, nevalperblock=npb,
                mesh=mesh, weight_dtype=weight_dtype,
                obs_proto=config.observable, backend=backend)
        if kernel_kind == "vegasmc":
            from .solvers.vegasmc import VegasMCIteration
            return VegasMCIteration(
                spec, integrand, measure=measure, inplace=inplace,
                measurefreq=measurefreq, block=block, nevalperblock=npb,
                mesh=mesh, weight_dtype=weight_dtype,
                obs_proto=config.observable,
                nwalkers=nwalkers, min_steps_per_walker=min_steps_per_walker,
                backend=backend,
                warmup=0.01 if warmup is None else warmup)
        if kernel_kind == "mcmc":
            from .solvers.mcmc import MCMCIteration
            return MCMCIteration(
                spec, integrand, measure=measure,
                measurefreq=measurefreq, block=block, nevalperblock=npb,
                mesh=mesh, weight_dtype=weight_dtype,
                obs_proto=config.observable,
                thermal_ratio=thermal_ratio,
                nwalkers=nwalkers, min_steps_per_walker=min_steps_per_walker,
                backend=backend)
        raise ValueError(f"Solver {kernel_kind} is not supported!")

    it_kernel = build_kernel(max(nevalperblock // nsplit, 1))
    # surface which compute path actually runs (fused Pallas vs portable
    # XLA) and, on fallback, why — so a user who loses the fast path can
    # tell from the output/Result instead of guessing from throughput
    run_backend = getattr(it_kernel, "backend", "xla")
    backend_reason = getattr(it_kernel, "backend_reason", "")
    if verbose >= 0 and run_backend != "pallas" and backend_reason:
        import sys
        sys.stdout.write(yellow(
            f"{kernel_kind}: routed to XLA — {backend_reason}\n"))

    base_key = jax.random.key(config.seed)
    progress = ProgressBar(niter * block, desc=f"iters x blocks: ",
                           enabled=(verbose >= -1))

    start = time.time()
    results = []
    for it in range(niter):
        params = spec.device_params()
        key = jax.random.fold_in(base_key, it)
        stats = None
        sub0_end = None
        for sub in range(nsplit):
            sub_key = (key if nsplit == 1
                       else jax.random.fold_in(key, sub + 1))
            stats_k = it_kernel.run(params, sub_key)
            if sub == 0:
                sub0_end = time.time()
            if debug:
                from .debug import check_iteration_stats
                check_iteration_stats(stats_k, it)

            # ---- merge device statistics into the host config (the
            # reference's addConfig!/MPIreduceConfig! step,
            # configuration.jl:238-299) — incrementally per sub-dispatch
            # so the StopWatch sees live tallies ----
            config.neval += stats_k["neval"]
            for lidx, (_, leaf) in enumerate(config.var_leaves()):
                leaf.add_statistics(stats_k["hists"][lidx])
            if "visited" in stats_k:
                config.visited += stats_k["visited"]
            if "propose" in stats_k:
                config.propose += stats_k["propose"]
                config.accept += stats_k["accept"]
            stats = _merge_stats(stats, stats_k)
            if sub + 1 < nsplit:
                for t in timers:
                    t.check(config)

        norm_b = stats["norm_blocks"]
        if not np.all(norm_b > 0):
            raise RuntimeError(
                f"Block normalization = {norm_b.min()} is not positively defined!")
        config.normalization += float(norm_b.sum())

        # ---- block statistics (src/main.jl:275-287, 296-320) ----
        obs_blocks = stats["obs_blocks"]  # pytree, leading axis [block]
        obs_sum, obs_sq = [], []
        for o in range(config.N):
            ob = _to_numpy(_component(obs_blocks, o))
            m = _divide_norm(ob, norm_b)
            s = _tree_sum_blocks(m)
            sq = _tree_sq_sum_blocks(m)
            obs_sum.append(s)
            obs_sq.append(sq)
        means, stds = mean_std(obs_sum, obs_sq, block)

        # ---- self-learning (src/main.jl:183-199) ----
        if solver in ("mcmc", "vegasmc"):
            do_reweight(config, gamma, reweight_goal)
        if adapt:
            for v in config.var:
                v.train()

        results.append((means, stds, _snapshot_config(config, stats["neval"])))
        progress.update(block, evals=stats["neval"])
        for t in timers:
            t.check(config)

        # ---- wall-clock split policy (module comment at nsplit) ----
        # After the first iteration's wall time is known, re-split so the
        # timers are polled ~2x per interval.  One kernel rebuild total;
        # the recompile amortizes over the remaining iterations (only
        # rebuilt when it buys at least 2x finer polling).
        ints = [t.interval for t in timers if hasattr(t, "interval")]
        if ints and it == 0 and niter > 1 and nsplit > 1:
            # steady-state iteration wall time, excluding the first
            # sub-dispatch (it carries the one-off compile)
            t_iter = (time.time() - sub0_end) * nsplit / (nsplit - 1)
            want = int(np.clip(np.ceil(t_iter / max(min(ints) * 0.5, 0.05)),
                               1, 256))
            if want >= 2 * nsplit:
                nsplit = want
                it_kernel = build_kernel(max(nevalperblock // nsplit, 1))

    result = Result(results, ignore, config=config)
    result.backend = run_backend
    result.backend_reason = backend_reason
    result.wall_time = time.time() - start
    result.evals_per_s = result.neval / max(result.wall_time, 1e-12)
    if verbose >= 0:
        report(result)
        if verbose > 0:
            import sys
            sys.stdout.write(yellow(
                f"Total time: {time.time() - start:.2f} seconds.\n"))
    return result


def _merge_stats(a, b):
    """Merge two iteration-stat dicts (all fields are additive: per-block
    measurement sums, normalization counts, histograms, tallies)."""
    if a is None:
        return b
    out = {"neval": a["neval"] + b["neval"],
           "obs_blocks": jax.tree_util.tree_map(
               lambda x, y: x + y, a["obs_blocks"], b["obs_blocks"]),
           "norm_blocks": a["norm_blocks"] + b["norm_blocks"],
           "hists": [x + y for x, y in zip(a["hists"], b["hists"])]}
    for k in ("visited", "propose", "accept"):
        if k in a:
            out[k] = a[k] + b[k]
    return out


def _component(obs_blocks, o: int):
    """Extract integrand o's sub-tree from the per-block observable pytree."""
    if isinstance(obs_blocks, (list, tuple)):
        return obs_blocks[o]
    # default measure: single array [block, N]
    arr = np.asarray(obs_blocks)
    return arr[:, o]


def _to_numpy(x):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), x)


def _divide_norm(ob, norm_b):
    def f(a):
        a = np.asarray(a, dtype=np.complex128 if np.iscomplexobj(a) else np.float64)
        shape = (-1,) + (1,) * (a.ndim - 1)
        return a / norm_b.reshape(shape)
    return jax.tree_util.tree_map(f, ob)


def _tree_sum_blocks(m):
    return jax.tree_util.tree_map(lambda a: a.sum(axis=0), m)


def _tree_sq_sum_blocks(m):
    def f(a):
        if np.iscomplexobj(a):
            return (a.real**2 + 1j * a.imag**2).sum(axis=0)
        return (a**2).sum(axis=0)
    return jax.tree_util.tree_map(f, m)


def _snapshot_config(config, iter_neval: int):
    """Full per-iteration config snapshot for the Result history.

    A deep copy of the Configuration — trained grids/CDFs, reweight,
    visited, tallies — exactly like the reference's per-iteration
    deep-copied configs (src/main.jl:296-320, src/statistics.jl:16-23), so
    any iteration's state can be inspected or warm-started from
    (``integrate(config=res.iterations[k][2], ...)``).  ``neval`` is set
    to THIS iteration's eval count so ``Result.neval`` sums correctly.
    ``userdata`` is shared by reference, not copied (it may be large and
    is never mutated by the framework).
    """
    import copy

    ud = config.userdata
    config.userdata = None
    try:
        snap = copy.deepcopy(config)
    finally:
        config.userdata = ud
    snap.userdata = ud
    snap.neval = int(iter_neval)
    return snap
