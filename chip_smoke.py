"""Smoke test of mcintegration on NVIDIA GPUs.

Drives ``integrate()`` through its main paths at full size on one card,
checks every estimate against its exact value, compares each fused Triton
kernel with the plain XLA path of the same call, and times both.

    python chip_smoke.py             # one card: phases 0-4
    python chip_smoke.py --cards 4   # the 4-card mesh path and its
                                     # one-card comparison, nothing else

Each phase prints its lines; any failed check exits non-zero.  The last
line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU (or outside a checkout of this repository) the script exits
non-zero and prints no result line.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PI_NEVAL = 10 ** 8        # :vegasmc main path, per iteration
VEGAS_NEVAL = 2 ** 30     # :vegas headline, per iteration
BUBBLE_NEVAL = 10 ** 7
# the bubble's chains need longer mixing than the defaults give at this
# size (1% burn-in of 256-step chains biases :vegasmc by ~25 sigma, and
# 256-step :mcmc chains by ~40 sigma, on the CPU and the GPU alike)
BUBBLE_CHAINS = {"vegasmc": {"warmup": 0.25},
                 "mcmc": {"min_steps_per_walker": 2048}}
VPLUS_NEVAL = 10 ** 8
CMP_BLOCK = 64            # blocks of the kernel-vs-XLA runs (tighter sigma)
MEAN_K = 5.0              # kernel vs XLA: |dmean| < 5 sqrt(sk^2 + sx^2)
SIGMA_RATIO = (0.7, 1.4)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def load_bubble():
    spec = importlib.util.spec_from_file_location(
        "bubble_example", os.path.join(HERE, "examples", "bubble.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pi_quarter(x, c):
    import jax.numpy as jnp
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def scalar(res):
    return float(np.asarray(res.mean[0])), float(np.asarray(res.stdev[0]))


def check_ks(name, mean, std, exact, k):
    z = abs(mean - exact) / max(std, 1e-300)
    say(f"  {name}: {mean:.9g} +- {std:.3g}, exact {exact:.9g}: "
        f"{z:.2f} sigma (limit {k:g})")
    if not z < k:
        fail(f"{name} off by {z:.2f} sigma")


def check_backend(name, res, want, reason_has=""):
    say(f"  {name}: backend={res.backend}"
        + (f" ({res.backend_reason})" if res.backend_reason else ""))
    if res.backend != want or reason_has not in res.backend_reason:
        fail(f"{name} ran on '{res.backend}' ({res.backend_reason}), "
             f"expected '{want}'")


def pi_run(integrate, Continuous, solver, neval, niter, **kw):
    return integrate(pi_quarter, solver=solver, var=Continuous(0.0, 1.0),
                     dof=[[2]], neval=neval, niter=niter, verbose=-2,
                     seed=kw.pop("seed", 7), **kw)


def compare(name, rk, rx):
    """Kernel result ``rk`` against the plain XLA result ``rx``."""
    (mk, sk), (mx, sx) = scalar(rk), scalar(rx)
    lim = MEAN_K * np.hypot(sk, sx)
    ratio = sk / sx
    say(f"  {name}: kernel {mk:.9g} +- {sk:.3g} | xla {mx:.9g} +- {sx:.3g}"
        f" | |d|={abs(mk - mx):.3g} < {lim:.3g} (5 sqrt(sk^2+sx^2))"
        f" | sk/sx={ratio:.3f} in [{SIGMA_RATIO[0]}, {SIGMA_RATIO[1]}]"
        " | precision: float32 samples, HIGHEST for XLA contractions")
    if not abs(mk - mx) < lim:
        fail(f"{name}: kernel and XLA means disagree")
    if not SIGMA_RATIO[0] <= ratio <= SIGMA_RATIO[1]:
        fail(f"{name}: error-bar ratio {ratio:.3f} out of range")


def same_bits(a, b):
    return (np.array_equal(np.asarray(a.mean[0]), np.asarray(b.mean[0]))
            and np.array_equal(np.asarray(a.stdev[0]), np.asarray(b.stdev[0]))
            and all(np.array_equal(u.grid, v.grid)
                    for u, v in zip(a.config.var, b.config.var)))


def time_iteration(it, reps):
    """Per-iteration device time of one compiled kernel, with the first
    (compiling) call reported apart.  ``run`` ends in a blocking fetch of
    the statistics, so every timed call includes the device work."""
    import jax

    params = it.spec.device_params()
    t0 = time.perf_counter()
    it.run(params, jax.random.key(0))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in range(reps):
        stats = it.run(params, jax.random.key(r + 1))
    warm = (time.perf_counter() - t0) / reps
    return stats["neval"], warm, max(first - warm, 0.0)


def phase_timing(card):
    import jax.numpy as jnp
    from mcintegration.configuration import Configuration
    from mcintegration.models.variable import Continuous
    from mcintegration.solvers.engine import Spec
    from mcintegration.solvers.vegas import VegasIteration
    from mcintegration.solvers.vegasmc import VegasMCIteration

    say("[phase 4] timing: warm integrand evals/s per iteration "
        "(device + blocking stats fetch), compile reported apart")
    rates = {}
    for solver, cls, neval in (("vegas", VegasIteration, VEGAS_NEVAL),
                               ("vegasmc", VegasMCIteration, PI_NEVAL)):
        for backend in ("pallas", "xla"):
            spec = Spec(Configuration(var=Continuous(0.0, 1.0), dof=[[2]],
                                      seed=7), dtype=jnp.float32)
            it = cls(spec, pi_quarter, block=16, nevalperblock=neval // 16,
                     backend=backend)
            if it.backend != backend:
                fail(f"{solver} timing wanted {backend}: {it.backend_reason}")
            neval_it, warm, comp = time_iteration(it, 5)
            rates[(solver, backend)] = neval_it / warm
            say(f"  {solver} {backend:6s}: {neval_it / warm:.6g} evals/s "
                f"({neval_it} evals in {warm:.4f} s), compile "
                f"{comp:.2f} s | {card}")
    for solver in ("vegas", "vegasmc"):
        say(f"  {solver}: kernel / xla = "
            f"{rates[(solver, 'pallas')] / rates[(solver, 'xla')]:.2f}x")
    return rates


def phase_e2e_timing(integrate, Continuous, card):
    say("[phase 4b] end to end: warm integrate() wall time "
        "(kernel cache hit), first call's extra time reported apart")
    for solver, neval, niter in (("vegas", VEGAS_NEVAL, 3),
                                 ("vegasmc", PI_NEVAL, 5)):
        for backend in ("pallas", "xla"):
            kw = dict(backend=backend, seed=11)
            t0 = time.perf_counter()
            pi_run(integrate, Continuous, solver, neval, niter, **dict(kw))
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = pi_run(integrate, Continuous, solver, neval, niter,
                         **dict(kw))
            warm = time.perf_counter() - t0
            say(f"  {solver} {backend:6s}: {res.neval / warm:.6g} evals/s "
                f"({res.neval} evals in {warm:.3f} s), first call "
                f"+{max(cold - warm, 0.0):.2f} s | {card}")


def one_card(card):
    from mcintegration import Continuous, integrate

    bub = load_bubble()

    def bubble(solver, neval, **kw):
        fi = ((lambda idx, v, c: bub.integrand(v, c)) if solver == "mcmc"
              else bub.integrand)
        if solver == "mcmc":
            import jax.numpy as jnp

            def m(idx, v, relw, c):
                oh = (jnp.arange(1, bub.QSIZE + 1) == v[-1][0])
                return [oh.astype(relw.dtype) * relw]
        else:
            m = bub.measure
        var = (Continuous(0.0, 1.0, alpha=3.0),
               Continuous(0.0, np.pi, alpha=3.0),
               Continuous(0.0, 2 * np.pi, alpha=3.0),
               Continuous(0.0, bub.BETA_PHYS, alpha=3.0),
               bub.Discrete(1, bub.QSIZE, adapt=False))
        return integrate(fi, measure=m, var=var, dof=[[1, 1, 1, 1, 1]],
                         obs=[np.zeros(bub.QSIZE)], solver=solver,
                         neval=neval, verbose=-2, seed=101,
                         **BUBBLE_CHAINS[solver], **kw)

    def check_bubble(name, res, k):
        avg = np.asarray(res.mean[0])
        std = np.asarray(res.stdev[0])
        for i in range(bub.QSIZE):
            check_ks(f"{name} q={bub.EXTQ[i][0] / bub.KF:.3f}kF", avg[i],
                     std[i], bub.lindhard(bub.EXTQ[i][0]), k)

    say(f"[phase 1] main path: integrate() defaults (solver :vegasmc) | {card}")
    t0 = time.perf_counter()
    res_mc = pi_run(integrate, Continuous, "vegasmc", PI_NEVAL, 5)
    check_backend("vegasmc pi/4", res_mc, "pallas")
    check_ks("vegasmc pi/4 (neval 1e8 x 5)", *scalar(res_mc), np.pi / 4, 10)
    res = bubble("vegasmc", BUBBLE_NEVAL)
    check_backend("vegasmc bubble", res, "xla", "measure")
    check_bubble("vegasmc bubble", res, 10)
    say(f"  phase 1 wall {time.perf_counter() - t0:.1f} s")

    say("[phase 2] other solvers")
    t0 = time.perf_counter()
    res_v = pi_run(integrate, Continuous, "vegas", VEGAS_NEVAL, 3)
    check_backend("vegas pi/4", res_v, "pallas")
    check_ks("vegas pi/4 (neval 2^30 x 3)", *scalar(res_v), np.pi / 4, 7)
    import jax.numpy as jnp
    res = integrate(lambda x, c: jnp.log(x[0]) / jnp.sqrt(x[0]),
                    solver="vegasplus", var=Continuous(0.0, 1.0), dof=[[1]],
                    neval=VPLUS_NEVAL, verbose=-2, seed=7)
    check_backend("vegasplus log(x)/sqrt(x)", res, "xla")
    check_ks("vegasplus log(x)/sqrt(x) (neval 1e8)", *scalar(res), -4.0, 7)
    res = bubble("mcmc", BUBBLE_NEVAL)
    check_backend("mcmc bubble", res, "xla")
    check_bubble("mcmc bubble", res, 10)
    say(f"  phase 2 wall {time.perf_counter() - t0:.1f} s")

    say(f"[phase 3] fused kernels against the plain XLA path "
        f"(block={CMP_BLOCK}) | {card}")
    for solver, neval, niter in (("vegasmc", PI_NEVAL, 5),
                                 ("vegas", VEGAS_NEVAL, 3)):
        rk = pi_run(integrate, Continuous, solver, neval, niter,
                    block=CMP_BLOCK, seed=21)
        rk2 = pi_run(integrate, Continuous, solver, neval, niter,
                     block=CMP_BLOCK, seed=21)
        rx = pi_run(integrate, Continuous, solver, neval, niter,
                    block=CMP_BLOCK, seed=21, backend="xla")
        check_backend(f"{solver} kernel", rk, "pallas")
        check_backend(f"{solver} reference", rx, "xla", "requested")
        compare(f"{solver} pi/4", rk, rx)
        same = same_bits(rk, rk2)
        say(f"  {solver} kernel, same seed twice: "
            f"{'bit-identical' if same else 'DIFFERENT'} (means, error "
            "bars, trained grids)")
        if not same:
            fail(f"{solver} kernel is not reproducible for a fixed seed")

    phase_timing(card)
    phase_e2e_timing(integrate, Continuous, card)


def four_cards(card):
    from mcintegration import Continuous, integrate, make_mesh

    mesh = make_mesh(4)
    say(f"[phase 5] 4-card mesh against one card | {card}")
    for solver, neval, niter in (("vegas", VEGAS_NEVAL, 3),
                                 ("vegasmc", PI_NEVAL, 5)):
        for backend in ("pallas", "xla"):
            t0 = time.perf_counter()
            r4 = pi_run(integrate, Continuous, solver, neval, niter,
                        mesh=mesh, backend=backend, seed=31)
            t4 = time.perf_counter() - t0
            t0 = time.perf_counter()
            r1 = pi_run(integrate, Continuous, solver, neval, niter,
                        parallel="none", backend=backend, seed=31)
            t1 = time.perf_counter() - t0
            check_backend(f"{solver} {backend} 4 cards", r4, backend)
            check_backend(f"{solver} {backend} 1 card", r1, backend)
            (m4, s4), (m1, s1) = scalar(r4), scalar(r1)
            say(f"  {solver} {backend}: 4 cards {m4:.9g} +- {s4:.3g} "
                f"({t4:.2f} s cold) | 1 card {m1:.9g} +- {s1:.3g} "
                f"({t1:.2f} s cold)")
            check_ks(f"{solver} {backend} 4 cards", m4, s4, np.pi / 4, 10)
            if solver == "vegas":
                same = same_bits(r4, r1)
                say(f"  {solver} {backend}: 1 vs 4 cards "
                    f"{'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    fail(f"{solver} {backend} differs between 1 and 4 cards")
            else:
                d = abs(m4 - m1) / np.hypot(s4, s1)
                say(f"  {solver} {backend}: 1 vs 4 cards differ by "
                    f"{d:.2f} sigma (limit 10)")
                if not d < 10:
                    fail(f"{solver} {backend}: 1 and 4 cards disagree")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "mcintegration")):
        fail("run chip_smoke.py from a checkout of the repository")
    if args.cards == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, HERE)
    from mcintegration.platform import configure_jax

    configure_jax(HERE)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX runs on '{devs[0].platform}'")
    if len(devs) < args.cards:
        fail(f"{args.cards} cards requested, {len(devs)} visible")
    card = card_line()
    say(f"[phase 0] card: {card} | device_kind {devs[0].device_kind} | "
        f"{len(devs)} visible | jax {jax.__version__}")
    t0 = time.perf_counter()
    if args.cards == 4:
        four_cards(card)
    else:
        one_card(card)
    say(f"total {time.perf_counter() - t0:.1f} s")
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
