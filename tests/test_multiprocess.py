"""Multi-process distributed tests.

Analog of the reference's self-spawned `mpiexec -n 2` test (test/mpi.jl:4-12
+ test/mpi_test.jl:73-146): spawns two local processes that join a
jax.distributed cluster (CPU backend, 2 virtual devices each => a 4-device
global mesh), run the same sharded integrations, and must produce

1. the identical, accurate Result on every process (no root/worker
   asymmetry — the psum replaces MPIreduce+MPIbcast);
2. a Result that is BIT-FOR-BIT equal to the same-seed single-process run
   on a 4-device local mesh (:vegas — per-block obs are computed on the
   owning device from counter-based per-block keys, so the distribution of
   blocks over processes cannot change any bit);
3. field-by-field equal reduced statistics (visited, propose/accept
   tallies, per-leaf histograms — the fields the reference's
   MPIreduceConfig! sums, configuration.jl:264-299) between the 2-process
   and single-process runs of a :vegasmc integration.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

COMMON = r"""
import numpy as np
import jax.numpy as jnp
from mcintegration import Continuous, integrate
from mcintegration.parallel.mesh import make_mesh


def run_vegas(mesh):
    return integrate(
        lambda x, c: jnp.where(x[0]**2 + x[1]**2 < 1.0, 1.0, 0.0),
        var=Continuous(0.0, 1.0), dof=[[2]], neval=4e4, niter=3,
        block=8, solver="vegas", mesh=mesh, verbose=-2, seed=99)


def run_vegasmc(mesh):
    return integrate(
        lambda x, c: jnp.where(x[0]**2 + x[1]**2 < 1.0, 1.0, 0.0),
        var=Continuous(0.0, 1.0), dof=[[2]], neval=4e4, niter=2,
        block=8, solver="vegasmc", mesh=mesh, verbose=-2, seed=7,
        nwalkers=64, min_steps_per_walker=8)


def run_vegas_fused(mesh):
    # the fused Triton :vegas kernel (interpret mode on CPU), sharded over
    # the SAME global mesh: shard_map of a Pallas kernel whose per-block
    # outputs cross a real process boundary
    return integrate(
        lambda x, c: jnp.where(x[0]**2 + x[1]**2 < 1.0, 1.0, 0.0),
        var=Continuous(0.0, 1.0), dof=[[2]], neval=2e4, niter=1,
        block=8, solver="vegas", backend="pallas", mesh=mesh,
        verbose=-2, seed=41)


def emit(tag, res):
    m = float(np.asarray(res.mean[0]))
    e = float(np.asarray(res.stdev[0]))
    cfg = res.config
    vis = " ".join(repr(float(v)) for v in cfg.visited)
    pa = f"{float(cfg.propose.sum())!r} {float(cfg.accept.sum())!r}"
    hists = " ".join(repr(float(np.asarray(l.histogram, np.float64).sum()))
                     for _, l in cfg.var_leaves())
    print(f"{tag} mean {m.hex()} {e.hex()}", flush=True)
    print(f"{tag} fields {vis} | {pa} | {hists}", flush=True)
    print(f"{tag} backend {res.backend}", flush=True)
"""

WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
sys.path.insert(0, os.environ["MCI_REPO"])
import numpy as np

assert len(jax.devices()) == 4, jax.devices()
exec(open(os.environ["MCI_COMMON"]).read())

mesh = make_mesh()
res = run_vegas(mesh)
m = float(np.asarray(res.mean[0]))
e = float(np.asarray(res.stdev[0]))
assert abs(m - np.pi / 4) < 7 * max(e, 1e-12), (m, e)
emit("VEGAS", res)
emit("VEGASMC", run_vegasmc(mesh))
emit("VEGASF", run_vegas_fused(mesh))
"""

SINGLE = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
sys.path.insert(0, os.environ["MCI_REPO"])
import numpy as np

assert len(jax.devices()) == 4
exec(open(os.environ["MCI_COMMON"]).read())

mesh = make_mesh(4)
emit("VEGAS", run_vegas(mesh))
emit("VEGASMC", run_vegasmc(mesh))
emit("VEGASF", run_vegas_fused(mesh))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _lines(out, tag):
    return [l for l in out.splitlines() if l.startswith(tag)]


# hang protection is the communicate(timeout=240) below — every child is a
# subprocess, so the parent never blocks before reaching it (pytest-timeout
# is not installed; a bare @pytest.mark.timeout would be a silent no-op)
def test_two_process_distributed(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    common = tmp_path / "common.py"
    common.write_text(COMMON)
    single = tmp_path / "single.py"
    single.write_text(SINGLE)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["MCI_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["MCI_COMMON"] = str(common)
    procs = [
        subprocess.Popen([sys.executable, str(script), coord, str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for i in range(2)
    ]
    # the single-process 4-device run of the SAME configs, in parallel
    sp = subprocess.Popen([sys.executable, str(single)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          env=env, text=True)
    outs = []
    for p in procs + [sp]:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs + [sp], outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"

    # VEGASF = the fused Pallas :vegas kernel under shard_map across the
    # REAL process boundary (round-5: previously the fused kernels were
    # only ever exercised on single-process virtual meshes)
    for tag in ("VEGAS", "VEGASMC", "VEGASF"):
        # 1) both ranks report the identical Result and identical reduced
        #    fields (mpi_test.jl:73-146 analog: every reduced+broadcast
        #    field agrees across ranks)
        assert _lines(outs[0], tag) == _lines(outs[1], tag), tag

        # 2) the 2-process run equals the single-process 4-device run
        #    BIT-FOR-BIT: mean/stderr hex-exact (counter-based per-block
        #    RNG makes block placement irrelevant)
        [mean2] = _lines(outs[0], f"{tag} mean")
        [mean1] = _lines(outs[2], f"{tag} mean")
        assert mean2 == mean1, (tag, mean2, mean1)

        # 3) field-by-field: visited / propose+accept sums / per-leaf
        #    histogram sums agree exactly (counts) — the fields
        #    MPIreduceConfig! reduces (configuration.jl:264-299)
        [f2] = _lines(outs[0], f"{tag} fields")
        [f1] = _lines(outs[2], f"{tag} fields")
        assert f2 == f1, (tag, f2, f1)

    # the fused path must actually have engaged (not silently XLA)
    for out in outs:
        assert _lines(out, "VEGASF backend") == ["VEGASF backend pallas"]
