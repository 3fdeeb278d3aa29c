"""Entry-point set-up (mcintegration/platform.py): where the persistent
compilation cache goes."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
sys.path.insert(0, {repo!r})
from mcintegration.platform import configure_jax
configure_jax({root!r})
import jax
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's own to read and the
    code sets no other directory; otherwise the cache goes to the fixed
    ``.jax_cache`` inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    root = str(tmp_path / "checkout")
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO, root=root)],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    got = out.stdout.strip().splitlines()[-1]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(root, ".jax_cache"))
    assert got == want


def test_cache_dir_is_ignored():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored
