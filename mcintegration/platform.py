"""Process set-up for the repository's entry points (scripts, examples,
benchmarks); the library itself configures nothing.

- Persistent compilation cache: JAX reads ``JAX_COMPILATION_CACHE_DIR``
  itself when it is set; otherwise the cache goes to a fixed directory
  inside the checkout (``.jax_cache``, git-ignored), so repeated runs of
  the same shapes skip compilation.
- ``MCI_CPU_DEVICES=N``: N virtual CPU devices, for mesh runs on a host
  without accelerators (honoured only when JAX runs on the CPU).
"""

import os

CACHE_DIR_NAME = ".jax_cache"


def configure_jax(root: str) -> None:
    """Apply the entry-point settings; ``root`` is the checkout directory.
    Call before the first JAX computation."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(os.path.abspath(root), CACHE_DIR_NAME))
    ndev = os.environ.get("MCI_CPU_DEVICES")
    if ndev:
        jax.config.update("jax_num_cpu_devices", int(ndev))
