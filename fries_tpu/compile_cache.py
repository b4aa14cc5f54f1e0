"""Where XLA's persistent compilation cache lives.

Every entry point (the CLI, ``bench.py``, ``bench_matrix.py``'s children,
``chip_smoke.py``) calls :func:`enable` before it compiles anything, so a
step compiled once is found again by the next process on the same machine.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable() -> str:
    """Turn on the persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when that is set, else
    ``<checkout>/.jax_cache``."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
