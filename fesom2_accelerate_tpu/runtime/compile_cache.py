"""JAX's persistent compilation cache for the entry-point scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and JAX
reads it itself; nothing else is set in code then.  Otherwise the cache
lives at a fixed directory inside the checkout (``.jax_cache/``, ignored by
git), so repeated runs from one checkout find their compiled programs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/fesom2_accelerate_tpu/runtime/compile_cache.py -> <checkout>
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the cache uses: the environment's, else the fixed
    in-checkout default."""
    return environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and return
    the directory.  With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already
    uses it, so the config is left alone."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
