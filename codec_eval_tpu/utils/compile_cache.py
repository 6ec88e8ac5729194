"""One place that decides where JAX's persistent compilation cache lives.

The metric pipelines compile one large program per image shape and batch
size; a persistent cache turns every later process's compile of the same
program into a load.  The default directory sits at the root of a source
checkout; an installed package should set ``JAX_COMPILATION_CACHE_DIR``.
"""

from __future__ import annotations

import os
from pathlib import Path

#: Fixed cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: ``.jax_cache/`` at the root of the source checkout this module sits in
#: (listed in ``.gitignore``).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``DEFAULT_CACHE_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
