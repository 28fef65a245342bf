"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Optional

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    path is set here. Otherwise the cache goes to the fixed
    ``<checkout>/.benchdata/jaxcache``: the directory is part of the
    cache's key, so a path that moved between runs would never hit. Where
    that directory cannot be created (a read-only install), the program
    runs without a persistent cache, says so once on stderr, and returns
    None.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    cache = CHECKOUT / ".benchdata" / "jaxcache"
    try:
        cache.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        print(f"tsq: warning: no persistent compile cache ({e})",
              file=sys.stderr)
        return None
    jax.config.update("jax_compilation_cache_dir", str(cache))
    return str(cache)
