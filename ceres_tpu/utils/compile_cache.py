"""Where the persistent XLA compilation cache lives.

One rule for every entry point that turns the cache on (``bench.py``,
``chip_smoke.py``, the device tier of the tests): ``JAX_COMPILATION_CACHE_DIR``
when it is set, otherwise ``<checkout>/.jax_cache`` (listed in
``.gitignore``). A fixed path matters: the path is part of the cache key,
so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
