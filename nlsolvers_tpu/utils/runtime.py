"""Process-level runtime settings shared by the entry points (bench.py,
chip_smoke.py, __graft_entry__.py, the datagen CLI)."""

import os
import subprocess
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "REPO_CACHE_DIR", "card_lines"]

# Fixed path inside the checkout (listed in .gitignore): the cache directory
# is part of what a later process must find again, so it is never made from
# a temp name, a pid or the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and no
    other cache is set here. Otherwise the cache is <repo>/.jax_cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


def card_lines():
    """`name, power.limit` of every GPU as nvidia-smi reports them (one line
    per card); an empty list where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
