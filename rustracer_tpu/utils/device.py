"""Where a run compiles and what it runs on.

Every entry point that compiles for the card (the CLI, `bench.py`,
`chip_smoke.py` and the timing tools) calls `configure_compile_cache()`
before its first jit. Every entry point that times the card calls
`require_gpu()`, so a run that finds no GPU stops instead of timing the
CPU, and labels its rates with `card_label()`.
"""
from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache(default_dir: str = DEFAULT_CACHE_DIR) -> str:
    """Keep JAX's persistent compile cache at a fixed directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this sets
    nothing; nor does it move a cache the process has already placed (the
    CLI called from a program that chose its own). Otherwise the cache goes
    to `default_dir`, a git-ignored directory inside the checkout: the path
    is part of the cache key, so it must not move between runs. Returns the
    directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    if jax.config.jax_compilation_cache_dir:
        return jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(what: str = "this run") -> dict:
    """Stop with a non-zero exit unless JAX's default backend is a GPU."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(f"{what} needs a GPU; JAX found "
                         f"{dev['platform']} ({dev['kind']})")
    return dev


def card_label() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())
