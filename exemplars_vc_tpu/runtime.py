"""Process-level runtime: the persistent compilation cache and the record of
the device a measurement ran on.

The cache keeps compiled executables on disk, so a second process (or a
second run of the CLI) skips the compiles a first one paid for. JAX reads
``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this module sets
nothing. Otherwise the cache lives at one fixed path inside the checkout,
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
what makes a later process find the entries again, so it never depends on a
temporary name, a pid or the time.
"""

from __future__ import annotations

import os
import subprocess

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_persistent_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Every pipeline entry point (CLI, bench scripts, ``chip_smoke.py``) calls
    this before first device use. Idempotent."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def device_record() -> dict:
    """The device a measurement runs on, as JAX reports it, plus the card's
    name and power limit: every benchmark result carries this."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "name_power_limit": gpu_name_and_power_limit()}


def require_gpu() -> None:
    """Fail unless JAX's default devices are GPUs: a measurement path that
    finds no GPU stops, it does not carry on on the CPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is {platform!r}")
