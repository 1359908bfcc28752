"""JAX configuration helpers: platform, compile cache, x64."""

from __future__ import annotations

import os

__all__ = ["device_platform", "ensure_x64", "enable_compilation_cache",
           "compilation_cache_dir"]

_PLATFORMS = ("cpu", "gpu")


def device_platform(device=None) -> str:
    """Platform ('cpu' or 'gpu') of ``device``, or of the device that
    jitted work lands on by default (``jax_default_device`` when set,
    else the default backend).  Any other platform raises ValueError:
    the package runs on NVIDIA GPUs and on the CPU backend only."""
    if device is None:
        import jax

        device = jax.config.jax_default_device
        plat = (device.platform if device is not None
                else jax.default_backend())
    else:
        plat = device.platform
    if plat not in _PLATFORMS:
        raise ValueError(f"unsupported JAX platform {plat!r}; "
                         f"expected one of {_PLATFORMS}")
    return plat


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path, so the cache key stays stable across runs)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compilation_cache() -> None:
    """Enable the persistent XLA compilation cache.

    Level-scheduled programs are matrix-specific and compile once per
    pattern; caching them on disk makes repeated factorizations of the
    same pattern (the reference's akeep-reuse workflow) start instantly
    across processes.
    """
    import jax

    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def ensure_x64() -> None:
    """Enable 64-bit types.

    jax defaults to 32-bit unless ``jax_enable_x64`` is set; when a user
    asks for a float64 factorization we must not silently truncate
    (the reference is a double-precision solver).
    """
    import jax

    jax.config.update("jax_enable_x64", True)
