"""Visual SLAM engine in JAX / XLA.

A brand-new implementation of the capabilities of the reference C++ ORB-SLAM2-style
framework (ThorsteinnJonsson/SLAM_framework, see SURVEY.md): ORB front-end, descriptor
matching, bag-of-words place recognition, motion-only / local / global bundle adjustment
and Sim3 pose-graph optimization — all as batched, fixed-shape JAX programs for an
accelerator, with multi-device scaling via jax.sharding meshes.

Design stance (SURVEY.md §7): the map is arrays + fixed capacities + masks, not a pointer
graph; "threads" are pipeline stages; RANSAC is batched hypotheses, not sequential loops.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compile_cache_dir() -> str | None:
    """Directory this package sets for JAX's persistent compilation cache.

    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself) or when
    SLAM_NO_COMPILE_CACHE opts out. Otherwise a fixed directory inside the
    checkout, which stays put between runs, so a second process finds what
    the first compiled."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.environ.get(
        "SLAM_NO_COMPILE_CACHE"
    ):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
    )


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
if not _os.environ.get("SLAM_NO_COMPILE_CACHE"):
    # cache every program, however quick to compile, so a warm process
    # compiles nothing a previous one already did
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from slam_framework_tpu.config import SlamConfig, CameraConfig, OrbConfig  # noqa: F401
