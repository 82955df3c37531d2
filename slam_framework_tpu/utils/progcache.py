"""Process-wide shared cache of jitted programs.

Each pipeline object (tracker, mapper, loop closer, …) builds its jitted
programs from bound methods: `jax.jit(self._chunk)`. JAX's in-memory
executable cache is keyed on the jitted *callable object*, so a second
SlamSystem in the same process (bench warm-lap → timed-lap, map resets, A/B
sweeps, multi-sequence serving) recompiles — or, with the persistent cache,
deserializes every heavy program again.

The programs themselves depend only on the *configuration* (SlamConfig /
derived constants), never on mutable instance state — every mutable input is
an explicit array argument. So identical-config instances can share one jitted
callable: the first instance builds it (closing over its own config-derived
attributes), later instances reuse it. The closed-over instance skeleton stays
alive inside the cache — a few KB of config, no device arrays.

Opt out (debug / config objects that lie about equality) with
SLAM_NO_SHARED_JIT=1.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

_CACHE: Dict[Tuple, Any] = {}


def _enabled() -> bool:
    return not os.environ.get("SLAM_NO_SHARED_JIT")


def config_fingerprint(cfg: Any) -> str:
    """Stable fingerprint of a (nested dataclass) config."""
    return repr(cfg)


def shared_jit(key: Tuple, make: Callable[[], Any]) -> Any:
    """Return the cached jitted callable for `key`, building it with `make()`
    on first use. `key` must capture everything the program's behavior depends
    on (program name + config fingerprint)."""
    if not _enabled():
        return make()
    fn = _CACHE.get(key)
    if fn is None:
        fn = make()
        _CACHE[key] = fn
    return fn


def clear() -> None:
    _CACHE.clear()
