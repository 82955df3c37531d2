"""Multi-host (multi-process) execution layer for the distributed optimizers.

The reference is a single-process C++ system (its "communication fabric" is
mutexes, SURVEY.md §2.3); SURVEY §5.8 / BASELINE.md mandate a multi-HOST story
for this engine. On a real cluster each host drives its local devices and JAX's
distributed runtime links the processes — collectives run over the in-host
interconnect and the network between hosts. This
module is the process-level glue:

  - `initialize()` — one call per process; wires the JAX distributed runtime
    (coordination service + cross-process collectives). After it returns,
    `jax.devices()` is the GLOBAL device list and every shard_map program in
    `parallel/dist_ba.py` / `parallel/dist_pose_graph.py` runs unchanged as a
    true multi-process SPMD program.
  - `place()` — builds global jax.Arrays from host (replicated) numpy values
    for a mesh that may span non-addressable devices. `jax.device_put` only
    handles process-local placement; `jax.make_array_from_callback` hands each
    process exactly its addressable shards.
  - `replicated_get()` — reads back a replicated output through the local
    shard (fetching a global array directly raises in multi-process JAX).

Validated end-to-end by `tools/multihost_demo.py`, which spawns N real
processes on this host (CPU backend, Gloo collectives) and checks the
distributed results against the single-process optimizers bit-for-purpose.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    platform: str = "cpu",
) -> None:
    """Initialize this process's slice of the global runtime.

    Must run before any JAX backend use. `local_device_count` forces N virtual
    CPU devices per process (test/demo mode); on real accelerator hosts leave
    it None and the runtime reports the local devices.
    """
    if local_device_count is not None and platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax

    if platform:
        jax.config.update("jax_platform_name", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multiprocess(mesh) -> bool:
    """True when `mesh` spans devices owned by more than one process."""
    procs = {d.process_index for d in mesh.devices.flat}
    return len(procs) > 1


def place(value: Any, sharding) -> Any:
    """Build a global jax.Array for `sharding` from a host value every process
    holds identically (the shard/partition layout is deterministic host code,
    so each process computes the same full array and contributes only its
    addressable shards)."""
    import jax

    a = np.asarray(value)
    return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])


def place_tree(tree: Any, shardings: Any) -> Any:
    """`place` over a pytree of (value, sharding) pairs (same structure)."""
    import jax

    return jax.tree.map(place, tree, shardings)


def replicated_get(garr) -> np.ndarray:
    """Host value of a replicated-output global array via the local shard."""
    return np.asarray(garr.addressable_data(0))


def shard_get(garr, mesh) -> np.ndarray:
    """Host value of an axis-0-sharded global array: concatenate the shards
    this process owns in device order, for result assembly by process 0 after
    a `process_allgather`-style exchange (demo/tests exchange via the caller).
    """
    shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
