"""Multi-host runtime initialization (meshes that cross hosts).

Wraps ``jax.distributed.initialize`` (SURVEY.md §5.8 build equivalent):
on a multi-host cluster every host calls :func:`initialize_multihost`
before any backend use; mesh construction then spans all hosts' devices
so the named-axis collectives (``ppermute`` halos, ``all_to_all``
reshard, ``psum`` metric reductions) run within a host over its
device links (NVLink on a GPU host) and across hosts over the network.

Single-process environments (CI, one host with one or four cards) are a
no-op — call sites never need to branch.
"""

from __future__ import annotations

import os

import jax


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the JAX distributed runtime when multi-process.

    Arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  Nothing discovers a cluster on its own: a
    multi-process run passes all three.

    Returns True when a multi-process runtime was initialized, False for
    the single-process no-op.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process — nothing to do

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh_axes(time_parallel: int = 1) -> dict[str, int]:
    """Suggested mesh axes for the current device population.

    Puts ``time_parallel`` devices on the sequence-parallel axis and the
    rest on the data axis.  Cards on one host are joined all to all, so
    the split follows the algorithm, not a link topology.
    """
    total = len(jax.devices())
    if total % time_parallel:
        raise ValueError(
            f"time_parallel={time_parallel} must divide device count {total}."
        )
    return {"data": total // time_parallel, "time": time_parallel}
