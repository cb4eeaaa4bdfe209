"""Device-mesh construction.

The reference's parallelism is a thread pool sized by a CLI arg
(``ThreadPool.cpp:38``, ``Application.cpp:79``); the device-side
equivalent is a ``jax.sharding.Mesh`` whose data axis streams nanopore
read batches across chips (SURVEY.md §2.5 mapping table).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "reads",
              devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: `jax.distributed.initialize` with env-var
    autodetection (SURVEY.md §5 "distributed communication backend").
    No-op when already initialised or running single-process."""
    import os

    coordinator = coordinator or os.environ.get("MS_TPU_COORDINATOR")
    if coordinator is None and num_processes is None:
        return  # single host
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialised
