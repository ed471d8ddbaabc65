"""Multi-host scale-out scaffolding.

The reference has no distributed layer at all (SURVEY.md §2.6/§5.8). The
recipe: every host runs the same program, ``jax.distributed`` wires the
hosts into one runtime, the global ``(channel, time)`` mesh spans all
devices, and per-host ingest feeds globally-sharded arrays via
``jax.make_array_from_process_local_data``. The streaming demodulator
(parallel/stream.py) is already written against the mesh axes, so the
same code runs on one device, one host and N hosts unchanged.

The path is exercised by the CPU virtual mesh and two CPU processes
(tests/test_parallel.py, tests/test_multihost.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import CHANNEL_AXIS, TIME_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host runtime (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_stream_array(mesh, local_block: np.ndarray):
    """Assemble the global [channels, T] stream array from each process's
    local time block (hosts ingest consecutive stream segments)."""
    sharding = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
    return jax.make_array_from_process_local_data(sharding, local_block)


def scaling_report(samples_per_s_1chip: float, samples_per_s_n: float,
                   n_devices: int) -> dict:
    """Scaling-efficiency record (north-star metric: >= 90%)."""
    ideal = samples_per_s_1chip * n_devices
    return {
        "devices": n_devices,
        "samples_per_s": samples_per_s_n,
        "ideal_samples_per_s": ideal,
        "efficiency": samples_per_s_n / ideal if ideal else 0.0,
    }
