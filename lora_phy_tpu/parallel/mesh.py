"""Device-mesh construction for multi-channel / streaming demodulation.

The reference is single-threaded scalar C++ with no parallel axes
(SURVEY.md §2.6); the scale-out axes are:

* ``channel`` — independent radio channels (embarrassingly parallel)
* ``time``   — consecutive blocks of one continuous stream, with
               overlap-save halo exchange between neighbouring shards
               (SURVEY.md §5.7a / §5.8)

Frames batch along a plain leading array dim inside each shard (vmap-style
data parallelism; no collectives needed).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_mesh(n_channel: int | None = None, n_time: int | None = None,
              devices=None) -> Mesh:
    """Build a ``(channel, time)`` mesh over the available devices.

    Defaults: all devices on the channel axis (the common multi-channel
    receiver layout); pass ``n_time`` to carve a streaming axis.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if n_channel is None and n_time is None:
        n_channel, n_time = total, 1
    elif n_channel is None:
        n_channel = total // n_time
    elif n_time is None:
        n_time = total // n_channel
    if n_channel * n_time != total:
        raise ValueError(
            f"mesh {n_channel}x{n_time} != {total} devices"
        )
    return Mesh(devices.reshape(n_channel, n_time), (CHANNEL_AXIS, TIME_AXIS))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """[channels, ...] arrays sharded along the channel axis."""
    return NamedSharding(mesh, P(CHANNEL_AXIS))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """[channels, samples] arrays sharded channel x time."""
    return NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
