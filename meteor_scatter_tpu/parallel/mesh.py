"""Mesh construction helpers for the (station, time) layout."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

STATION_AXIS = "station"
TIME_AXIS = "time"


def make_mesh(
    n_station: int = 1,
    n_time: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (station, time) mesh.  With ``n_time=None`` the time axis
    absorbs all remaining devices.  The shape follows the algorithm alone:
    stations never communicate until event merge, and time shards trade
    halos with their neighbours only.  The four cards of one host are
    joined all to all by NVLink, so any device order gives every pair the
    same link and no placement is preferred."""
    devices = list(devices if devices is not None else jax.devices())
    if n_time is None:
        if len(devices) % n_station:
            raise ValueError(f"{len(devices)} devices not divisible by n_station={n_station}")
        n_time = len(devices) // n_station
    use = n_station * n_time
    grid = np.asarray(devices[:use]).reshape(n_station, n_time)
    return Mesh(grid, (STATION_AXIS, TIME_AXIS))


def station_time_specs():
    """(in_spec, out_spec) for (channels, samples)-shaped arrays."""
    return P(STATION_AXIS, TIME_AXIS)
