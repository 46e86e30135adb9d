"""Multi-host runtime: initialization, heartbeat failure detection, and
resumable deployment glue.

The reference's "multi-node" story is two Docker containers sharing a CSV
bind mount with `--restart=always` supervision (SURVEY.md §5).  At pod
scale the equivalents are:

* ``init_multihost``     — `jax.distributed.initialize` wrapper driven by
  env vars or arguments; no-op for single-process runs;
* ``Heartbeat``          — a tiny collective liveness check: every host
  contributes 1 to a psum at a cadence; a timeout/short-count means lost
  hosts, and the supervisor restarts from the last flushed ledger hour
  (the CSV ledger + journal in io/ledger.py is the checkpoint);
* ``host_shard_info``    — which (station, time) ranges this host owns.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime when multi-host settings are
    present (args or JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID env).  Returns True when distributed mode is active."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if not coordinator_address or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


@dataclass
class HostShard:
    """This host's slice of the global (station, time) work."""

    process_id: int
    num_processes: int
    station_range: Tuple[int, int]
    local_devices: int


def host_shard_info(n_stations: int) -> HostShard:
    """Contiguous station assignment across hosts (stations are the
    embarrassingly parallel axis; time sharding stays among one host's
    cards, joined all to all by NVLink, so halos never cross the slower
    host-to-host network unless stations < hosts)."""
    import jax

    pid = jax.process_index()
    n_proc = jax.process_count()
    per = -(-n_stations // n_proc)
    lo = min(pid * per, n_stations)
    hi = min(lo + per, n_stations)
    return HostShard(
        process_id=pid,
        num_processes=n_proc,
        station_range=(lo, hi),
        local_devices=jax.local_device_count(),
    )


class Heartbeat:
    """Collective liveness probe.

    ``beat()`` runs a psum of ones over all devices; the result equals the
    expected device count iff every host participated.  A hung host
    surfaces as a timeout (the collective never completes), which the
    caller's watchdog converts into a restart — matching the reference's
    supervision tiers (`prime_watchdog.sh`, Docker --restart=always) at
    cluster scale.
    """

    def __init__(self, interval_sec: float = 60.0):
        self.interval = interval_sec
        self.last_beat = 0.0
        self.beats = 0

    def due(self) -> bool:
        return time.monotonic() - self.last_beat >= self.interval

    def beat(self) -> int:
        import jax
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import Mesh, PartitionSpec as P

        n = jax.device_count()
        mesh = Mesh(np.asarray(jax.devices()), ("d",))
        ones = jnp.ones(n)
        fn = jax.shard_map(
            lambda x: jax.lax.psum(jnp.sum(x), "d") * jnp.ones(1),
            mesh=mesh,
            in_specs=P("d"),
            out_specs=P("d"),
        )
        total = fn(jax.device_put(ones, jax.sharding.NamedSharding(mesh, P("d"))))
        self.last_beat = time.monotonic()
        self.beats += 1
        return int(np.asarray(total)[0])

    def check(self) -> bool:
        """True iff all expected devices answered."""
        import jax

        return self.beat() == jax.device_count()
