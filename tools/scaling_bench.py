"""Multi-device / multi-host scaling-efficiency harness.

BASELINE.md asks for >=80% weak-scaling efficiency at 2+ hosts.  This
harness measures it: every device gets an identical per-device workload
(channels x seconds of synthetic 6 kHz audio through the sharded
band-power + adaptive-detection pipeline), so perfect scaling keeps the
per-step wall time flat as devices are added and aggregate samples/s
grows linearly.  Efficiency(N) = t(1 device) / t(N devices).

Run modes:

* single host, all local devices (the default) — on this box:
  ``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/scaling_bench.py --devices 1 2 4 8``
* multi-host: launch one copy per host with
  ``--coordinator host0:1234 --num-processes N --process-id i``
  (or the JAX_* env equivalents); every process must pass the same
  arguments.  Only process 0 prints.

Output: one JSON line per mesh size with aggregate samples/s and
efficiency vs the smallest measured mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


FS = 6000
BLOCK = 1200
N_FFT = 1024
FREQ_BAND = (993.0, 1013.0)
NOISE_BAND = (690.0, 710.0)
WINDOW_BLOCKS = 600
FREEZE_BEFORE, FREEZE_AFTER, FIXED_INIT = 15, 100, 50


def per_device_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / FS
    for s in np.arange(5.0, seconds - 2.0, 37.0):
        m = (t >= s) & (t < s + 1.0)
        x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    return x


def run_mesh(n_devices: int, seconds_per_device: float, window_blocks: int,
             reps: int = 2, chain: int = 6) -> float:
    """Weak-scaling step time on an n_devices (station=1, time=n) mesh.

    Stations are embarrassingly parallel; the time axis is the interesting
    one (halo exchanges + threshold history), so the harness scales it.
    Returns seconds per step.
    """
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import (
        sharded_delta_power,
        sharded_detect_adaptive,
    )

    mesh = make_mesh(n_station=1, n_time=n_devices, devices=jax.devices()[:n_devices])
    n_samples = int(FS * seconds_per_device) // BLOCK * BLOCK * n_devices
    x = np.concatenate(
        [per_device_audio(seconds_per_device, seed=10 + d) for d in range(n_devices)]
    )[:n_samples][None, :]

    def step(xin):
        band, noise, delta = sharded_delta_power(
            xin, mesh, FS, N_FFT, BLOCK, FREQ_BAND, NOISE_BAND
        )
        thr, above = sharded_detect_adaptive(
            delta,
            mesh,
            threshold_std_factor=4.0,
            window_blocks=window_blocks,
            freeze_blocks_before=FREEZE_BEFORE,
            freeze_blocks_after=FREEZE_AFTER,
            fixed_threshold_blocks=FIXED_INIT,
        )
        return above.sum()

    xj = jnp.asarray(x)

    # chain the k iterations INSIDE one jit via fori_loop with a carry-
    # derived data dependency, so the step time excludes per-call host
    # dispatch).  The dependency threads
    # through the input (x + eps) because this pipeline exposes no small
    # side table; the residual re-materialization term is constant per
    # device, so it cancels in the weak-scaling efficiency ratio this tool
    # publishes.
    @jax.jit
    def runk(xin, k):
        def body(_, carry):
            eps = jnp.where(jnp.isnan(carry), 1.0, 0.0).astype(xin.dtype)
            return step(xin + eps).astype(jnp.float32)

        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    np.asarray(runk(xj, 1))  # compile + warm

    def chained(k):
        t0 = time.perf_counter()
        np.asarray(runk(xj, k))
        return time.perf_counter() - t0

    t1 = min(chained(1) for _ in range(reps))
    tk = min(chained(chain) for _ in range(reps))
    return max((tk - t1) / (chain - 1), 1e-9), n_samples


def run_mesh_stations(
    n_devices: int, seconds: float, stations_per_device: int = 8,
    reps: int = 2, chain: int = 6,
):
    """Weak-scaling step time for the BASELINE config-5 streaming path
    (VERDICT r4 item 7): ``sharded_stream_process`` with PRE-BLOCKED input
    — the code a multi-card deployment runs.  Stations scale with the mesh
    (stations_per_device per device, station-axis sharding).  Solver/front
    resolve via ``"auto"`` to the platform defaults (`platform.py`): the
    GPU's measured default on the cards, the reference scan on CPU
    validation meshes (sharded kernel == scan is pinned in
    tests/test_parallel.py, so the CPU harness run validates the
    sharding/meshing, not the solver).  Returns (seconds per step, total
    samples per step)."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

    fs = 4000
    cfg = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    block = int(round(cfg.proc_block_sec * fs))
    C = stations_per_device * n_devices
    n = int(fs * seconds) // block * block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((C, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    for c in range(C):
        s0 = 15.0 + (5.0 * c) % max(seconds - 20.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x[c, m] += 1.5 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    # pre-blocked upload (host reshape is free; models/streaming.py::_blocked)
    xb = jnp.asarray(x.reshape(C, n // block, block))

    mesh = make_mesh(
        n_station=n_devices, n_time=1, devices=jax.devices()[:n_devices]
    )

    def step(xj):
        _, ev, _ = sharded_stream_process(
            cfg, None, xj, fs, mesh, front="auto", impl="auto"
        )
        return ev.count.sum()

    # in-graph fori_loop chain (see run_mesh for the methodology note)
    @jax.jit
    def runk(xin, k):
        def body(_, carry):
            eps = jnp.where(jnp.isnan(carry), 1.0, 0.0).astype(xin.dtype)
            return step(xin + eps).astype(jnp.float32)

        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    np.asarray(runk(xb, 1))  # compile + warm

    def chained(k):
        t0 = time.perf_counter()
        np.asarray(runk(xb, k))
        return time.perf_counter() - t0

    t1 = min(chained(1) for _ in range(reps))
    tk = min(chained(chain) for _ in range(reps))
    return max((tk - t1) / (chain - 1), 1e-9), C * n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="mesh sizes to measure (default: 1..all powers of 2)")
    p.add_argument("--seconds-per-device", type=float, default=600.0)
    p.add_argument("--window-blocks", type=int, default=WINDOW_BLOCKS,
                   help="adaptive rolling window; must be <= blocks per shard")
    p.add_argument("--pipeline", choices=("batch", "stations", "both"),
                   default="batch",
                   help="batch = time-sharded band power + adaptive detect; "
                        "stations = station-sharded streaming machine with "
                        "pre-blocked input + per-device fused groups")
    p.add_argument("--stations-per-device", type=int, default=8)
    p.add_argument("--stations-seconds", type=float, default=600.0,
                   help="stream length per station for --pipeline stations")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--chain", type=int, default=6,
                   help="chained steps per timing (lower for slow virtual-mesh validation runs)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    from meteor_scatter_tpu.parallel.distributed import init_multihost

    init_multihost(args.coordinator, args.num_processes, args.process_id)

    import jax


    total = jax.device_count()
    sizes = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= total]
    sizes = sorted(set(sizes))  # efficiency is defined vs the smallest mesh
    pipelines = (
        ("batch", "stations") if args.pipeline == "both" else (args.pipeline,)
    )
    any_multi = False
    for pipeline in pipelines:
        results = []
        t_base = None
        for n in sizes:
            if pipeline == "batch":
                dt, n_samples = run_mesh(
                    n, args.seconds_per_device, args.window_blocks,
                    reps=args.reps, chain=args.chain,
                )
            else:
                dt, n_samples = run_mesh_stations(
                    n, args.stations_seconds, args.stations_per_device,
                    reps=args.reps, chain=args.chain,
                )
            if t_base is None:
                t_base = dt
            eff = t_base / dt
            sps = n_samples / dt
            results.append({"pipeline": pipeline, "devices": n,
                            "sec_per_step": dt, "samples_per_sec": sps,
                            "weak_scaling_efficiency": round(eff, 4)})
            if jax.process_index() == 0:
                print(json.dumps(results[-1]))
        if jax.process_index() == 0 and len(results) > 1:
            any_multi = True
            worst = min(r["weak_scaling_efficiency"] for r in results[1:])
            print(f"# {pipeline}: worst weak-scaling efficiency: {worst:.1%} "
                  f"(target >= 80%)", file=sys.stderr)
    if jax.process_index() == 0 and any_multi and jax.default_backend() == "cpu":
        print("# NOTE: virtual CPU devices share physical cores — this run "
              "validates the harness, not scaling; measure on real chips",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
