"""Time the detection chain's solvers and fronts on the current device.

Solver choice per platform (`meteor_scatter_tpu/platform.py`) rests on
these numbers.  Each formulation runs on data already on the device, is
compiled and checked once, then timed over ``--reps`` calls that each end
in ``block_until_ready``; the median and the minimum are printed in ms.
The solvers of one cell are timed interleaved: all of them in one order,
then all in the reverse order.

Streaming (BASELINE config 5 sizes, 4 kHz, 0.2 s blocks):
  * 64 stations x 600 s, 1 station x 1 h, and 64 stations x 600 s with a
    burst every 20 s instead of every 97 s (the episode solvers' cost
    follows the number of bursts);
  * the Triton kernel (``stream_scan_fused_batch``) at several launch
    shapes, vmapped ``stream_scan`` at several unroll factors,
    ``stream_scan_jump`` and ``stream_scan_jump_batch``;
  * every variant's event lists are compared with the unroll-1 scan;
  * the default kernel path split into its XLA prologue (base
    thresholds), the kernel alone and its XLA epilogue (compaction);
  * the welch and bins fronts on the 64-station audio, and their largest
    over-noise difference in dB.
Batch (BASELINE config 1, 6 kHz):
  * the band-power projection over 1 h (achieved GB/s of input read);
  * ``adaptive_thresholds_parallel`` + ``events_from_mask`` at 1 h
    (18,000 blocks) and 24 h (432,000 blocks).

Usage::

    python tools/solver_timing.py [--quick] [--reps N] [--out FILE]

``--quick`` compiles and checks every formulation at full width once and
times nothing.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.stdout.strip() or out.stderr.strip()


def timed(fn, args, reps):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    res = {"first_call_s": first}
    if reps:
        res.update(stats(sample(fn, args, reps)))
    return out, res


def sample(fn, args, reps):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def stats(ts):
    return {"median_ms": float(np.median(ts)) * 1e3, "min_ms": min(ts) * 1e3,
            "reps": len(ts)}


def interleaved(fns, args, reps):
    """Time every function in two passes, forward then reversed (ABBA), so
    a drift of the card's clock or temperature falls on all alike."""
    ts = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            ts[k] += sample(fns[k], args, reps)
    return {k: stats(v) for k, v in ts.items()}


def station_audio(n_stations, seconds, fs, block, seed, period=97.0):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds) // block * block
    x = rng.standard_normal((n_stations, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    for c in range(n_stations):
        for s0 in np.arange(20.0 + (7.0 * c) % 40.0, seconds - 10.0, period):
            m = (t >= s0) & (t < s0 + 1.0)
            x[c, m] += 1.5 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return x


def events_equal(a, b):
    ca, cb = np.asarray(a.count), np.asarray(b.count)
    if not np.array_equal(ca, cb):
        return False
    return bool(
        np.array_equal(np.asarray(a.time_start), np.asarray(b.time_start))
        and np.array_equal(np.asarray(a.time_stop), np.asarray(b.time_stop))
    )


def streaming_cell(name, n_stations, seconds, reps, quick, results, period=97.0):
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu import platform
    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import (
        StreamConfig,
        _compact_scan_outs,
        _ring_base_thresholds,
        lock_tail_blocks,
        min_duration_blocks,
        stream_front,
        stream_front_headless,
        stream_init_batch,
        stream_scan,
        stream_scan_fused_batch,
        stream_scan_jump,
        stream_scan_jump_batch,
    )
    from meteor_scatter_tpu.ops.pallas.stream_kernel import stream_machine_fused

    fs = 4000
    cfg = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    scfg = StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * fs))
    x = jnp.asarray(station_audio(n_stations, seconds, fs, block, seed=7, period=period))
    st0 = stream_init_batch(scfg, n_stations)
    n = int(x.shape[1] // block)
    cell = {"stations": n_stations, "seconds": seconds, "blocks": n,
            "burst_period_s": period}

    welch = jax.jit(lambda a: stream_front(cfg, a, fs)[:2])
    bins = jax.jit(lambda a: stream_front_headless(cfg, a, fs)[:2])
    (on_w, pm_w), cell["front_welch"] = timed(welch, (x,), 0 if quick else reps)
    (on_b, _), cell["front_bins"] = timed(bins, (x,), 0 if quick else reps)
    cell["bins_vs_welch_max_abs_db"] = float(jnp.max(jnp.abs(on_b - on_w)))

    def vm(solver, **kw):
        return jax.jit(jax.vmap(lambda s, o, p: solver(scfg, s, o, p, **kw)[:2]))

    variants = {f"scan_unroll{u}": vm(stream_scan, unroll=u) for u in (1, 16, 32)}
    variants["jump"] = vm(stream_scan_jump)
    variants["hop"] = vm(stream_scan_jump_batch)
    for kw in FUSED_SHAPES:
        vname = "fused_" + ("_".join(f"{k}{v}" for k, v in kw.items()) or "default")
        variants[vname] = jax.jit(
            lambda s, o, p, kw=kw: stream_scan_fused_batch(scfg, s, o, p, **kw)[:2]
        )
    ref = None
    for vname, fn in variants.items():
        (_, ev), res = timed(fn, (st0, on_w, pm_w), 0)
        if ref is None:
            ref = ev
            res["events"] = int(np.asarray(ev.count).sum())
        res["events_equal_scan"] = events_equal(ev, ref)
        cell[vname] = res
        print(f"# {name} {vname}: {res}", flush=True)
    if not quick:
        for vname, res in interleaved(
            {k: v for k, v in variants.items() if k != "scan_unroll1"},
            (st0, on_w, pm_w), reps,
        ).items():
            cell[vname].update(res)
        cell["scan_unroll1"].update(stats(sample(variants["scan_unroll1"],
                                                 (st0, on_w, pm_w), max(reps // 4, 3))))

    # the default kernel path in its three parts: XLA prologue (base
    # thresholds), the kernel alone, XLA epilogue (event compaction)
    w = scfg.avg_win
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)
    prologue = jax.jit(jax.vmap(
        lambda r, i, o: _ring_base_thresholds(r, i, o, w, scfg.k_std, jnp.float32)[0]))
    bt, _ = timed(prologue, (st0.ring, st0.block_idx, on_w), 0)
    carry_f = jnp.zeros((8, n_stations), jnp.float32)
    carry_i = jnp.zeros((6, n_stations), jnp.int32)
    kernel = jax.jit(lambda o, p, b: stream_machine_fused(
        o, p, b, carry_f, carry_i, block_sec=scfg.block_sec,
        init_wait_sec=scfg.init_wait_sec, min_mean_db=scfg.min_mean_db,
        min_dur_b=min_dur_b, lock_tail=lock_tail,
        interpret=platform.interpret_kernels())[0])
    ys, _ = timed(kernel, (on_w.T, pm_w.T, bt.T), 0)
    epilogue = jax.jit(lambda *o: jax.vmap(
        lambda *r: _compact_scan_outs(scfg, n, r))(*[y.T for y in o]))
    timed(epilogue, ys[1:], 0)
    if not quick:
        cell["default_parts"] = {
            "prologue": stats(sample(prologue, (st0.ring, st0.block_idx, on_w), reps)),
            "kernel": stats(sample(kernel, (on_w.T, pm_w.T, bt.T), reps)),
            "epilogue": stats(sample(epilogue, ys[1:], reps)),
        }
        print(f"# {name} default_parts: {cell['default_parts']}", flush=True)
    results[name] = cell


FUSED_SHAPES = (
    {},  # the kernel's defaults: groups of 16, tile 8 (1 for one channel)
    dict(tile=1),
    dict(tile=8),
    dict(max_group=32),
)


def batch_cell(reps, quick, results):
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds_parallel
    from meteor_scatter_tpu.models.events import events_from_mask
    from meteor_scatter_tpu.ops.bandpower import band_projection_matrix, band_power_db

    fs, block = 6000, 1200
    seconds = 3600.0
    rng = np.random.default_rng(2)
    n = int(fs * seconds)
    x_np = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / fs
    for s in np.arange(10.0, seconds - 5.0, 47.0):
        m = (t >= s) & (t < s + 1.0)
        x_np[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    M, slices = band_projection_matrix(fs, 1024, block, [(993.0, 1013.0), (690.0, 710.0)])
    frames = jnp.asarray(x_np.reshape(-1, block))
    Mj = jnp.asarray(M)

    @jax.jit
    def front(f, m):
        band, noise = band_power_db(f, m, slices)
        return band - noise

    delta, res = timed(front, (frames, Mj), 0 if quick else reps)
    if "median_ms" in res:
        res["input_GB_per_s"] = x_np.nbytes / (res["median_ms"] * 1e-3) / 1e9
    cell = {"bandpower_1h": res}

    @jax.jit
    def solve(d):
        _, above = adaptive_thresholds_parallel(d, 4.0, 600, 15, 100, 50)
        return events_from_mask(above, d, 4096)

    ev, cell["adaptive_1h"] = timed(solve, (delta,), 0 if quick else reps)
    cell["adaptive_1h"]["events"] = int(ev.count)
    d24 = jnp.asarray(np.tile(np.asarray(delta), 24)
                      + rng.standard_normal(24 * delta.shape[0]).astype(np.float32) * 0.01)
    ev, cell["adaptive_24h"] = timed(solve, (d24,), 0 if quick else reps)
    cell["adaptive_24h"]["events"] = int(ev.count)
    print(f"# batch: {cell}", flush=True)
    results["batch"] = cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax

    from meteor_scatter_tpu.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    results = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "card": card()}
    print(f"# {results['card']}", flush=True)
    streaming_cell("stations64_600s", 64, 600.0, args.reps, args.quick, results)
    streaming_cell("station1_1h", 1, 3600.0, args.reps, args.quick, results)
    streaming_cell("stations64_600s_dense", 64, 600.0, args.reps, args.quick, results,
                   period=20.0)
    batch_cell(args.reps, args.quick, results)
    line = json.dumps(results)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
