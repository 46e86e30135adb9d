"""Smoke test of the detection chain on one GPU.

Runs each user-facing path once through its normal entry point, at the
sizes the benchmark and BASELINE.json name, with synthetic input made from
fixed seeds, and compares each with the repository's plain reference on
the same card:

* batch analyzer: ``apps.analyze.main`` on a 1 h, 6 kHz WAV with injected
  1003 Hz bursts; its events CSV must equal the sequential
  ``adaptive_thresholds`` + ``events_from_mask``, and the bursts must come
  back;
* station network: 64 stations x 600 s at 4 kHz through
  ``sharded_stream_process`` (platform defaults) on a one-device mesh; the
  per-station event lists must equal the vmapped ``stream_scan`` over the
  welch front, and the Triton streaming kernel must equal the scan on the
  same series; then ``apps.live.main`` on a 10 min, 4 kHz WAV against
  ``stream_process`` with the reference solver;
* IQ front-end: ``apps.frontend.main`` at 2 MS/s complex, 8 stations x
  30 s, and ``channelize_iq`` against a float64 numpy polyphase reference;
* image path: ``apps.monitor.main`` on 8 x 30 s at 5 kHz to the ledger
  CSV; the cluster count must equal the one computed on the CPU device of
  this process.

``--four`` runs only the four-card phase: the station network on meshes
(4 station x 1 time), (1 x 4) and (2 x 2), each against the single-device
``stream_process``.

Usage::

    python chip_smoke.py [--four]

Exits non-zero when JAX finds no GPU (or fewer than four with ``--four``)
or when any phase fails.  The last line of standard output is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances, each with its reason.
DB_MEAN_RTOL = 1e-4      # event dB means: f32 sums in another order
IQ_REL_TOL = 1e-4        # channelizer: f32 HIGHEST matmul vs float64, per channel
LIVE_TIME_TOL = 1e-6     # live CLI prints times with 2 decimals of exact block edges


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def capture(main, argv):
    """Run an app's ``main(argv)`` in this process, returning (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# phase 1: batch analyzer
# ---------------------------------------------------------------------------

def batch_audio(seconds: float, fs: int = 6000, seed: int = 2):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / fs
    starts = np.arange(10.0, seconds - 5.0, 47.0)
    for s in starts:
        m = (t >= s) & (t < s + 1.0)
        x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    return x, starts


def phase_batch(tmp: str, seconds: float = 3600.0) -> dict:
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.apps import analyze
    from meteor_scatter_tpu.io.wavio import read_wav, write_wav
    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds
    from meteor_scatter_tpu.models.events import events_from_mask
    from meteor_scatter_tpu.ops.bandpower import delta_power_db

    fs, bd = 6000, 0.2
    x, starts = batch_audio(seconds, fs)
    wav = os.path.join(tmp, "batch.wav")
    out_csv = os.path.join(tmp, "events.csv")
    write_wav(wav, fs, x)

    t0 = time.perf_counter()
    rc, _ = capture(analyze.main, [wav, "--out-csv", out_csv, "--sample-rate", str(fs)])
    wall = time.perf_counter() - t0
    require(rc == 0, "analyze exit code")
    with open(out_csv) as fh:
        rows = list(csv.DictReader(fh))
    got = np.asarray([[float(r["t_start"]), float(r["t_stop"]), float(r["dB"])] for r in rows])

    # reference: same front on the card, the sequential solver, the plain
    # event extraction (same parameters as the analyzer's defaults)
    _, data = read_wav(wav, mono=True)
    _, _, delta = delta_power_db(
        jnp.asarray(data, jnp.float32), fs, 1024, int(fs * bd), (993.0, 1013.0), (690.0, 710.0)
    )
    _, above, _ = jax.jit(
        lambda d: adaptive_thresholds(d, 4.0, int(120 / bd), int(3 / bd), int(20 / bd), int(10 / bd))
    )(delta)
    ev = events_from_mask(above, delta, 4096)
    c = int(ev.count)
    ref = np.stack([np.asarray(ev.start)[:c] * bd, np.asarray(ev.stop)[:c] * bd,
                    np.asarray(ev.db_mean)[:c]], axis=1) if c else np.zeros((0, 3))

    require(got.shape == ref.shape, f"event count {len(got)} vs reference {len(ref)}")
    require(np.array_equal(got[:, :2], ref[:, :2]), "event boundaries equal the reference")
    db_dev = float(np.max(np.abs(got[:, 2] - ref[:, 2]) / np.abs(ref[:, 2]))) if c else 0.0
    require(db_dev <= DB_MEAN_RTOL, f"event dB rel. deviation {db_dev}")
    found = sum(bool(np.any((got[:, 0] < s + 1.0) & (got[:, 1] > s))) for s in starts)
    require(found == len(starts), f"injected bursts found {found}/{len(starts)}")
    return {"wall_s": wall, "events": int(c), "bursts_found": f"{found}/{len(starts)}",
            "db_rel_dev": db_dev, "db_rel_tol": DB_MEAN_RTOL}


# ---------------------------------------------------------------------------
# phase 2: station network
# ---------------------------------------------------------------------------

def station_audio(n_stations: int, seconds: float, fs: int = 4000, seed: int = 7):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds) // 800 * 800
    x = rng.standard_normal((n_stations, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    for c in range(n_stations):
        for s0 in np.arange(20.0 + (7.0 * c) % 40.0, seconds - 10.0, 97.0):
            m = (t >= s0) & (t < s0 + 1.0)
            x[c, m] += 1.5 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return x


def station_cfg():
    from meteor_scatter_tpu.config import DetectionConfig

    return DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )


def compare_station_events(ev, ref, what: str) -> float:
    """Per-station event lists: counts and boundaries exact, dB means to
    DB_MEAN_RTOL.  Returns the largest dB-mean relative deviation."""
    counts, rcounts = np.asarray(ev.count), np.asarray(ref.count)
    require(np.array_equal(counts, rcounts), f"{what}: per-station counts")
    require(not np.asarray(ev.overflow).any(), f"{what}: no event overflow")
    worst = 0.0
    for c, k in enumerate(counts):
        for f in ("time_start", "time_stop"):
            require(np.array_equal(np.asarray(getattr(ev, f))[c, :k],
                                   np.asarray(getattr(ref, f))[c, :k]),
                    f"{what}: station {c} {f}")
        a = np.asarray(ev.db_mean)[c, :k]
        b = np.asarray(ref.db_mean)[c, :k]
        if k:
            worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    require(worst <= DB_MEAN_RTOL, f"{what}: dB mean rel. deviation {worst}")
    return worst


def phase_stations(tmp: str, n_stations: int = 64, seconds: float = 600.0,
                   live_seconds: float = 600.0) -> dict:
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu import platform
    from meteor_scatter_tpu.apps import live
    from meteor_scatter_tpu.io.wavio import write_wav
    from meteor_scatter_tpu.models.streaming import (
        StreamConfig,
        resolve_stream_auto,
        stream_front,
        stream_front_headless,
        stream_init,
        stream_init_batch,
        stream_process,
        stream_scan,
        stream_scan_fused_batch,
    )
    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

    fs = 4000
    cfg = station_cfg()
    scfg = StreamConfig.from_config(cfg)
    x = jnp.asarray(station_audio(n_stations, seconds, fs))
    out: dict = {"front_solver": "%s:%s" % resolve_stream_auto("auto", "auto")}

    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    _, ev, _ = sharded_stream_process(cfg, None, x, fs, mesh, front="auto", impl="auto")
    jax.block_until_ready(ev)
    out["sharded_wall_s"] = time.perf_counter() - t0

    @jax.jit
    def reference(a):
        on, pm, _ = stream_front(cfg, a, fs)
        st = stream_init_batch(scfg, a.shape[0])
        return jax.vmap(lambda s, o, p: stream_scan(scfg, s, o, p, unroll=1))(st, on, pm), on, pm

    (_, ev_ref, _), on_w, pm_w = reference(x)
    out["events"] = int(np.asarray(ev_ref.count).sum())
    require(out["events"] >= n_stations, f"stations found events ({out['events']})")
    out["db_rel_dev"] = compare_station_events(ev, ev_ref, "sharded vs scan")
    on_b = jax.jit(lambda a: stream_front_headless(cfg, a, fs)[0])(x)
    out["bins_vs_welch_max_abs_db"] = float(jnp.max(jnp.abs(on_b - on_w)))

    # the Triton kernel, compiled, against the scan on the same series
    _, ev_k, thr_k = jax.jit(
        lambda s, o, p: stream_scan_fused_batch(scfg, s, o, p)
    )(stream_init_batch(scfg, n_stations), on_w, pm_w)
    out["kernel_db_rel_dev"] = compare_station_events(ev_k, ev_ref, "kernel vs scan")
    require(not platform.interpret_kernels(), "kernel compiled, not interpreted")

    # live CLI on one station's 10 min capture
    xl = station_audio(1, live_seconds, fs, seed=11)[0]
    wav = os.path.join(tmp, "live.wav")
    write_wav(wav, fs, xl)
    t0 = time.perf_counter()
    rc, text = capture(live.main, [wav, "--sample-rate", str(fs),
                                   "--signal-freq", "1000", "--min-mean-db", "1.0",
                                   "--min-dur", "0.5"])
    out["live_wall_s"] = time.perf_counter() - t0
    require(rc == 0, "live exit code")
    got = [(float(a), float(b)) for a, b in
           re.findall(r"Detected Meteor: start=([-\d.]+)s stop=([-\d.]+)s", text)]
    _, ev_l, _ = jax.jit(
        lambda a: stream_process(cfg, stream_init(scfg), a, fs, front="welch", impl="scan")
    )(jnp.asarray(xl))
    k = int(ev_l.count)
    want = [(round(float(a), 2), round(float(b), 2)) for a, b in
            zip(np.asarray(ev_l.time_start)[:k], np.asarray(ev_l.time_stop)[:k])]
    require(k > 0, "live reference found events")
    require(len(got) == k and all(abs(g[0] - w[0]) <= LIVE_TIME_TOL and abs(g[1] - w[1]) <= LIVE_TIME_TOL
                                  for g, w in zip(got, want)),
            f"live events {got} vs reference {want}")
    out["live_events"] = k
    return out


# ---------------------------------------------------------------------------
# phase 3: IQ front-end
# ---------------------------------------------------------------------------

def channelize_reference(x_re, x_im, fs, centers, bandwidth, decim, numtaps, outs):
    """float64 numpy polyphase DDC at output indices ``outs``:
    y_c[o] = Σ_k h[k] · x[o·q + pl − k] · e^{−j2π f_c (o·q + pl − k)/fs}."""
    from meteor_scatter_tpu.ops.fir import firwin_lowpass

    h = firwin_lowpass(numtaps, bandwidth / 2.0, fs)
    pl = (numtaps - 1) // 2
    n = x_re.size
    k = np.arange(numtaps)
    idx = outs[:, None] * decim + pl - k[None, :]          # (O, T)
    valid = (idx >= 0) & (idx < n)
    ii = np.clip(idx, 0, n - 1)
    x = np.where(valid, x_re[ii].astype(np.float64) + 1j * x_im[ii].astype(np.float64), 0)
    y = np.empty((len(centers), len(outs)), np.complex128)
    for c, fc in enumerate(centers):
        ph = np.exp(-2j * np.pi * ((ii * int(fc)) % int(fs)) / fs)
        y[c] = np.sum(h[None, :] * x * ph, axis=1)
    return y


def phase_iq(n_stations: int = 8, seconds: float = 30.0) -> dict:
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.apps import frontend
    from meteor_scatter_tpu.ops.fir import channelize_iq

    fs = 2_000_000
    t0 = time.perf_counter()
    rc, text = capture(frontend.main, ["--stations", str(n_stations),
                                       "--seconds", str(seconds), "--iq"])
    wall = time.perf_counter() - t0
    require(rc == 0, "frontend exit code")
    counts = [int(m) for m in re.findall(r"station \d+ \([-\d]+ kHz\): (\d+) events", text)]
    require(len(counts) == n_stations, "frontend reported every station")
    require(all(c >= 1 for c in counts), f"every station finds its bursts {counts}")

    # the channelizer stage the front-end runs, against float64 numpy
    half = n_stations // 2
    freqs = [50_000.0 * (i - half) or 25_000.0 for i in range(n_stations)]
    centers = [int(f - frontend.TONE_FREQ) for f in freqs]
    x_re, x_im, _ = frontend.synth_wideband_iq(fs, seconds, freqs)
    decim, numtaps, bw = 200, 513, 2500.0
    y_re, y_im = jax.jit(
        lambda a, b: channelize_iq(a, b, fs, centers, bandwidth=bw, decim=decim, numtaps=numtaps)
    )(jnp.asarray(x_re), jnp.asarray(x_im))
    y = np.asarray(y_re) + 1j * np.asarray(y_im)
    rng = np.random.default_rng(0)
    outs = np.sort(rng.choice(y.shape[1], size=min(4096, y.shape[1]), replace=False))
    outs[:2] = (0, y.shape[1] - 1)  # both stream edges
    ref = channelize_reference(x_re, x_im, fs, centers, bw, decim, numtaps, outs)
    rel = np.max(np.abs(y[:, outs] - ref), axis=1) / np.max(np.abs(ref), axis=1)
    worst = float(rel.max())
    require(worst <= IQ_REL_TOL, f"channelizer rel. deviation {worst}")
    return {"wall_s": wall, "events_per_station": counts,
            "channelizer_rel_dev": worst, "channelizer_rel_tol": IQ_REL_TOL}


# ---------------------------------------------------------------------------
# phase 4: image path
# ---------------------------------------------------------------------------

def phase_image(tmp: str, n_segments: int = 8, seconds: int = 30) -> dict:
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.apps import monitor
    from meteor_scatter_tpu.io.wavio import read_wav, write_wav
    from meteor_scatter_tpu.models.image import detect_and_cluster_bursts

    fs = 5000
    rng = np.random.default_rng(11)
    n = fs * seconds
    x = rng.standard_normal((n_segments, n)) * 300.0
    t = np.arange(n) / fs
    for s in range(n_segments):
        for b0 in (8.0 + s, 20.0):
            m = (t >= b0) & (t < b0 + 1.0)
            x[s, m] += 3000.0 * np.sin(2 * np.pi * 1000.0 * t[m])
    wav = os.path.join(tmp, "monitor.wav")
    write_wav(wav, fs, np.clip(x.reshape(-1), -32768, 32767).astype(np.int16))
    csv_dir = os.path.join(tmp, "csv-out")

    # 15 simulated seconds per second of audio: the 8 segments span one
    # ledger hour, so the hourly row is flushed at the last segment
    t0 = time.perf_counter()
    rc, _ = capture(monitor.main, [
        "--wav", wav, "--csv-out", csv_dir, "--spec-out", os.path.join(tmp, "spec-out"),
        "--max-segments", str(n_segments), "--start-time", "2026-01-01T00:00:00",
        "--time-scale", str(3600.0 / (n_segments * seconds)),
    ])
    wall = time.perf_counter() - t0
    require(rc == 0, "monitor exit code")
    with open(os.path.join(csv_dir, "20260101.csv")) as fh:
        rows = [r.strip().split(";") for r in fh.readlines()[1:] if r.strip()]
    require(len(rows) == 1, f"one hourly ledger row, got {rows}")
    total, critical = int(rows[0][1]), int(rows[0][2])

    _, data = read_wav(wav, mono=True)
    segs = np.asarray(data, np.float32).reshape(n_segments, fs * seconds)
    count = jax.jit(lambda a: sum_bursts(detect_and_cluster_bursts(a, float(fs))[1]))
    on_card = [int(count(jnp.asarray(s))) for s in segs]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        on_cpu = [int(count(jax.device_put(s, cpu))) for s in segs]
    require(on_card == on_cpu, f"cluster counts card {on_card} vs cpu {on_cpu}")
    require(sum(on_card) == total, f"ledger total {total} vs {sum(on_card)}")
    require(total >= n_segments, f"bursts found ({total})")
    return {"wall_s": wall, "ledger_total": total, "ledger_critical": critical,
            "clusters_per_segment": on_card}


def sum_bursts(b):
    return b.n_critical + b.n_non_critical


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four(n_stations: int = 64, seconds: float = 600.0) -> dict:
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.models.streaming import StreamConfig, stream_init, stream_process
    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

    fs = 4000
    cfg = station_cfg()
    scfg = StreamConfig.from_config(cfg)
    x_np = station_audio(n_stations, seconds, fs)

    one = jax.jit(lambda a: stream_process(cfg, stream_init(scfg), a, fs)[1])
    refs = [one(jnp.asarray(x_np[c])) for c in range(n_stations)]
    ref = jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(v) for v in a]), *refs)
    out = {"events": int(ref.count.sum())}
    require(out["events"] >= n_stations, "stations found events")
    for shape in ((4, 1), (1, 4), (2, 2)):
        mesh = make_mesh(*shape, devices=jax.devices()[:4])
        t0 = time.perf_counter()
        _, ev, _ = sharded_stream_process(cfg, None, jnp.asarray(x_np), fs, mesh)
        jax.block_until_ready(ev)
        name = f"mesh_{shape[0]}x{shape[1]}"
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        out[f"{name}_db_rel_dev"] = compare_station_events(ev, ref, name)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card station network phase")
    args = p.parse_args(argv)

    import jax

    import meteor_scatter_tpu
    from meteor_scatter_tpu.platform import enable_compile_cache

    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(os.path.abspath(meteor_scatter_tpu.__file__))) != here:
        print("chip_smoke: runs from the root of a checkout of this repository",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} devices, JAX found {len(devices)}", file=sys.stderr)
        return 2
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's device is {devices[0].platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    log(f"card: {card()}")

    if args.four:
        phases = [("four_cards", phase_four)]
    else:
        phases = [("batch_analyzer", phase_batch), ("station_network", phase_stations),
                  ("iq_frontend", lambda tmp: phase_iq()), ("image_path", phase_image)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in phases:
            t0 = time.perf_counter()
            res = fn(tmp) if name != "four_cards" else fn()
            res["phase_s"] = time.perf_counter() - t0
            log(f"phase {name}: {json.dumps(res)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
