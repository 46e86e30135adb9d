"""Benchmark harness: audio samples/s per device through band power +
adaptive detection (BASELINE.md primary metric), plus the opt-in cells
below.

Baseline: the reference publishes no numbers (BASELINE.md), so the CPU
baseline is self-measured here by running a faithful numpy replica of the
reference hot loop (dsp/src/main.py:376-388 rfft band power + :450-522
adaptive threshold) on a slice of the same workload, then extrapolated to
per-sample rate.

Every cell runs the platform's default implementation
(`meteor_scatter_tpu/platform.py`) on arrays already on the device: one
warm-up call (compilation), then ``REPS`` calls that each end in
``block_until_ready``; the median is the cell's time.  A cell that fails
ends the run with a non-zero exit code.

Opt-in cells: ``--multi --stations --image --frontend --frontend-iq``.
``--quick`` shortens the inputs.  Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}, ...}
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np


# ---------------------------------------------------------------------------
# workload: BRAMS-like 6 kHz audio, reference analyzer parameters
# ---------------------------------------------------------------------------
FS = 6000
BLOCK_SEC = 0.2
BLOCK = int(FS * BLOCK_SEC)
N_FFT = 1024  # effective (reference user 512 doubled, main.py:353)
FREQ_BAND = (993.0, 1013.0)
NOISE_BAND = (690.0, 710.0)
K_STD = 4.0
WINDOW_BLOCKS = 600
FREEZE_BEFORE = 15
FREEZE_AFTER = 100
FIXED_INIT = 50

DEVICE_SECONDS = 3600.0  # 1 h of audio per timed call
BASELINE_SECONDS = 60.0  # numpy baseline slice (extrapolated)
REPS = 20

# Published peak device-memory bandwidth by JAX ``device_kind`` (NVIDIA
# H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s).  Every chain streams its
# input from device memory at least once per call, so samples/s ×
# bytes/sample above the peak marks a broken measurement.  A device that is
# not in the table is an error, not an assumed peak.
PEAK_BYTES_PER_SEC = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
METRIC_BYTES_PER_SAMPLE = {
    "value": 4.0,
    "multi8_samples_per_sec": 4.0,
    "stations64_samples_per_sec": 4.0,
    "image_samples_per_sec": 4.0,
    "channelizer_input_samples_per_sec": 4.0,
    "frontend_iq_2msps_samples_per_sec": 8.0,  # (re, im) float32 pair
}


def peak_bytes_per_sec(device_kind: str) -> float:
    if device_kind not in PEAK_BYTES_PER_SEC:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            "add it to PEAK_BYTES_PER_SEC with its source"
        )
    return PEAK_BYTES_PER_SEC[device_kind]


def implausible_metrics(artifact: dict, device_kind: str) -> list:
    """Metric fields whose value implies more input traffic than the
    device's peak memory bandwidth."""
    peak = peak_bytes_per_sec(device_kind)
    return [
        f for f, bps in METRIC_BYTES_PER_SAMPLE.items()
        if artifact.get(f) is not None and artifact[f] * bps > peak
    ]


def time_calls(fn, args, prefix: str, reps: int = REPS):
    """Warm up ``fn(*args)`` once, then time ``reps`` calls that each end
    in ``block_until_ready``.  Returns (median seconds, last output, diag)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    diag = {
        f"{prefix}_first_call_s": first,
        f"{prefix}_median_ms": dt * 1e3,
        f"{prefix}_min_ms": min(ts) * 1e3,
        f"{prefix}_reps": reps,
    }
    return dt, out, diag


def synth_audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / FS
    for s in np.arange(10.0, seconds - 5.0, 47.0):
        m = (t >= s) & (t < s + 1.0)
        x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    return x


def baseline_numpy(x: np.ndarray) -> float:
    """Reference hot loop replica; returns samples/s."""
    freqs = np.fft.rfftfreq(N_FFT, d=1.0 / FS)
    m1 = (freqs >= FREQ_BAND[0]) & (freqs <= FREQ_BAND[1])
    m2 = (freqs >= NOISE_BAND[0]) & (freqs <= NOISE_BAND[1])
    w = np.hanning(BLOCK)
    nb = len(x) // BLOCK

    t0 = time.perf_counter()
    band = np.empty(nb)
    noise = np.empty(nb)
    for i in range(nb):
        blk = x[i * BLOCK : (i + 1) * BLOCK]
        X = np.fft.rfft(blk * w, n=N_FFT)
        P = np.abs(X) ** 2
        band[i] = 10 * np.log10(P[m1].sum() + 1e-12)
        noise[i] = 10 * np.log10(P[m2].sum() + 1e-12)
    delta = band - noise

    # adaptive threshold walk (main.py:450-522)
    g_thr = delta.mean() + K_STD * delta.std()
    thr = g_thr
    freeze_until = -1
    for i in range(nb):
        if i < FIXED_INIT:
            thr = g_thr
        elif i > freeze_until:
            win = delta[max(0, i - WINDOW_BLOCKS) : i]
            thr = win.mean() + K_STD * win.std()
        if delta[i] > thr:
            freeze_until = max(i + FREEZE_AFTER, max(0, i - FREEZE_BEFORE))
    dt = time.perf_counter() - t0
    return len(x) / dt


def _batch_detect(frames, Mj, slices, cap):
    """Band power → delta → XLA fixpoint adaptive solver → events, for
    (..., n_blocks, BLOCK) frames."""
    import jax

    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds_parallel
    from meteor_scatter_tpu.models.events import events_from_mask
    from meteor_scatter_tpu.ops.bandpower import band_power_db

    band, noise = band_power_db(frames, Mj, slices)
    delta = band - noise

    def one(d):
        _, above = adaptive_thresholds_parallel(
            d, K_STD, WINDOW_BLOCKS, FREEZE_BEFORE, FREEZE_AFTER, FIXED_INIT
        )
        return events_from_mask(above, d, cap)

    if delta.ndim == 1:
        return one(delta)
    return jax.vmap(one)(delta)


def device_pipeline(x_np: np.ndarray):
    """Headline: 1 h of 6 kHz audio, one call."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.ops.bandpower import band_projection_matrix

    M, slices = band_projection_matrix(FS, N_FFT, BLOCK, [FREQ_BAND, NOISE_BAND])
    run = jax.jit(lambda f, m: _batch_detect(f, m, slices, 4096).count)
    nb = len(x_np) // BLOCK
    x = jnp.asarray(x_np[: nb * BLOCK].reshape(nb, BLOCK))
    dt, _, diag = time_calls(run, (x, jnp.asarray(M)), "headline")
    return len(x_np) / dt, dt, diag


def multi_channel_pipeline(n_channels: int, seconds: float) -> tuple:
    """Aggregate samples/s with N beacon channels batched on one device."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.ops.bandpower import band_projection_matrix

    M, slices = band_projection_matrix(FS, N_FFT, BLOCK, [FREQ_BAND, NOISE_BAND])
    x_np = np.stack([synth_audio(seconds, seed=10 + c) for c in range(n_channels)])
    nb = x_np.shape[1] // BLOCK
    run = jax.jit(lambda f, m: _batch_detect(f, m, slices, 1024).count.sum())
    x = jnp.asarray(x_np[:, : nb * BLOCK].reshape(n_channels, nb, BLOCK))
    dt, _, diag = time_calls(run, (x, jnp.asarray(M)), "multi8")
    return x_np.size / dt, diag


def verify_parallel_vs_sequential(x_np: np.ndarray) -> dict:
    """On-device correctness gate for the headline: the XLA fixpoint
    solver (`detect_adaptive`) and the sequential reference recurrence
    (`adaptive_thresholds`, dsp/src/main.py:450-522) must give identical
    event lists on the same delta series.  Raises when they differ."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds, detect_adaptive
    from meteor_scatter_tpu.models.events import events_from_mask
    from meteor_scatter_tpu.ops.bandpower import band_projection_matrix, band_power_db
    from meteor_scatter_tpu.ops.framing import frame_signal

    M, slices = band_projection_matrix(FS, N_FFT, BLOCK, [FREQ_BAND, NOISE_BAND])

    @jax.jit
    def delta_of(x, Mj):
        band, noise = band_power_db(frame_signal(x, BLOCK, BLOCK), Mj, slices)
        return band - noise

    delta = delta_of(jnp.asarray(x_np), jnp.asarray(M))
    ev_p, _ = jax.jit(lambda d: detect_adaptive(d, K_STD, BLOCK_SEC))(delta)

    @jax.jit
    def sequential(d):
        _, above, _ = adaptive_thresholds(
            d, K_STD, WINDOW_BLOCKS, FREEZE_BEFORE, FREEZE_AFTER, FIXED_INIT
        )
        return events_from_mask(above, d, 4096)

    ev_s = sequential(delta)
    c = int(ev_s.count)
    equal = (
        int(ev_p.count) == c
        and np.array_equal(np.asarray(ev_p.start)[:c], np.asarray(ev_s.start)[:c])
        and np.array_equal(np.asarray(ev_p.stop)[:c], np.asarray(ev_s.stop)[:c])
    )
    if not equal:
        raise RuntimeError("headline gate: parallel solver events differ from the sequential reference")
    return {"parallel_equals_sequential": True, "verify_events": c}


def stations_pipeline(n_stations: int = 64, seconds: float = 600.0):
    """BASELINE config 5 on one device: N stations × continuous 4 kHz
    streams through ``sharded_stream_process`` on a one-device mesh with
    the platform's default front and solver (`resolve_stream_auto`).  The
    default's event lists must equal the vmapped reference scan's over the
    welch front (start/stop/count per station).  Returns (aggregate input
    samples/s, gate dict, diag)."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import (
        StreamConfig,
        resolve_stream_auto,
        stream_front,
        stream_init_batch,
        stream_scan,
    )
    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

    fs = 4000
    cfg = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    scfg = StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * fs))
    n = int(fs * seconds) // block * block
    rng = np.random.default_rng(7)
    x_np = rng.standard_normal((n_stations, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    for c in range(n_stations):
        s0 = 20.0 + (7.0 * c) % max(seconds - 30.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x_np[c, m] += 1.5 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    front, impl = resolve_stream_auto("auto", "auto")
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    run = jax.jit(lambda x, st: sharded_stream_process(cfg, st, x, fs, mesh)[:2])

    @jax.jit
    def reference(x, st):
        on, pm, _ = stream_front(cfg, x, fs)
        return jax.vmap(lambda s, o, p: stream_scan(scfg, s, o, p)[1])(st, on, pm)

    x = jnp.asarray(x_np)
    st0 = stream_init_batch(scfg, n_stations)
    dt, (_, ev), diag = time_calls(run, (x, st0), "stations64")
    ev_s = reference(x, st0)
    equal = (
        np.array_equal(np.asarray(ev_s.count), np.asarray(ev.count))
        and np.array_equal(np.asarray(ev_s.time_start), np.asarray(ev.time_start))
        and np.array_equal(np.asarray(ev_s.time_stop), np.asarray(ev.time_stop))
    )
    if not equal:
        raise RuntimeError(f"stations gate: {front}:{impl} event lists differ from welch:scan")
    gate = {"stations_front": front, "stations_impl": impl,
            "stations_equals_scan": True,
            "stations_events": int(np.asarray(ev.count).sum())}
    return x_np.size / dt, gate, diag


def image_pipeline(n_segments: int = 8, seconds: float = 30.0, fs: int = 5000) -> tuple:
    """Monitor/ML-path metric: 30 s @ 5 kHz segments through the
    spectrogram-image cluster detector (the reference's deployed 24/7 hot
    path, prime_detection.py:61-98 + detector_and_classification.py —
    budgeted there at one segment per 30 s wall on a Raspberry Pi).
    Returns aggregate input samples/s."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.models.image import detect_and_cluster_bursts

    rng = np.random.default_rng(11)
    n = int(fs * seconds)
    x_np = rng.standard_normal((n_segments, n)).astype(np.float32) * 300.0
    t = np.arange(n) / fs
    for s in range(n_segments):
        for b0 in (8.0 + s, 20.0):
            m = (t >= b0) & (t < b0 + 1.0)
            x_np[s, m] += 3000.0 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)

    @jax.jit
    def run(x):
        _, b = jax.vmap(lambda seg: detect_and_cluster_bursts(seg, float(fs)))(x)
        return (b.n_critical + b.n_non_critical).sum()

    dt, _, diag = time_calls(run, (jnp.asarray(x_np),), "image")
    return x_np.size / dt, diag


def frontend_pipeline(seconds: float = 10.0, n_stations: int = 8):
    """Wideband channelizer throughput (BASELINE config 4 front half):
    real 1 MS/s capture → n_stations complex basebands @ ~6 kHz.
    Returns input samples/s."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.ops.fir import channelize

    fs = 1_000_000
    n = int(fs * seconds)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    centers = np.asarray([49_970 + 1000 * c for c in range(n_stations)])
    run = jax.jit(
        lambda a: channelize(a, fs, centers, bandwidth=200.0, decim=166, numtaps=257)
    )
    dt, _, diag = time_calls(run, (x,), "channelizer")
    return n / dt, diag


def frontend_iq_pipeline(seconds: float = 10.0, n_stations: int = 8):
    """BASELINE config 4 at spec: a 2 MS/s complex I/Q capture through the
    one-matmul DDC channelizer into per-station streaming detection with
    the platform's default front and solver, ONE jitted program.  Station
    offsets span both halves of the complex capture.  Returns complex input
    samples/s; the time-sharded form of the same chain is
    `parallel/sharded.py::sharded_channelize_iq` + `sharded_stream_process`,
    pinned sharded==unsharded in tests/test_parallel.py."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.apps.frontend import synth_wideband_iq
    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import StreamConfig, stream_init_batch
    from meteor_scatter_tpu.ops.fir import channelize_iq
    from meteor_scatter_tpu.parallel.mesh import make_mesh
    from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

    fs = 2_000_000
    audio_rate = 4000
    tone = 1000.0
    decim = fs // audio_rate  # 500, exact
    half = n_stations // 2
    freqs = [50_000.0 * (i - half) or 25_000.0 for i in range(n_stations)]
    centers = np.asarray([f - tone for f in freqs])
    x_re, x_im, _ = synth_wideband_iq(fs, seconds, freqs, seed=3)
    cfg = DetectionConfig(
        signal_freq=tone,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    scfg = StreamConfig.from_config(cfg)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])

    @jax.jit
    def run(xr, xi, st):
        audio, _ = channelize_iq(
            xr, xi, fs, centers, bandwidth=1500.0, decim=decim, numtaps=2001
        )
        _, ev, _ = sharded_stream_process(cfg, st, audio, audio_rate, mesh)
        return ev.count.sum()

    args = (jnp.asarray(x_re), jnp.asarray(x_im), stream_init_batch(scfg, n_stations))
    dt, _, diag = time_calls(run, args, "frontend_iq")
    return x_re.size / dt, diag


@contextlib.contextmanager
def maybe_profile(argv):
    """`--profile <dir>` wraps the headline in a jax.profiler trace
    (SURVEY.md §5 tracing; viewable with tensorboard/xprof)."""
    if "--profile" not in argv:
        yield
        return
    idx = argv.index("--profile") + 1
    if idx >= len(argv):
        raise SystemExit("--profile requires a directory argument")
    import jax

    with jax.profiler.trace(argv[idx]):
        yield


def card_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main() -> int:
    import jax

    from meteor_scatter_tpu.platform import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX's device is {dev.platform}", file=sys.stderr)
        return 2
    peak_bytes_per_sec(dev.device_kind)  # unknown device: fail before measuring
    enable_compile_cache()
    card = card_power_limit()
    print(f"# card: {card}", file=sys.stderr)

    quick = "--quick" in sys.argv
    dev_secs = 300.0 if quick else DEVICE_SECONDS
    base_secs = 20.0 if quick else BASELINE_SECONDS

    x_base = synth_audio(base_secs, seed=1)
    base_sps = baseline_numpy(x_base)
    print(f"# baseline (numpy replica of reference hot loop): {base_sps:,.0f} samples/s",
          file=sys.stderr)

    x = synth_audio(dev_secs, seed=2)
    with maybe_profile(sys.argv):
        sps, dt, diag = device_pipeline(x)
    print(f"# headline: {len(x):,} samples in {dt * 1e3:.3f} ms -> {sps:,.0f} samples/s",
          file=sys.stderr)
    extra: dict = {"baseline_cpu_samples_per_sec": round(base_sps), **diag}
    if "--no-verify" not in sys.argv:
        extra.update(verify_parallel_vs_sequential(x))

    if "--multi" in sys.argv:
        mc_sps, mc_diag = multi_channel_pipeline(n_channels=8, seconds=300.0 if quick else 900.0)
        print(f"# 8-channel: {mc_sps:,.0f} aggregate samples/s", file=sys.stderr)
        extra["multi8_samples_per_sec"] = round(mc_sps)
        extra.update(mc_diag)

    if "--stations" in sys.argv:
        st_sps, st_gate, st_diag = stations_pipeline(
            n_stations=64, seconds=120.0 if quick else 600.0
        )
        print(f"# 64-station streaming ({st_gate['stations_front']}:"
              f"{st_gate['stations_impl']}): {st_sps:,.0f} aggregate samples/s",
              file=sys.stderr)
        extra["stations64_samples_per_sec"] = round(st_sps)
        extra.update(st_gate)
        extra.update(st_diag)

    if "--image" in sys.argv:
        im_sps, im_diag = image_pipeline()
        print(f"# image path (8 x 30 s segments): {im_sps:,.0f} samples/s", file=sys.stderr)
        extra["image_samples_per_sec"] = round(im_sps)
        extra.update(im_diag)

    if "--frontend" in sys.argv:
        fe_sps, fe_diag = frontend_pipeline()
        print(f"# channelizer (8ch @ 1 MS/s): {fe_sps:,.0f} input samples/s", file=sys.stderr)
        extra["channelizer_input_samples_per_sec"] = round(fe_sps)
        extra.update(fe_diag)

    if "--frontend-iq" in sys.argv:
        fi_sps, fi_diag = frontend_iq_pipeline()
        print(f"# IQ frontend end-to-end (8ch @ 2 MS/s complex): {fi_sps:,.0f} "
              "input samples/s", file=sys.stderr)
        extra["frontend_iq_2msps_samples_per_sec"] = round(fi_sps)
        extra.update(fi_diag)

    artifact = {
        "metric": "audio_samples_per_sec_per_device_detect",
        "value": round(sps),
        "unit": "samples/s",
        "vs_baseline": round(sps / base_sps, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "date": time.strftime("%Y-%m-%d"),
        **extra,
    }
    bad = implausible_metrics(artifact, dev.device_kind)
    if bad:
        artifact["implausible"] = bad
        print(f"# warning: implausible (above peak memory bandwidth) metrics: {bad}",
              file=sys.stderr)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
