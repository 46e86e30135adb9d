"""High-rate SDR front-end: wideband capture → channelizer → per-channel
band-power detection (BASELINE.json config 4).

The reference ingests audio that GQRX/HDSDR already downconverted and
resampled offline (`dsp/src/live/main.py:23,45`).  This front-end does the
whole receive chain on device: a multi-MS/s real capture is mixed against
each beacon channel, polyphase-decimated to the analysis rate
(:func:`meteor_scatter_tpu.ops.fir.channelize` — one batched strided
convolution for all channels), converted to the audio-domain tone the
detectors expect, and pushed through the standard band-power + adaptive
detection pipeline, optionally sharded over a (station, time) mesh.

Synthetic demo::

    python -m meteor_scatter_tpu.apps.frontend --stations 8 --seconds 10
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np

from meteor_scatter_tpu.ops.fir import channelize, channelize_iq
from meteor_scatter_tpu.platform import enable_compile_cache


TONE_FREQ = 1003.0  # audio-domain beacon tone (main.py:827)


def iq_frontend(
    x,  # (S,) real wideband capture, or I of a complex capture when x_im given
    fs: float,
    station_freqs: Sequence[float],
    audio_rate: int = 6000,
    tone_freq: float = TONE_FREQ,
    channel_bandwidth: float = 2500.0,
    numtaps: int = 513,
    x_im=None,  # (S,) Q component of a complex capture (optional)
):
    """Wideband capture → (n_stations, S_audio) audio-rate channels.

    Each station's carrier is mixed so its beacon lands at ``tone_freq``
    in the channel's audio output, matching the rates/frequencies the
    detectors are configured for.

    Real capture (``x_im is None``): mixing to ``f_c - tone_freq`` and
    taking 2·Re of the filtered complex baseband keeps the single remaining
    sideband as a real tone at ``tone_freq`` (2× because the real tone
    splits its amplitude across ±f_c).

    Complex I/Q capture (``x_im`` given): the same chain through
    :func:`channelize_iq`; station offsets may be negative (the lower half
    of the captured span), and Re alone suffices — a complex exponential
    carries full amplitude in one sideband.
    """
    from fractions import Fraction

    import jax.numpy as jnp

    from meteor_scatter_tpu.ops.fir import resample_poly

    fs_i = int(round(fs))
    centers = np.asarray(station_freqs, dtype=np.float64) - tone_freq

    def bank(decim):
        host = isinstance(x, np.ndarray) and (
            x_im is None or isinstance(x_im, np.ndarray)
        )
        if host:
            # host capture: pre-frame on the host (a plain numpy copy);
            # bit-identical to the flat path
            # (tests/test_fir.py::test_preframed_equals_flat_*)
            from meteor_scatter_tpu.ops.fir import (
                channel_bank_plan,
                channelize_frames,
                channelize_iq_frames,
                frame_capture_host,
            )

            plan, tables = channel_bank_plan(
                np.shape(x)[-1], fs, centers,
                bandwidth=channel_bandwidth, decim=decim, numtaps=numtaps,
            )
            if x_im is None:
                f = jnp.asarray(frame_capture_host(x, plan))
                re, _ = channelize_frames(f, tables, plan)
                return 2.0 * re
            f = jnp.asarray(frame_capture_host(np.stack([x, x_im]), plan))
            re, _ = channelize_iq_frames(f, tables, plan)
            return re
        if x_im is None:
            re, _ = channelize(
                jnp.asarray(x), fs, centers,
                bandwidth=channel_bandwidth, decim=decim, numtaps=numtaps,
            )
            return 2.0 * re
        re, _ = channelize_iq(
            jnp.asarray(x), jnp.asarray(x_im), fs, centers,
            bandwidth=channel_bandwidth, decim=decim, numtaps=numtaps,
        )
        return re

    if fs_i % audio_rate == 0:
        return bank(fs_i // audio_rate)
    # two-stage: integer channelizer decimation to an intermediate rate
    # comfortably above the channel bandwidth, then a rational polyphase
    # resample to the exact audio rate (2 MS/s → /200 → 10 kHz → ×3/5 → 6 kHz)
    decim1 = max(int(fs_i // (4 * channel_bandwidth)), 1)
    frac = Fraction(audio_rate * decim1, fs_i)
    return resample_poly(bank(decim1), frac.numerator, frac.denominator)


def detect_channels(
    audio,  # (C, S) at audio_rate
    audio_rate: int = 6000,
    n_fft: int = 1024,
    block_duration_sec: float = 0.2,
    tone_freq: float = TONE_FREQ,
    bandwidth: float = 10.0,
    noise_freq: float = 700.0,
    threshold_std_factor: float = 4.0,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_sec: float = 3.0,
    threshold_freeze_after_sec: float = 20.0,
    threshold_fixed_init_sec: float = 10.0,
    mesh=None,
    cap: int = 512,
):
    """Per-channel adaptive detection; uses the sharded pipeline when a
    mesh is given, plain vmap otherwise.  Returns (events_per_channel,
    delta (C, B))."""
    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds_parallel
    from meteor_scatter_tpu.models.events import events_from_mask
    from meteor_scatter_tpu.ops.bandpower import band_power_db, band_projection_matrix
    from meteor_scatter_tpu.ops.framing import frame_signal

    block = int(audio_rate * block_duration_sec)
    fb = (tone_freq - bandwidth, tone_freq + bandwidth)
    nb = (noise_freq - bandwidth, noise_freq + bandwidth)

    if mesh is not None:
        from meteor_scatter_tpu.parallel.sharded import (
            sharded_delta_power,
            sharded_detect_adaptive,
        )

        _, _, delta = sharded_delta_power(audio, mesh, audio_rate, n_fft, block, fb, nb)
        _, above = sharded_detect_adaptive(
            delta,
            mesh,
            threshold_std_factor=threshold_std_factor,
            window_blocks=int(threshold_estimation_window_sec / block_duration_sec),
            freeze_blocks_before=int(threshold_freeze_before_sec / block_duration_sec),
            freeze_blocks_after=int(threshold_freeze_after_sec / block_duration_sec),
            fixed_threshold_blocks=int(threshold_fixed_init_sec / block_duration_sec),
        )
    else:
        M, slices = band_projection_matrix(audio_rate, n_fft, block, [fb, nb])

        @jax.jit
        def run(a, Mj):
            frames = frame_signal(a, block, block)
            band, noise = band_power_db(frames, Mj, slices)
            delta = band - noise
            _, above = jax.vmap(
                lambda d: adaptive_thresholds_parallel(
                    d,
                    threshold_std_factor,
                    int(threshold_estimation_window_sec / block_duration_sec),
                    int(threshold_freeze_before_sec / block_duration_sec),
                    int(threshold_freeze_after_sec / block_duration_sec),
                    int(threshold_fixed_init_sec / block_duration_sec),
                )
            )(delta)
            return delta, above

        delta, above = run(audio.astype(jnp.float32), jnp.asarray(M))

    events = jax.vmap(lambda a, d: events_from_mask(a, d, cap=cap))(above, delta)
    return events, delta


def synth_wideband(
    fs: float,
    seconds: float,
    station_freqs: Sequence[float],
    bursts_per_station: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, list]:
    """Synthetic 2 MS/s-style capture: broadband noise + per-station beacon
    bursts.  Returns (capture, truth) with truth[(c)] = list of (t0, dur)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.1
    t = np.arange(n) / fs
    truth = []
    for c, fc in enumerate(station_freqs):
        events = []
        for b in range(bursts_per_station):
            t0 = 1.0 + (seconds - 3.0) * (b + 0.3 * (c + 1) / len(station_freqs)) / bursts_per_station
            dur = 0.6 + 0.4 * b
            m = (t >= t0) & (t < t0 + dur)
            x[m] += 0.5 * np.sin(2 * np.pi * fc * t[m]).astype(np.float32)
            events.append((t0, dur))
        truth.append(events)
    return x, truth


def synth_wideband_iq(
    fs: float,
    seconds: float,
    station_freqs: Sequence[float],
    bursts_per_station: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Complex (I/Q) variant of :func:`synth_wideband`: station offsets span
    the full ±fs/2 capture (negative offsets allowed), beacons are complex
    exponentials.  Returns (x_re, x_im, truth)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x_re = rng.standard_normal(n).astype(np.float32) * 0.1
    x_im = rng.standard_normal(n).astype(np.float32) * 0.1
    t = np.arange(n) / fs
    truth = []
    for c, fc in enumerate(station_freqs):
        events = []
        for b in range(bursts_per_station):
            t0 = 1.0 + (seconds - 3.0) * (b + 0.3 * (c + 1) / len(station_freqs)) / bursts_per_station
            dur = 0.6 + 0.4 * b
            m = (t >= t0) & (t < t0 + dur)
            ph = 2 * np.pi * fc * t[m]
            x_re[m] += 0.5 * np.cos(ph).astype(np.float32)
            x_im[m] += 0.5 * np.sin(ph).astype(np.float32)
            events.append((t0, dur))
        truth.append(events)
    return x_re, x_im, truth


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fs", type=float, default=2_000_000.0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--stations", type=int, default=8)
    p.add_argument("--base-freq", type=float, default=100_000.0)
    p.add_argument("--spacing", type=float, default=50_000.0)
    p.add_argument("--iq", action="store_true",
                   help="complex I/Q capture; stations centered on 0 Hz "
                        "(negative offsets use the lower half of the span)")
    args = p.parse_args(argv)
    enable_compile_cache()

    if args.iq:
        half = args.stations // 2
        freqs = [args.spacing * (i - half) or args.spacing / 2 for i in range(args.stations)]
        print(f"Synthesizing IQ {args.seconds}s @ {args.fs / 1e6:.1f} MS/s, "
              f"{args.stations} stations at {[f / 1e3 for f in freqs]} kHz")
        x_re, x_im, truth = synth_wideband_iq(args.fs, args.seconds, freqs)
        audio = iq_frontend(x_re, args.fs, freqs, x_im=x_im)
    else:
        freqs = [args.base_freq + i * args.spacing for i in range(args.stations)]
        print(f"Synthesizing {args.seconds}s @ {args.fs / 1e6:.1f} MS/s, {args.stations} stations")
        x, truth = synth_wideband(args.fs, args.seconds, freqs)
        audio = iq_frontend(x, args.fs, freqs)
    print(f"Channelized to {audio.shape} @ 6 kHz")
    events, delta = detect_channels(audio)
    for c in range(args.stations):
        cnt = int(events.count[c])
        spans = [
            f"[{float(events.start[c, i]) * 0.2:.1f},{float(events.stop[c, i]) * 0.2:.1f}]s"
            for i in range(cnt)
        ]
        print(f"station {c} ({freqs[c] / 1e3:.0f} kHz): {cnt} events {spans} "
              f"(truth: {[(round(t0, 1), round(d, 1)) for t0, d in truth[c]]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
