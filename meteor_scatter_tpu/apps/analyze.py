"""Batch WAV analyzer — accelerator re-design of `dsp/src/main.py:207-806`
(``proc_wav_file``) with the same outputs: console detections, Audacity
pre-labels, event CSV, per-detection spectrogram images.

The reference walks ~432 000 blocks/day in a Python loop; here the whole
file becomes one jitted program: framing → band projection matmul →
adaptive/fixed detection scan → fixed-capacity events.

Usage::

    python -m meteor_scatter_tpu.apps.analyze recording.wav \
        --signal-freq 1003 --noise-freq 700 --bandwidth 10 \
        --out-csv events.csv --out-audacity prelbl.txt --out-spec-dir spec/

Filename → UTC start-time parsing supports the reference's gqrx pattern
``*_gqrx_YYYYMMDD_HHMMSS_<freq>.wav`` (`main.py:858-863`).
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meteor_scatter_tpu.config import AnalyzeConfig, BandPowerConfig
from meteor_scatter_tpu.platform import enable_compile_cache
from meteor_scatter_tpu.io.events_csv import (
    OutputDetection,
    events_to_detections,
    write_audacity_labels,
    write_event_csv,
)
from meteor_scatter_tpu.io.spec_export import export_detection_spec
from meteor_scatter_tpu.io.wavio import read_wav
from meteor_scatter_tpu.models.adaptive import detect_adaptive
from meteor_scatter_tpu.models.fixed import detect_fixed
from meteor_scatter_tpu.ops.bandpower import delta_power_db
from meteor_scatter_tpu.utils.timing import PhaseTimer


@dataclass
class AnalyzeResult:
    detections: List[OutputDetection]
    band_power: np.ndarray
    noise_power: np.ndarray
    delta_power: np.ndarray
    thresholds: np.ndarray  # scalar-broadcast for fixed, per-block for adaptive
    sample_rate: int
    block_duration_sec: float
    timer: PhaseTimer = field(default_factory=PhaseTimer)


def export_debug_plots(res: "AnalyzeResult", out_dir: str) -> List[str]:
    """Static result plots mirroring the reference's debug_plot_output set
    (`main.py:531-565,660-719`): delta power vs adaptive threshold with
    detection spans, duration / dB histograms, and detections per hour.
    Requires matplotlib (optional dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    times = np.arange(len(res.delta_power)) * res.block_duration_sec

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(times, res.delta_power, label="Delta Power")
    ax.plot(times, res.thresholds, label="Adaptive Threshold", linestyle="--", color="red")
    for det in res.detections:
        ax.axvspan(det.t_start, det.t_stop, color="orange", alpha=0.5)
    ax.set_xlabel("Zeit (s)")
    ax.set_ylabel("Leistung (dB)")
    ax.legend()
    ax.grid(True)
    fig.tight_layout()
    p = os.path.join(out_dir, "delta_threshold.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    written.append(p)

    for name, vals, xlabel in [
        ("hist_duration", [d.dur_s for d in res.detections], "Duration (s)"),
        ("hist_db", [d.dB for d in res.detections], "dB"),
    ]:
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.hist(vals, bins=30, alpha=0.7)
        ax.set_xlabel(xlabel)
        ax.set_ylabel("Count")
        ax.grid(True)
        fig.tight_layout()
        p = os.path.join(out_dir, f"{name}.png")
        fig.savefig(p, dpi=150)
        plt.close(fig)
        written.append(p)

    hours = {}
    for det in res.detections:
        if det.utc_start is not None:
            h = det.utc_start.replace(minute=0, second=0, microsecond=0)
            hours[h] = hours.get(h, 0) + 1
    if hours:
        keys = sorted(hours)
        fig, ax = plt.subplots(figsize=(12, 6))
        ax.bar([k.strftime("%Y-%m-%d %H:%M") for k in keys], [hours[k] for k in keys],
               color="skyblue")
        ax.set_xlabel("UTC Zeit (Datum + Stunde)")
        ax.set_ylabel("Anzahl der Detektionen")
        ax.set_title("Detektionen pro Stunde")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        fig.tight_layout()
        p = os.path.join(out_dir, "per_hour.png")
        fig.savefig(p, dpi=150)
        plt.close(fig)
        written.append(p)
    return written


def parse_gqrx_start_time(file_path: str) -> Optional[datetime.datetime]:
    """UTC start time from gqrx-style filenames (`main.py:858-863`)."""
    name = os.path.basename(file_path)
    m = re.search(r"(\d{8})_(\d{6})", name)
    if m:
        return datetime.datetime.strptime(m.group(1) + "-" + m.group(2), "%Y%m%d-%H%M%S")
    return None


def proc_wav_file(
    file_path: str,
    block_duration_sec: float = 0.2,
    freq_band: Tuple[float, float] = (993.0, 1013.0),
    noise_band: Tuple[float, float] = (690.0, 710.0),
    n_fft: int = 512,
    threshold_std_factor: float = 4.0,
    wav_start_sec: Optional[float] = None,
    wav_end_sec: Optional[float] = None,
    out_audacity_lbl_file: Optional[str] = None,
    out_csv_file: Optional[str] = None,
    outfile_path: Optional[str] = None,
    wav_start_date_time: Optional[datetime.datetime] = None,
    flag_adaptive_threshold: bool = True,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_detection_sec: float = 3.0,
    threshold_freeze_after_detection_sec: float = 20.0,
    threshold_fixed_init_duration_sec: float = 10.0,
    expected_sample_rate: Optional[int] = 6000,
    max_events: int = 4096,
    verbose: bool = True,
) -> AnalyzeResult:
    """Same signature family as the reference ``proc_wav_file``
    (`main.py:207-229`), including the n_fft doubling (`main.py:353`)."""
    timer = PhaseTimer(log=False)

    with timer.phase("read_wav"):
        fs, data = read_wav(file_path, mono=True)
    if expected_sample_rate is not None and fs != expected_sample_rate:
        raise ValueError(f"Sample rate must be {expected_sample_rate} Hz, got {fs}")

    if wav_start_sec is not None or wav_end_sec is not None:
        s = int((wav_start_sec or 0) * fs)
        e = int((wav_end_sec if wav_end_sec is not None else len(data) / fs) * fs)
        data = data[s:e]

    n_fft_eff = n_fft * 2  # reference doubles the user n_fft (main.py:353)
    block_size = int(fs * block_duration_sec)
    if verbose:
        print(f"Wav duration [sec]: {len(data) / fs}")
        print(f"n_fft [real]: {n_fft}  ->  effective {n_fft_eff}")
        print(f"Wav block size in samples: {block_size}")
        print(f"Number of wav blocks: {len(data) // block_size}")

    with timer.phase("band_power+detect"):
        x = jnp.asarray(np.asarray(data, dtype=np.float32))
        band_db, noise_db, delta = delta_power_db(
            x, fs, n_fft_eff, block_size, freq_band, noise_band
        )
        if flag_adaptive_threshold:
            events, thresholds = detect_adaptive(
                delta,
                threshold_std_factor,
                block_duration_sec,
                threshold_estimation_window_sec,
                threshold_freeze_before_detection_sec,
                threshold_freeze_after_detection_sec,
                threshold_fixed_init_duration_sec,
                cap=max_events,
            )
        else:
            events, thr = detect_fixed(delta, threshold_std_factor, cap=max_events)
            thresholds = jnp.broadcast_to(thr, delta.shape)
        jax.block_until_ready((events, thresholds))

    dets = events_to_detections(events, block_duration_sec, wav_start_date_time)
    if bool(events.overflow):
        print(f"WARNING: event buffer overflow — more than {max_events} events, extras dropped")

    if verbose:
        for det in dets:
            print(
                f"Detection from {det.t_start:.2f} to {det.t_stop:.2f} seconds, "
                f"dB: {det.dB:.2f} dB, duration: {det.dur_s:.2f} seconds "
                f"UTC_START: {det.utc_start}, UTC_STOP: {det.utc_stop}"
            )

    if out_audacity_lbl_file:
        write_audacity_labels(out_audacity_lbl_file, dets)
        print("Wrote Items", len(dets), "to Audacity LBL file")
    if out_csv_file:
        write_event_csv(out_csv_file, dets)
        print("Wrote Items", len(dets), "to CSV file:", out_csv_file)
    if outfile_path:
        with timer.phase("spec_export"):
            wav_np = np.asarray(data, dtype=np.float32)
            for det in dets:
                export_detection_spec(
                    outfile_path, det, wav_np, fs, n_fft=1024, freq_band=freq_band
                )

    return AnalyzeResult(
        detections=dets,
        band_power=np.asarray(band_db),
        noise_power=np.asarray(noise_db),
        delta_power=np.asarray(delta),
        thresholds=np.asarray(thresholds),
        sample_rate=fs,
        block_duration_sec=block_duration_sec,
        timer=timer,
    )


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("wav")
    p.add_argument("--signal-freq", type=float, default=1003.0)
    p.add_argument("--noise-freq", type=float, default=700.0)
    p.add_argument("--bandwidth", type=float, default=10.0)
    p.add_argument("--block-duration", type=float, default=0.2)
    p.add_argument("--n-fft", type=int, default=512)
    p.add_argument("--threshold-std-factor", type=float, default=4.0)
    p.add_argument("--fixed-threshold", action="store_true", help="disable adaptive threshold")
    p.add_argument("--start-sec", type=float, default=None)
    p.add_argument("--end-sec", type=float, default=None)
    p.add_argument("--sample-rate", type=int, default=None, help="expected rate (default: accept any)")
    p.add_argument("--out-csv", default=None)
    p.add_argument("--out-audacity", default=None)
    p.add_argument("--out-spec-dir", default=None)
    p.add_argument("--plot-dir", default=None, help="write delta/threshold + histogram plots")
    args = p.parse_args(argv)
    enable_compile_cache()

    bw = args.bandwidth
    res = proc_wav_file(
        args.wav,
        block_duration_sec=args.block_duration,
        freq_band=(args.signal_freq - bw, args.signal_freq + bw),
        noise_band=(args.noise_freq - bw, args.noise_freq + bw),
        n_fft=args.n_fft,
        threshold_std_factor=args.threshold_std_factor,
        wav_start_sec=args.start_sec,
        wav_end_sec=args.end_sec,
        out_csv_file=args.out_csv,
        out_audacity_lbl_file=args.out_audacity,
        outfile_path=args.out_spec_dir,
        wav_start_date_time=parse_gqrx_start_time(args.wav),
        flag_adaptive_threshold=not args.fixed_threshold,
        expected_sample_rate=args.sample_rate,
    )
    if args.plot_dir:
        for w in export_debug_plots(res, args.plot_dir):
            print("wrote", w)
    print(f"Found {len(res.detections)} detections")
    print(res.timer.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
