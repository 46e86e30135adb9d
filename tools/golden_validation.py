"""Golden cross-validation against the ORIGINAL reference implementation.

Runs th-nuernberg/meteor-scatter's own code (batch ``proc_wav_file`` and the
streaming ``wav_file_process``) side by side with this framework on shared
synthetic recordings and compares the detection lists.  Requires a checkout
of the reference repo (``--reference-path``); missing reference
dependencies (plotly, soundfile) are stubbed since plots stay disabled.

Result recorded in VALIDATION.md: detection-for-detection equality.

Usage::

    python tools/golden_validation.py --reference-path /root/reference
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stub_missing_reference_deps():
    import scipy.io.wavfile as wav

    if "plotly" not in sys.modules:
        plotly = types.ModuleType("plotly")
        go = types.ModuleType("plotly.graph_objects")

        class _Stub:
            def __getattr__(self, k):
                return _Stub()

            def __call__(self, *a, **k):
                return _Stub()

        go.Figure = _Stub
        go.Scatter = _Stub
        plotly.graph_objects = go
        sys.modules["plotly"] = plotly
        sys.modules["plotly.graph_objects"] = go

    if "soundfile" not in sys.modules:
        sf = types.ModuleType("soundfile")

        def sf_read(path, start=0, stop=None, **kw):
            fs, data = wav.read(path)
            if data.dtype == np.int16:
                data = data.astype(np.float64) / 32768.0
            if stop is not None:
                data = data[int(start) : int(stop)]
            elif start:
                data = data[int(start) :]
            return data, fs

        sf.read = sf_read
        sys.modules["soundfile"] = sf


def make_batch_wav(path: str):
    import scipy.io.wavfile as wav

    fs = 6000
    rng = np.random.default_rng(12)
    t = np.arange(int(fs * 600)) / fs
    x = rng.standard_normal(len(t)) * 0.4
    truth = []
    for s, l, a in [(30, 1.2, 1.5), (95, 0.4, 2.0), (180, 3.0, 1.0),
                    (260, 0.8, 2.5), (400, 1.5, 1.2), (520, 0.5, 1.8)]:
        m = (t >= s) & (t < s + l)
        x[m] += a * np.sin(2 * np.pi * 1003.0 * t[m])
        truth.append((s, l))
    wav.write(path, fs, (x * 8000).astype(np.int16))
    return truth


def make_stream_wav(path: str):
    import scipy.io.wavfile as wav

    fs = 4000
    rng = np.random.default_rng(5)
    t = np.arange(int(fs * 120)) / fs
    x = rng.standard_normal(len(t)) * 0.05
    for s, l, a in [(30, 1.0, 0.5), (60, 2.0, 0.4), (90, 0.7, 0.6)]:
        m = (t >= s) & (t < s + l)
        x[m] += a * np.sin(2 * np.pi * 1020.0 * t[m])
    wav.write(path, fs, (x * 20000).astype(np.int16))


def run_batch(ref_path: str, wav_path: str):
    sys.path.insert(0, os.path.join(ref_path, "dsp", "src"))
    import importlib

    ref_main = importlib.import_module("main")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_main.proc_wav_file(
            wav_path,
            block_duration_sec=0.2,
            freq_band=(993.0, 1013.0),
            noise_band=(690.0, 710.0),
            n_fft=512,
            threshold_std_factor=4,
            flag_adaptive_threshold=True,
            disable_show_and_write=True,
        )
    ref = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"Detection from ([\d.]+) to ([\d.]+) seconds, dB: ([-\d.]+)", line)
        if m:
            ref.append((float(m.group(1)), float(m.group(2)), float(m.group(3))))

    from meteor_scatter_tpu.apps.analyze import proc_wav_file as ours_fn

    res = ours_fn(wav_path, verbose=False)
    ours = [
        (round(d.t_start, 2), round(d.t_stop, 2), round(d.dB, 2))
        for d in res.detections
    ]
    return ref, ours


def run_stream(ref_path: str, wav_path: str):
    sys.path.insert(0, os.path.join(ref_path, "dsp", "src", "live"))
    from backend import processor as ref_proc
    from backend.aggregates import ConfigDetection, ConfigSpecExport, ConfigVisualization

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_proc.wav_file_process(
            wav_path,
            config_detection=ConfigDetection(
                proc_block_sec=0.2, n_fft=4096, signal_freq=1020,
                detection_db_over_noise_mean_min=1, detection_dur_min_sec=0.5,
            ),
            config_visualization=ConfigVisualization(enable_ui_plots=False),
            config_spec_export=ConfigSpecExport(output_dir=""),
        )
    ref = []
    for line in buf.getvalue().splitlines():
        # only the live-detection lines — the reference re-prints non-exported
        # events in a summary dump at the end (processor.py:540-543)
        if not line.startswith("Detected Meteor:"):
            continue
        m = re.search(r"time_start=([\d.]+), time_stop=([\d.]+)", line)
        if m:
            ref.append((float(m.group(1)), float(m.group(2))))

    from meteor_scatter_tpu.apps.live import wav_file_process as ours_fn
    from meteor_scatter_tpu.config import DetectionConfig

    def run_ours(impl):
        with contextlib.redirect_stdout(io.StringIO()):
            events = ours_fn(
                wav_path,
                DetectionConfig(
                    proc_block_sec=0.2, n_fft=4096, signal_freq=1020,
                    detection_db_over_noise_mean_min=1, detection_dur_min_sec=0.5,
                ),
                impl=impl,
            )
        return [(round(e["time_start"], 2), round(e["time_stop"], 2)) for e in events]

    return ref, run_ours("scan"), run_ours("jump"), run_ours("hop"), run_ours("fused")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reference-path", default="/root/reference")
    p.add_argument("--tmp", default="/tmp")
    args = p.parse_args()

    os.environ.setdefault("MPLBACKEND", "Agg")
    # run on CPU: deterministic, and the reference formulations are the
    # CPU defaults (numerics are identical f32 either way)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    _stub_missing_reference_deps()

    ok = True

    batch_wav = os.path.join(args.tmp, "golden_batch.wav")
    make_batch_wav(batch_wav)
    ref, ours = run_batch(args.reference_path, batch_wav)
    def batch_match(o):
        return len(ref) == len(o) and all(
            abs(r[0] - x[0]) < 0.01 and abs(r[1] - x[1]) < 0.01 and abs(r[2] - x[2]) <= 0.02
            for r, x in zip(ref, o)
        )
    match = batch_match(ours)
    print(f"BATCH: reference={len(ref)} ours={len(ours)} match={match}")
    for r, o in zip(ref, ours):
        print(f"  ref {r}  ours {o}")
    ok &= match
    per_case = [([(r[0], r[1]) for r in ref], [(o[0], o[1]) for o in ours])]

    stream_wav = os.path.join(args.tmp, "golden_stream.wav")
    make_stream_wav(stream_wav)
    ref, ours, ours_jump, ours_hop, ours_fused = run_stream(
        args.reference_path, stream_wav
    )
    per_case.append(([(r[0], r[1]) for r in ref], [(o[0], o[1]) for o in ours]))
    match = ref == ours
    print(f"STREAM: reference={len(ref)} ours={len(ours)} match={match}")
    for r, o in zip(ref, ours):
        print(f"  ref {r}  ours {o}")
    ok &= match
    match_jump = ref == ours_jump
    print(f"STREAM (impl=jump): ours={len(ours_jump)} match={match_jump}")
    ok &= match_jump
    match_hop = ref == ours_hop
    print(f"STREAM (impl=hop): ours={len(ours_hop)} match={match_hop}")
    ok &= match_hop
    match_fused = ref == ours_fused
    print(f"STREAM (impl=fused): ours={len(ours_fused)} match={match_fused}")
    ok &= match_fused

    # detection F1 vs the reference event lists (BASELINE.json primary
    # metric).  Matching is per case (batch and stream come from unrelated
    # WAVs — pooling intervals across cases would let cross-case
    # coincidences count); precision counts matched OUR events, recall
    # counts matched REFERENCE events, so duplicates can't inflate recall.
    def overlaps(a, b):
        return a[0] < b[1] and b[0] < a[1]

    matched_ours = sum(
        1 for case_r, case_o in per_case for o in case_o
        if any(overlaps(o, r) for r in case_r)
    )
    matched_ref = sum(
        1 for case_r, case_o in per_case for r in case_r
        if any(overlaps(o, r) for o in case_o)
    )
    n_ours = sum(len(o) for _, o in per_case)
    n_ref = sum(len(r) for r, _ in per_case)
    prec = matched_ours / n_ours if n_ours else 1.0
    rec = matched_ref / n_ref if n_ref else 1.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    print(f"F1 vs reference detections: {f1:.4f} "
          f"(precision {prec:.4f}, recall {rec:.4f}, {matched_ref}/{n_ref} events)")

    print("GOLDEN VALIDATION:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
