"""Streaming detector CLI — accelerator re-design of `dsp/src/live/main.py` +
`processor.py:14` (``wav_file_process``).

Audio is consumed in chunks (bounded memory, like the reference's block
loop) but each chunk's Welch PSDs and band levels are computed as one
batched device program; only the 3-state decision scan is sequential.
Per-event waterfall PNGs are exported once the ±context window fits the
ring buffer, with the auto-gained dB range from the initialization phase
(`processor.py:294-343`).

Usage::

    python -m meteor_scatter_tpu.apps.live recording.wav \
        --signal-freq 1020 --min-dur 0.5 --min-mean-db 1 \
        --spec-export-dir spec_export/
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from meteor_scatter_tpu.config import DetectionConfig, SpecExportConfig, VisualizationConfig
from meteor_scatter_tpu.io.spec_export import export_waterfall_window
from meteor_scatter_tpu.io.wavio import read_wav
from meteor_scatter_tpu.models.streaming import StreamConfig, stream_init, stream_process
from meteor_scatter_tpu.platform import enable_compile_cache
from meteor_scatter_tpu.ops.welch import welch_freqs


class LiveSession:
    """Stateful wrapper: feed audio chunks, collect DetectedMeteor dicts.

    Keeps the waterfall ring (`processor.py:223-229`) and the pending
    export queue (`processor.py:294-343`) on the host; detection state on
    device.
    """

    def __init__(
        self,
        cfg: DetectionConfig,
        fs: float,
        vis: Optional[VisualizationConfig] = None,
        spec: Optional[SpecExportConfig] = None,
        headless: bool = False,
        impl: str = "auto",
    ):
        self.cfg = cfg
        self.fs = fs
        # bins-only front half (no PSD waterfall, no spec export, no UI) —
        # opt-in throughput mode, see models/streaming.py stream_front_headless
        self.headless = headless and not (vis and vis.enable_ui_plots) and not (
            spec and spec.output_dir
        )
        # block-rate solver: "auto" (backend-dependent fast path, see
        # models/streaming.py resolve_stream_auto), "scan" (reference
        # formulation), the episode-jump fast paths "jump"/"hop", or the
        # batch-built Pallas kernel "fused"
        self.impl = impl
        self.vis = vis or VisualizationConfig()
        self.spec = spec or SpecExportConfig()
        self.state = stream_init(StreamConfig.from_config(cfg))
        self.block_samples = int(round(cfg.proc_block_sec * fs))
        self.wf_win = int(self.vis.max_range_sec / cfg.proc_block_sec)
        self.freqs = welch_freqs(fs, cfg.n_fft)
        self.wf_db: List[np.ndarray] = []
        self.wf_times: List[float] = []
        self.events: List[dict] = []
        self._pending_export: List[dict] = []
        self._blocks_fed = 0

    def feed(self, samples: np.ndarray) -> List[dict]:
        """Process a chunk (any whole number of blocks).  Returns events
        completed within this chunk."""
        n_blocks = len(samples) // self.block_samples
        if n_blocks == 0:
            return []
        usable = n_blocks * self.block_samples
        self.block_offset_before_feed = self._blocks_fed
        self.state, events, diags = stream_process(
            self.cfg, self.state, jnp.asarray(samples[:usable], jnp.float32), self.fs,
            front="bins" if self.headless else "welch",
            impl=self.impl,
        )
        self.last_diags = diags

        # waterfall ring (headless mode computes no PSD)
        if not self.headless:
            psd_db = np.asarray(diags["psd_db"])
            for b in range(n_blocks):
                self.wf_db.append(psd_db[b])
                self.wf_times.append((self._blocks_fed + b + 1) * self.cfg.proc_block_sec)
            self.wf_db = self.wf_db[-self.wf_win :]
            self.wf_times = self.wf_times[-self.wf_win :]
        self._blocks_fed += n_blocks

        new = []
        cnt = int(events.count)
        for i in range(cnt):
            ev = dict(
                time_start=float(events.time_start[i]),
                time_stop=float(events.time_stop[i]),
                duration=float(events.duration[i]),
                db_min=float(events.db_min[i]),
                db_max=float(events.db_max[i]),
                db_mean=float(events.db_mean[i]),
                db_std=float(events.db_std[i]),
            )
            new.append(ev)
            self.events.append(ev)
            if self.spec.output_dir:
                self._pending_export.append(ev)
        if bool(events.overflow):
            print("WARNING: per-chunk event buffer overflow")
        self._try_exports()
        return new

    def _try_exports(self) -> None:
        psd_mean = float(self.state.psd_db_mean_from_init)
        still = []
        for ev in self._pending_export:
            path = export_waterfall_window(
                self.spec.output_dir,
                np.asarray(self.wf_db),
                self.freqs,
                self.wf_times,
                ev["time_start"],
                ev["time_stop"],
                self.cfg.signal_freq,
                limit_freq_offset=self.vis.limit_freq_offset_wf2_and_export,
                vmin=psd_mean - self.vis.wf_offset_vmin,
                vmax=psd_mean + self.vis.wf_offset_vmax,
                time_before_sec=self.spec.time_before_meteor_sec,
                time_after_sec=self.spec.time_after_meteor_sec,
            )
            if path is None:
                still.append(ev)  # window not yet inside the ring
            elif self.vis.enable_debug_logs:
                print(f"Saved Meteor to {path}")
        self._pending_export = still


def wav_file_process(
    wav_file_path: str,
    config_detection: DetectionConfig,
    config_visualization: Optional[VisualizationConfig] = None,
    config_spec_export: Optional[SpecExportConfig] = None,
    wav_file_start_sec: float = 0,
    wav_file_stop_sec: float = -1,
    chunk_sec: float = 60.0,
    expected_sample_rate: Optional[int] = 4000,
    headless: bool = False,
    impl: str = "auto",
) -> List[dict]:
    """Reference-compatible entry point (`processor.py:14-21`)."""
    fs, data = read_wav(wav_file_path, mono=True)
    if expected_sample_rate is not None and fs != expected_sample_rate:
        raise ValueError(f"Invalid Sample Rate: {fs}")
    s = int(wav_file_start_sec * fs)
    e = len(data) if wav_file_stop_sec == -1 else int(wav_file_stop_sec * fs)
    data = data[s:e]
    if data.dtype == np.int16:
        # match soundfile.read's float scaling for PCM input
        data = data.astype(np.float32) / 32768.0
    data = np.asarray(data, dtype=np.float32)

    vis = config_visualization or VisualizationConfig()
    sess = LiveSession(config_detection, fs, vis, config_spec_export,
                       headless=headless, impl=impl)
    view = None
    if vis.enable_ui_plots:
        from meteor_scatter_tpu.apps.live_view import LiveView

        view = LiveView(config_detection, vis, fs, sess.freqs)
        # UI pacing works best on ~1 s chunks
        chunk_sec = min(chunk_sec, 1.0)
    chunk = int(chunk_sec * fs)
    chunk -= chunk % sess.block_samples
    # a chunk_sec below one processing block (e.g. --ui clamps to 1 s while
    # --block-sec 2) would round to zero and make range() raise — feed at
    # least one whole block per chunk
    chunk = max(chunk, sess.block_samples)
    for i in range(0, len(data), chunk):
        new = sess.feed(data[i : i + chunk])
        for ev in new:
            print(
                f"Detected Meteor: start={ev['time_start']:.2f}s stop={ev['time_stop']:.2f}s "
                f"dur={ev['duration']:.2f}s dB mean={ev['db_mean']:.2f} "
                f"min={ev['db_min']:.2f} max={ev['db_max']:.2f} std={ev['db_std']:.2f} "
                f"// total {len(sess.events)}"
            )
        if view is not None:
            if int(sess.state.state) != 0:  # auto-gain only after Initialization
                view.psd_mean_from_init = float(sess.state.psd_db_mean_from_init)
            view.update(sess.last_diags, sess.block_offset_before_feed, new)
    if view is not None:
        view.finish()
    return sess.events


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("wav")
    p.add_argument("--signal-freq", type=float, default=1000.0)
    p.add_argument("--channel-width", type=float, default=100.0)
    p.add_argument("--noise-offset", type=float, default=300.0)
    p.add_argument("--block-sec", type=float, default=0.2)
    p.add_argument("--n-fft", type=int, default=4096)
    p.add_argument("--min-dur", type=float, default=-1.0)
    p.add_argument("--min-mean-db", type=float, default=-1.0)
    p.add_argument("--start-sec", type=float, default=0.0)
    p.add_argument("--stop-sec", type=float, default=-1.0)
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--spec-export-dir", default="")
    p.add_argument("--ui", action="store_true", help="live 3x2 dashboard (needs matplotlib GUI)")
    p.add_argument("--realtime-factor", type=float, default=16.0)
    p.add_argument("--headless", action="store_true",
                   help="bins-only front half (no PSD waterfall/exports/UI); "
                        "band numerics within f32 noise of the Welch path")
    p.add_argument("--impl", choices=("auto", "scan", "jump", "hop", "fused"),
                   default="auto",
                   help="block-rate solver: reference-formulation scan, the "
                        "episode-jump fast paths — 'jump' (full-series "
                        "searches) or 'hop' (windowed; both give bit-exact "
                        "event boundaries, dB stats to f32 reduction order) — "
                        "or 'fused' (the Pallas streaming-machine kernel, "
                        "bit-exact vs the vmapped scan; built for wide "
                        "station batches)")
    args = p.parse_args(argv)
    enable_compile_cache()
    if args.headless and (args.ui or args.spec_export_dir):
        p.error("--headless excludes --ui and --spec-export-dir (both need the PSD waterfall)")

    cfg = DetectionConfig(
        proc_block_sec=args.block_sec,
        n_fft=args.n_fft,
        signal_freq=args.signal_freq,
        channel_width=args.channel_width,
        noise_channel_offset=args.noise_offset,
        detection_dur_min_sec=args.min_dur,
        detection_db_over_noise_mean_min=args.min_mean_db,
    )
    spec = SpecExportConfig(output_dir=args.spec_export_dir)
    vis = VisualizationConfig(enable_ui_plots=args.ui, realtime_factor=args.realtime_factor)
    if args.spec_export_dir:
        os.makedirs(args.spec_export_dir, exist_ok=True)
    events = wav_file_process(
        args.wav,
        cfg,
        config_visualization=vis,
        config_spec_export=spec,
        wav_file_start_sec=args.start_sec,
        wav_file_stop_sec=args.stop_sec,
        expected_sample_rate=args.sample_rate,
        headless=args.headless,
        impl=args.impl,
    )
    print(f"Total detected meteors: {len(events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
