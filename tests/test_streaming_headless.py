"""Headless (bins-only) streaming front half: numerics delta vs the Welch
path quantified, and event-list agreement pinned on a burst fixture
(VERDICT r1 item 7 — the measured attempt at the 58 ms/h Welch front)."""

import numpy as np

import jax.numpy as jnp

from meteor_scatter_tpu.config import DetectionConfig
from meteor_scatter_tpu.models.streaming import (
    StreamConfig,
    stream_front,
    stream_front_headless,
    stream_init,
    stream_process,
)


def make_audio(fs=4000, dur=90.0, seed=21):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * dur)) / fs
    x = rng.standard_normal(len(t)).astype(np.float32) * 0.05
    for s, l, a in [(15.0, 1.0, 0.6), (35.0, 2.0, 0.5), (60.0, 0.8, 0.7)]:
        m = (t >= s) & (t < s + l)
        x[m] += a * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return x


CFG = DetectionConfig(
    signal_freq=1000, detection_db_over_noise_mean_min=1, detection_dur_min_sec=0.5
)


class TestHeadlessFront:
    def test_band_levels_match_welch(self):
        fs = 4000
        x = jnp.asarray(make_audio(fs))
        on_w, pm_w, dg_w = stream_front(CFG, x, fs)
        on_b, pm_b, dg_b = stream_front_headless(CFG, x, fs)
        assert on_b.shape == on_w.shape
        # per-band dB levels equal to f32 reduction-order noise
        for key in ("ms_db", "noise1_db", "noise2_db"):
            d = np.max(np.abs(np.asarray(dg_b[key]) - np.asarray(dg_w[key])))
            assert d < 5e-3, f"{key}: max delta {d} dB"
        d_on = np.max(np.abs(np.asarray(on_b) - np.asarray(on_w)))
        assert d_on < 5e-3, f"over_noise delta {d_on} dB"
        # headless carries no PSD: auto-gain input is zeroed by contract
        assert np.all(np.asarray(pm_b) == 0.0)

    def test_event_lists_agree_on_fixture(self):
        fs = 4000
        x = jnp.asarray(make_audio(fs))

        def run(front):
            st = stream_init(StreamConfig.from_config(CFG))
            _, ev, _ = stream_process(CFG, st, x, fs, front=front)
            c = int(ev.count)
            return [
                (
                    round(float(ev.time_start[k]), 6),
                    round(float(ev.time_stop[k]), 6),
                    round(float(ev.db_mean[k]), 3),
                )
                for k in range(c)
            ]

        w = run("welch")
        b = run("bins")
        assert len(w) >= 3
        assert [e[:2] for e in w] == [e[:2] for e in b]  # same extents
        for (_, _, mw), (_, _, mb) in zip(w, b):
            assert abs(mw - mb) < 1e-2  # dB means within numeric noise

    def test_unknown_front_rejected(self):
        import pytest

        st = stream_init(StreamConfig.from_config(CFG))
        with pytest.raises(ValueError):
            stream_process(CFG, st, jnp.zeros(4000), 4000, front="fft")


def test_preblocked_input_equals_flat():
    """(..., n_blocks, block) pre-blocked audio (the throughput form,
    see models/streaming.py::_blocked) must produce bit-identical band
    series to the flat (..., S) form in both fronts."""
    import jax.numpy as jnp
    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import (
        stream_front,
        stream_front_headless,
    )

    fs = 4000
    cfg = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    block = int(round(cfg.proc_block_sec * fs))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 40 * block)).astype(np.float32)
    x3 = x.reshape(3, 40, block)
    for front in (stream_front_headless, stream_front):
        on_f, pm_f, _ = front(cfg, jnp.asarray(x), fs)
        on_b, pm_b, _ = front(cfg, jnp.asarray(x3), fs)
        np.testing.assert_array_equal(np.asarray(on_f), np.asarray(on_b))
        np.testing.assert_array_equal(np.asarray(pm_f), np.asarray(pm_b))
