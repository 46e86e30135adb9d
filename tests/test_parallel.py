"""Sharded == unsharded equality on an 8-virtual-device CPU mesh
(SURVEY.md §4 plan item 3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.ops.bandpower import delta_power_db
from meteor_scatter_tpu.ops.fir import fir_filter, firwin_bandpass
from meteor_scatter_tpu.ops.spectrogram import spectrogram_scipy
from meteor_scatter_tpu.models.adaptive import adaptive_thresholds
from meteor_scatter_tpu.parallel.mesh import make_mesh
from meteor_scatter_tpu.parallel.sharded import (
    sharded_delta_power,
    sharded_detect_adaptive,
    sharded_detect_fixed,
    sharded_fir_filter,
    sharded_spectrogram_psd,
)

FS = 6000
BLOCK = 1200
NFFT = 1024
FB = (993.0, 1013.0)
NB = (690.0, 710.0)


def audio(channels, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    x = rng.standard_normal((channels, len(t))) * 0.5
    for c in range(channels):
        s = 3.0 + 5 * c
        m = (t >= s) & (t < s + 1.0)
        x[c, m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m])
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh(n_station=2, n_time=4)


class TestShardedDeltaPower:
    def test_equals_unsharded(self, mesh):
        x = audio(2, 16.0)
        b, n, d = sharded_delta_power(jnp.asarray(x), mesh, FS, NFFT, BLOCK, FB, NB)
        for c in range(2):
            _, _, want = delta_power_db(jnp.asarray(x[c]), FS, NFFT, BLOCK, FB, NB)
            np.testing.assert_allclose(np.asarray(d[c]), np.asarray(want), atol=1e-4)


class TestShardedFixed:
    def test_equals_unsharded(self, mesh):
        x = audio(2, 16.0)
        _, _, d = sharded_delta_power(jnp.asarray(x), mesh, FS, NFFT, BLOCK, FB, NB)
        above, thr = sharded_detect_fixed(d, mesh, 4.0)
        d_np = np.asarray(d)
        for c in range(2):
            want_thr = d_np[c].mean() + 4.0 * d_np[c].std()
            np.testing.assert_allclose(float(thr[c]), want_thr, rtol=1e-5)
            np.testing.assert_array_equal(np.asarray(above[c]), d_np[c] > want_thr)


class TestShardedAdaptive:
    def test_shard0_exact_and_rest_converged(self, mesh):
        x = audio(2, 32.0, seed=3)
        _, _, d = sharded_delta_power(jnp.asarray(x), mesh, FS, NFFT, BLOCK, FB, NB)
        kw = dict(
            threshold_std_factor=4.0,
            window_blocks=25,
            freeze_blocks_before=3,
            freeze_blocks_after=10,
            fixed_threshold_blocks=10,
        )
        thr_s, above_s = sharded_detect_adaptive(d, mesh, **kw)
        d_np = np.asarray(d)
        b_loc = d_np.shape[1] // 4
        for c in range(2):
            thr_u, above_u, _ = adaptive_thresholds(jnp.asarray(d_np[c]), **kw)
            # shard 0 must be bit-exact
            np.testing.assert_allclose(
                np.asarray(thr_s[c, :b_loc]), np.asarray(thr_u[:b_loc]), rtol=1e-6
            )
            # overall: warm-up halo (window+freeze=35 < b_loc) converges the
            # rolling stats → expect equality everywhere on this data
            np.testing.assert_array_equal(np.asarray(above_s[c]), np.asarray(above_u))

    def test_shard0_exact_with_negative_fixed_threshold(self, mesh):
        """A channel whose fixed threshold is negative (signal band below
        the noise bands → delta mostly negative) must still match the
        unsharded scan on shard 0: the warm-up replay runs over shard 0's
        zero-filled halo, and 0 > fixed_thr would register phantom
        detections there, freezing real early blocks the unsharded scan
        thresholds normally (round-5 review finding)."""
        rng = np.random.default_rng(9)
        # delta series centered well below zero: g_mean + k*g_std < 0
        d_np = (rng.standard_normal((2, 4 * 60)) * 0.5 - 8.0).astype(np.float32)
        d = jnp.asarray(d_np)
        kw = dict(
            threshold_std_factor=4.0,
            window_blocks=25,
            freeze_blocks_before=3,
            freeze_blocks_after=40,  # > fixed_threshold_blocks: phantom
            fixed_threshold_blocks=10,  # freezes would reach real blocks
        )
        thr_s, above_s = sharded_detect_adaptive(d, mesh, **kw)
        b_loc = d_np.shape[1] // 4
        for c in range(2):
            assert d_np[c].mean() + 4.0 * d_np[c].std() < 0  # the trigger
            thr_u, above_u, _ = adaptive_thresholds(jnp.asarray(d_np[c]), **kw)
            # rtol 2e-5: the sharded global stats (psum of shard sums) and
            # jnp.mean differ in f32 reduction order on the fixed threshold
            np.testing.assert_allclose(
                np.asarray(thr_s[c, :b_loc]), np.asarray(thr_u[:b_loc]), rtol=2e-5
            )
            np.testing.assert_array_equal(
                np.asarray(above_s[c, :b_loc]), np.asarray(above_u[:b_loc])
            )

    def test_full_reference_window_single_time_shard(self):
        # station-only mesh: 8 channels, no time sharding — always exact
        mesh = make_mesh(n_station=8, n_time=1)
        x = audio(8, 8.0, seed=5)
        _, _, d = sharded_delta_power(jnp.asarray(x), mesh, FS, NFFT, BLOCK, FB, NB)
        kw = dict(
            threshold_std_factor=4.0,
            window_blocks=600,
            freeze_blocks_before=15,
            freeze_blocks_after=100,
            fixed_threshold_blocks=50,
        )
        thr_s, above_s = sharded_detect_adaptive(d, mesh, **kw)
        for c in range(8):
            thr_u, above_u, _ = adaptive_thresholds(jnp.asarray(np.asarray(d)[c]), **kw)
            np.testing.assert_allclose(np.asarray(thr_s[c]), np.asarray(thr_u), rtol=1e-6)
            np.testing.assert_array_equal(np.asarray(above_s[c]), np.asarray(above_u))


class TestShardedSpectrogram:
    def test_equals_unsharded_overlap(self, mesh):
        x = audio(2, 16.0, seed=1)
        nper = 3000  # hop 1500 divides the 24000-sample shards
        got = sharded_spectrogram_psd(jnp.asarray(x), mesh, FS, nper)
        for c in range(2):
            _, _, want = spectrogram_scipy(jnp.asarray(x[c]), FS, nper)
            want = np.asarray(want)  # (bins, frames)
            nf = want.shape[1]
            got_c = np.asarray(got[c])[:nf].T  # (bins, frames)
            np.testing.assert_allclose(got_c, want, rtol=2e-3, atol=1e-9)

    @pytest.mark.parametrize("nper,nov", [(511, 256), (600, 388), (2048, 1024)])
    def test_hop_not_dividing_shards(self, mesh, nper, nov):
        # hop ∤ 24000-sample shards: frame ownership straddles shard seams,
        # exercising the offset-table + compaction path; frame count and
        # values must equal the unsharded run exactly
        x = audio(2, 16.0, seed=4)
        got = sharded_spectrogram_psd(jnp.asarray(x), mesh, FS, nper, noverlap=nov)
        for c in range(2):
            _, _, want = spectrogram_scipy(jnp.asarray(x[c]), FS, nper, noverlap=nov)
            want = np.asarray(want)
            assert got[c].shape[0] == want.shape[1]  # exact global frame count
            np.testing.assert_allclose(
                np.asarray(got[c]).T, want, rtol=2e-3, atol=1e-9
            )


class TestShardedFIR:
    def test_equals_unsharded(self, mesh):
        x = audio(2, 8.0, seed=2)
        taps = firwin_bandpass(101, 950.0, 1050.0, FS)
        got = sharded_fir_filter(jnp.asarray(x), mesh, taps)
        want = fir_filter(jnp.asarray(x), taps, mode="same")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


class TestShardedAdaptiveExact:
    def test_bit_exact_everywhere(self, mesh):
        from meteor_scatter_tpu.models.adaptive import adaptive_thresholds_parallel
        from meteor_scatter_tpu.parallel.sharded import sharded_detect_adaptive_exact

        x = audio(2, 32.0, seed=8)
        _, _, d = sharded_delta_power(jnp.asarray(x), mesh, FS, NFFT, BLOCK, FB, NB)
        kw = dict(
            threshold_std_factor=4.0,
            window_blocks=25,
            freeze_blocks_before=3,
            freeze_blocks_after=10,
            fixed_threshold_blocks=10,
        )
        thr_s, above_s = sharded_detect_adaptive_exact(d, mesh, **kw)
        d_np = np.asarray(d)
        for c in range(2):
            thr_u, above_u = adaptive_thresholds_parallel(jnp.asarray(d_np[c]), **kw)
            np.testing.assert_array_equal(np.asarray(above_s[c]), np.asarray(above_u))
            np.testing.assert_allclose(
                np.asarray(thr_s[c]), np.asarray(thr_u), rtol=0, atol=0, equal_nan=True
            )


class TestShardedStreaming:
    """Time-sharded streaming 3-state machine == unsharded stream_process,
    bit-exact (the Welch front half runs per shard; the gathered block-rate
    scan is identical by construction).  Reference semantics:
    processor.py:444-510."""

    @staticmethod
    def _cfg():
        from meteor_scatter_tpu.config import DetectionConfig

        return DetectionConfig(
            signal_freq=1000,
            detection_db_over_noise_mean_min=1,
            detection_dur_min_sec=0.5,
        )

    @staticmethod
    def _audio(fs, dur, seed=11):
        rng = np.random.default_rng(seed)
        t = np.arange(int(fs * dur)) / fs
        x = rng.standard_normal((2, len(t))).astype(np.float32) * 0.05
        # ch0's burst straddles the 16 s time-shard seam of a 64 s / 4-shard
        # layout; ch1 gets one near the 32 s seam and one interior
        bursts = {0: [(15.5, 1.5)], 1: [(31.4, 1.2), (50.0, 1.0)]}
        for c, spans in bursts.items():
            for s, l in spans:
                m = (t >= s) & (t < s + l)
                x[c, m] += 0.6 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
        return x

    def test_equals_unsharded(self, mesh):
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_init,
            stream_process,
        )
        from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

        fs, dur = 4000, 64.0
        cfg = self._cfg()
        x = self._audio(fs, dur)

        st, ev, diags = sharded_stream_process(cfg, None, jnp.asarray(x), fs, mesh)
        fields = (
            "time_start", "time_stop", "duration",
            "db_min", "db_max", "db_mean", "db_std",
        )
        for c in range(2):
            st_u, ev_u, dg_u = stream_process(
                cfg, stream_init(StreamConfig.from_config(cfg)), jnp.asarray(x[c]), fs
            )
            cnt = int(ev_u.count)
            assert cnt >= 1, "fixture must produce events"
            assert int(np.asarray(ev.count)[c]) == cnt
            for f in fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(ev, f))[c], np.asarray(getattr(ev_u, f)),
                    err_msg=f"events.{f} ch{c}",
                )
            np.testing.assert_array_equal(
                np.asarray(diags["threshold"])[c], np.asarray(dg_u["threshold"])
            )
            np.testing.assert_array_equal(
                np.asarray(diags["over_noise"])[c], np.asarray(dg_u["over_noise"])
            )
            np.testing.assert_array_equal(
                np.asarray(diags["psd_db"])[c], np.asarray(dg_u["psd_db"])
            )
            for name, leaf_s, leaf_u in zip(
                st._fields,
                jax.tree_util.tree_leaves(st),
                jax.tree_util.tree_leaves(st_u),
            ):
                np.testing.assert_array_equal(
                    np.asarray(leaf_s)[c], np.asarray(leaf_u),
                    err_msg=f"state.{name} ch{c}",
                )

    @pytest.mark.parametrize("impl", ["scan", "jump", "hop", "fused"])
    def test_headless_front_equals_unsharded(self, mesh, impl):
        # front="bins" composes with time sharding (and impl="jump"/"hop"/
        # "fused" with both): sharded must equal the single-device path
        # bit-for-bit (events, state, thresholds), with no psd waterfall in
        # the diags.  impl="fused" runs the batch-native Pallas kernel on
        # each device's local station group (VERDICT r3 item 4); the kernel
        # is lane-parallel with no cross-lane ops, so the local-group batch
        # is bit-identical to the unsharded C=1 slices.
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_init,
            stream_process,
        )
        from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

        fs, dur = 4000, 64.0
        cfg = self._cfg()
        x = self._audio(fs, dur, seed=13)

        st, ev, diags = sharded_stream_process(
            cfg, None, jnp.asarray(x), fs, mesh, front="bins", impl=impl
        )
        assert "psd_db" not in diags
        for c in range(2):
            st_u, ev_u, dg_u = stream_process(
                cfg, stream_init(StreamConfig.from_config(cfg)),
                jnp.asarray(x[c]), fs, front="bins", impl=impl,
            )
            assert int(np.asarray(ev.count)[c]) == int(ev_u.count)
            assert int(ev_u.count) >= 1, "fixture must produce events"
            np.testing.assert_array_equal(
                np.asarray(ev.time_start)[c], np.asarray(ev_u.time_start)
            )
            np.testing.assert_array_equal(
                np.asarray(ev.time_stop)[c], np.asarray(ev_u.time_stop)
            )
            np.testing.assert_array_equal(
                np.asarray(diags["threshold"])[c], np.asarray(dg_u["threshold"])
            )
            np.testing.assert_array_equal(
                np.asarray(diags["over_noise"])[c], np.asarray(dg_u["over_noise"])
            )
            for name, leaf_s, leaf_u in zip(
                st._fields,
                jax.tree_util.tree_leaves(st),
                jax.tree_util.tree_leaves(st_u),
            ):
                if impl in ("jump", "hop"):
                    # FMA/reduction-order noise between the two jitted
                    # graphs (see tests/test_streaming_jump.py)
                    np.testing.assert_allclose(
                        np.asarray(leaf_s)[c], np.asarray(leaf_u),
                        rtol=1e-6, atol=1e-6, err_msg=f"state.{name} ch{c}",
                    )
                else:
                    np.testing.assert_array_equal(
                        np.asarray(leaf_s)[c], np.asarray(leaf_u),
                        err_msg=f"state.{name} ch{c}",
                    )

    def test_chunked_carry_across_calls(self, mesh):
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_init,
            stream_process,
        )
        from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

        fs, dur = 4000, 64.0
        cfg = self._cfg()
        x = self._audio(fs, dur, seed=12)
        half = x.shape[-1] // 2

        st = None
        got = []
        for sl in (x[:, :half], x[:, half:]):
            st, ev, _ = sharded_stream_process(cfg, st, jnp.asarray(sl), fs, mesh)
            for c in range(2):
                for k in range(int(np.asarray(ev.count)[c])):
                    got.append((c, float(np.asarray(ev.time_start)[c, k]),
                                float(np.asarray(ev.time_stop)[c, k])))

        want = []
        for c in range(2):
            _, ev_u, _ = stream_process(
                cfg, stream_init(StreamConfig.from_config(cfg)), jnp.asarray(x[c]), fs
            )
            for k in range(int(ev_u.count)):
                want.append((c, float(ev_u.time_start[k]), float(ev_u.time_stop[k])))
        assert sorted(got) == sorted(want) and len(want) >= 1

    @pytest.mark.parametrize("front,impl", [("bins", "fused"), ("welch", "scan")])
    def test_preblocked_equals_flat(self, mesh, front, impl):
        # (C, n_blocks, block) pre-blocked input (the throughput form,
        # models/streaming.py::_blocked) shards blocks over the time axis
        # and must be bit-identical to the flat (C, S) form — for the fast
        # path AND the welch/waterfall path (whose psd output spec must
        # hold for 3-D input too)
        from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

        fs, dur = 4000, 64.0
        cfg = self._cfg()
        x = self._audio(fs, dur, seed=14)
        block = int(round(cfg.proc_block_sec * fs))
        x3 = x.reshape(2, -1, block)
        outs = []
        for xin in (jnp.asarray(x), jnp.asarray(x3)):
            st, ev, dg = sharded_stream_process(
                cfg, None, xin, fs, mesh, front=front, impl=impl
            )
            outs.append((st, ev, dg))
        (st_f, ev_f, dg_f), (st_b, ev_b, dg_b) = outs
        assert int(np.asarray(ev_f.count).sum()) >= 1
        for name, a, b in zip(
            ev_f._fields,
            jax.tree_util.tree_leaves(ev_f),
            jax.tree_util.tree_leaves(ev_b),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        for name, a, b in zip(
            st_f._fields,
            jax.tree_util.tree_leaves(st_f),
            jax.tree_util.tree_leaves(st_b),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(dg_f["over_noise"]), np.asarray(dg_b["over_noise"])
        )

    def test_rejects_misaligned_shards(self, mesh):
        from meteor_scatter_tpu.parallel.sharded import sharded_stream_process

        cfg = self._cfg()
        x = jnp.zeros((2, 4000 * 3), jnp.float32)  # 3 s / 4 shards: not block-aligned
        with pytest.raises(ValueError):
            sharded_stream_process(cfg, None, x, 4000, mesh)


class TestShardedChannelizerIQ:
    """BASELINE config 4 at spec: the wideband I/Q front half time-sharded,
    and the full IQ → channelize → per-station streaming chain sharded ==
    unsharded (VERDICT r2 item 5)."""

    FS = 64_000  # scaled-down stand-in for the 2 MS/s capture (CPU mesh)
    AUDIO = 4000
    TONE = 1000.0
    # incommensurate offsets so the per-shard phase-rotation bookkeeping is
    # genuinely exercised (multiples of fs/q would make every phase exact)
    FREQS = [-17003.0, -7001.0, 6997.0, 15013.0]

    @classmethod
    def _capture(cls, seconds, seed=21):
        rng = np.random.default_rng(seed)
        n = int(cls.FS * seconds)
        t = np.arange(n) / cls.FS
        x_re = rng.standard_normal(n).astype(np.float32) * 0.1
        x_im = rng.standard_normal(n).astype(np.float32) * 0.1
        for c, fc in enumerate(cls.FREQS):
            t0 = 9.5 + 1.3 * c  # past the 8 s streaming init window
            m = (t >= t0) & (t < t0 + 1.5)
            ph = 2 * np.pi * fc * t[m]
            x_re[m] += 0.5 * np.cos(ph).astype(np.float32)
            x_im[m] += 0.5 * np.sin(ph).astype(np.float32)
        return x_re, x_im

    def test_channelizer_equals_unsharded(self, mesh):
        from meteor_scatter_tpu.ops.fir import channelize_iq
        from meteor_scatter_tpu.parallel.sharded import sharded_channelize_iq

        x_re, x_im = self._capture(4.0)
        centers = np.asarray(self.FREQS) - self.TONE
        kw = dict(bandwidth=1500.0, decim=16, numtaps=65)
        yr_s, yi_s = sharded_channelize_iq(
            jnp.asarray(x_re), jnp.asarray(x_im), mesh, self.FS, centers, **kw
        )
        yr_u, yi_u = channelize_iq(
            jnp.asarray(x_re), jnp.asarray(x_im), self.FS, centers, **kw
        )
        n = min(yr_s.shape[-1], yr_u.shape[-1])
        np.testing.assert_allclose(
            np.asarray(yr_s)[:, :n], np.asarray(yr_u)[:, :n], atol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(yi_s)[:, :n], np.asarray(yi_u)[:, :n], atol=2e-5
        )

    def test_channelizer_preframed_equals_flat_sharded(self, mesh):
        """The pre-framed pod form (host-baked per-shard frames + halos, no
        in-graph framing, no ppermute) must be BIT-identical to the flat
        sharded form — same local frame values, same tables (round 5)."""
        from meteor_scatter_tpu.ops.fir import (
            channel_bank_plan,
            frame_capture_sharded_host,
        )
        from meteor_scatter_tpu.parallel.sharded import (
            TIME_AXIS,
            sharded_channelize_iq,
            sharded_channelize_iq_frames,
        )

        x_re, x_im = self._capture(4.0)
        centers = np.asarray(self.FREQS) - self.TONE
        kw = dict(bandwidth=1500.0, decim=16, numtaps=65)
        yr_s, yi_s = sharded_channelize_iq(
            jnp.asarray(x_re), jnp.asarray(x_im), mesh, self.FS, centers, **kw
        )

        n_time = mesh.shape[TIME_AXIS]
        plan, _ = channel_bank_plan(x_re.size, self.FS, centers, **kw)
        f_sh = frame_capture_sharded_host(np.stack([x_re, x_im]), plan, n_time)
        yr_p, yi_p = sharded_channelize_iq_frames(
            jnp.asarray(f_sh), mesh, self.FS, centers, **kw
        )
        assert np.array_equal(np.asarray(yr_s), np.asarray(yr_p))
        assert np.array_equal(np.asarray(yi_s), np.asarray(yi_p))

    def test_iq_stream_chain_equals_unsharded(self, mesh):
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_init,
            stream_process,
        )
        from meteor_scatter_tpu.ops.fir import channelize_iq
        from meteor_scatter_tpu.parallel.sharded import (
            sharded_channelize_iq,
            sharded_stream_process,
        )
        from meteor_scatter_tpu.config import DetectionConfig

        seconds = 16.0
        x_re, x_im = self._capture(seconds)
        centers = np.asarray(self.FREQS) - self.TONE
        kw = dict(bandwidth=1500.0, decim=16, numtaps=65)
        cfg = DetectionConfig(
            signal_freq=self.TONE,
            detection_db_over_noise_mean_min=1.0,
            detection_dur_min_sec=0.5,
        )

        # sharded chain: DDC per time shard, audio re-sharded (station, time)
        yr_s, _ = sharded_channelize_iq(
            jnp.asarray(x_re), jnp.asarray(x_im), mesh, self.FS, centers, **kw
        )
        st_s, ev_s, _ = sharded_stream_process(
            cfg, None, yr_s, self.AUDIO, mesh, front="bins", impl="hop"
        )

        # unsharded chain
        yr_u, _ = channelize_iq(
            jnp.asarray(x_re), jnp.asarray(x_im), self.FS, centers, **kw
        )
        total = 0
        for c in range(len(self.FREQS)):
            _, ev_u, _ = stream_process(
                cfg,
                stream_init(StreamConfig.from_config(cfg)),
                yr_u[c],
                self.AUDIO,
                front="bins",
                impl="hop",
            )
            cnt = int(ev_u.count)
            total += cnt
            assert int(np.asarray(ev_s.count)[c]) == cnt
            np.testing.assert_array_equal(
                np.asarray(ev_s.time_start)[c], np.asarray(ev_u.time_start),
                err_msg=f"time_start ch{c}",
            )
            np.testing.assert_array_equal(
                np.asarray(ev_s.time_stop)[c], np.asarray(ev_u.time_stop),
                err_msg=f"time_stop ch{c}",
            )
        assert total >= len(self.FREQS), "every station's burst must be found"
