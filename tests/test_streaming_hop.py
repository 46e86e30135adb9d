"""Batched episode-jump solver (`stream_scan_jump_batch`) vs the scan.

Same parity contract as `stream_scan_jump` (tests/test_streaming_jump.py):
event boundaries, thresholds, state transitions bit-exact; dB statistics
to f32 reduction order (per-hop masked sums vs sequential adds).  Extra
coverage here: the vmapped wide-batch layout it was built for, and small
`track_hop` values that force multi-hop tracking of one event.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.models.streaming import (
    StreamConfig,
    stream_init,
    stream_init_batch,
    stream_scan,
    stream_scan_jump_batch,
)

from tests.test_streaming_jump import (
    CLOSE_EV,
    CLOSE_STATE,
    EXACT_EV,
    EXACT_STATE,
    default_cfg,
    make_series,
)


def assert_hop_equals_scan(scfg, st0_a, st0_b, on, pm, track_hop=128):
    st_s, ev_s, thr_s = stream_scan(scfg, st0_a, on, pm)
    st_h, ev_h, thr_h = stream_scan_jump_batch(
        scfg, st0_b, on, pm, track_hop=track_hop
    )

    np.testing.assert_array_equal(np.asarray(thr_s), np.asarray(thr_h))
    assert int(ev_s.count) == int(ev_h.count)
    assert bool(ev_s.overflow) == bool(ev_h.overflow)
    c = min(int(ev_s.count), scfg.cap)
    for f in EXACT_EV:
        np.testing.assert_array_equal(
            np.asarray(getattr(ev_s, f))[:c], np.asarray(getattr(ev_h, f))[:c],
            err_msg=f"events.{f}",
        )
    # per-hop partial sums accumulate a little more reduction noise than the
    # jump's single masked sum, so the CLOSE tolerance is one notch wider
    for f in CLOSE_EV:
        np.testing.assert_allclose(
            np.asarray(getattr(ev_s, f))[:c], np.asarray(getattr(ev_h, f))[:c],
            rtol=1e-4, atol=1e-4, err_msg=f"events.{f}",
        )
    for f in EXACT_STATE:
        np.testing.assert_array_equal(
            np.asarray(getattr(st_s, f)), np.asarray(getattr(st_h, f)),
            err_msg=f"state.{f}",
        )
    for f in CLOSE_STATE:
        np.testing.assert_allclose(
            np.asarray(getattr(st_s, f)), np.asarray(getattr(st_h, f)),
            rtol=1e-5, atol=1e-5, err_msg=f"state.{f}",
        )
    np.testing.assert_array_equal(np.asarray(st_s.ring), np.asarray(st_h.ring))
    return st_s, st_h, ev_s


class TestHopEqualsScan:
    def test_noise_only(self):
        scfg = default_cfg()
        on, pm = make_series(900, seed=0)
        _, _, ev = assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm
        )
        assert int(ev.count) == 0

    def test_bursty_series(self):
        scfg = default_cfg()
        bursts = [(100, 110, 8.0), (120, 121, 9.0), (160, 170, 8.0),
                  (400, 420, 6.0), (700, 704, 7.0)]
        on, pm = make_series(900, seed=1, bursts=bursts)
        _, _, ev = assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm
        )
        assert int(ev.count) >= 3, "fixture must produce accepted events"

    def test_multi_hop_tracking(self):
        # an event far longer than track_hop forces several tracking hops
        scfg = default_cfg()
        on, pm = make_series(900, seed=2, bursts=[(100, 400, 8.0)])
        assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm, track_hop=16
        )

    def test_track_survives_chunk_end(self):
        scfg = default_cfg()
        on, pm = make_series(300, seed=2, bursts=[(280, 300, 8.0)])
        st_s, st_h, _ = assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm
        )
        assert int(st_s.state) == 2  # TRACK carried out

    def test_cap_overflow_contract(self):
        scfg = default_cfg(cap=2)
        bursts = [(b, b + 6, 8.0) for b in range(60, 800, 90)]
        on, pm = make_series(900, seed=3, bursts=bursts)
        _, _, ev = assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm
        )
        assert int(ev.count) > 2 and bool(ev.overflow)

    def test_chunked_carry(self):
        scfg = default_cfg()
        bursts = [(100, 110, 8.0), (400, 412, 6.0), (640, 650, 7.0)]
        on, pm = make_series(910, seed=4, bursts=bursts)
        st_s, st_h = stream_init(scfg), stream_init(scfg)
        total = 0
        step = 30  # cuts inside INIT, inside events, and inside lock windows
        for i in range(0, 900, step):
            st_s, st_h, ev = assert_hop_equals_scan(
                scfg, st_s, st_h, on[i : i + step], pm[i : i + step]
            )
            total += int(ev.count)
        assert total >= 3

    @pytest.mark.parametrize("seed", range(5, 11))
    def test_fuzz_random_walks(self, seed):
        rng = np.random.default_rng(seed)
        scfg = default_cfg(
            avg_win=int(rng.integers(8, 60)),
            after_wait_sec=float(rng.uniform(0.0, 6.0)),
            k_std=float(rng.uniform(1.0, 3.0)),
            min_mean_db=float(rng.uniform(0.0, 1.0)),
            min_dur_sec=float(rng.uniform(0.0, 1.0)),
            cap=8,
        )
        n = int(rng.integers(200, 700))
        on, pm = make_series(n, seed=seed + 100, noise=1.0)
        hop = int(rng.choice([8, 32, 128]))
        assert_hop_equals_scan(
            scfg, stream_init(scfg), stream_init(scfg), on, pm, track_hop=hop
        )


class TestResolveAuto:
    """resolve_stream_auto picks by backend through meteor_scatter_tpu.platform:
    the CPU keeps the reference formulation, the GPU takes its measured
    defaults, any other backend (the one this program was first written
    for included) is refused."""

    def test_cpu_defaults(self, monkeypatch):
        import meteor_scatter_tpu.models.streaming as S

        monkeypatch.setattr(S.jax, "default_backend", lambda: "cpu")
        assert S.resolve_stream_auto("auto", "auto") == ("welch", "scan")

    def test_gpu_defaults(self, monkeypatch):
        import meteor_scatter_tpu.models.streaming as S
        from meteor_scatter_tpu import platform

        monkeypatch.setattr(S.jax, "default_backend", lambda: "gpu")
        assert S.resolve_stream_auto("auto", "auto") == (
            platform._DEFAULTS["gpu"]["stream_front"],
            platform._DEFAULTS["gpu"]["stream_solver"],
        )

    def test_tpu_defaults(self, monkeypatch):
        import meteor_scatter_tpu.models.streaming as S

        monkeypatch.setattr(S.jax, "default_backend", lambda: "tpu")
        with pytest.raises(ValueError, match="unsupported JAX backend"):
            S.resolve_stream_auto("auto", "auto")
        # explicit selections always pass through untouched
        assert S.resolve_stream_auto("welch", "scan") == ("welch", "scan")
        assert S.resolve_stream_auto("bins", "hop") == ("bins", "hop")


class TestSanitizeLevels:
    """±inf over-noise levels (digital-silence dB: band_sum_db of a silent
    signal band is 10·log10(0) = -inf) clamp to a finite sentinel at the
    front boundary so the one-hot threshold contraction cannot
    NaN-contaminate trailing windows (ADVICE r3)."""

    def test_clamp_and_finite_thresholds(self):
        from meteor_scatter_tpu.models.streaming import _sanitize_levels

        on_np = np.zeros(200, np.float32)
        on_np[50] = -np.inf
        on_np[120] = np.inf
        on = _sanitize_levels(jnp.asarray(on_np))
        s = np.asarray(on)
        assert s[50] == -1e15 and s[120] == 1e15 and np.isfinite(s).all()
        # finite values pass through bit-unchanged
        np.testing.assert_array_equal(np.delete(s, [50, 120]),
                                      np.delete(on_np, [50, 120]))
        # through the solver: thresholds stay finite everywhere — the
        # degenerate block stays localized instead of NaN-ing its whole
        # trailing window (and the sentinel's square stays finite in f32)
        scfg = default_cfg()
        _, _, thr = stream_scan(
            scfg, stream_init(scfg), on, jnp.zeros(200, jnp.float32)
        )
        t = np.asarray(thr)
        assert not np.isnan(t[scfg.avg_win :]).any()

    def test_fronts_apply_sanitize(self):
        # an all-silent capture produces NaN/-inf raw band levels; both
        # fronts must emit only sanitized (non-±inf) over_noise
        from meteor_scatter_tpu.config import DetectionConfig
        from meteor_scatter_tpu.models.streaming import (
            stream_front,
            stream_front_headless,
        )

        cfg = DetectionConfig(
            signal_freq=1000.0,
            detection_db_over_noise_mean_min=1.0,
            detection_dur_min_sec=0.5,
        )
        fs = 4000
        x = jnp.zeros(fs * 4, jnp.float32)  # digital silence
        for front in (stream_front, stream_front_headless):
            on, _, _ = front(cfg, x, fs)
            # isfinite (not merely "no inf"): all-silent blocks used to emit
            # -inf - (-inf) = NaN over_noise, which clip passed through
            # (ADVICE r4) — silence must read as exactly 0 dB over noise
            on = np.asarray(on)
            assert np.isfinite(on).all(), front.__name__
            assert np.all(on == 0.0), front.__name__

    def test_silent_block_stays_local_across_chunks(self):
        """A single silent block must not NaN thresholds of later windows
        through the chunk-boundary ring (ADVICE r4: a NaN entering the
        one-hot contraction in _ring_base_thresholds spread to a window NOT
        containing the silent block, breaking chunked==unchunked)."""
        from meteor_scatter_tpu.config import DetectionConfig
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_front,
            stream_init,
            stream_scan,
        )

        cfg = DetectionConfig(
            signal_freq=1000.0,
            detection_db_over_noise_mean_min=1.0,
            detection_dur_min_sec=0.5,
        )
        fs = 4000
        block = int(round(cfg.proc_block_sec * fs))
        rng = np.random.default_rng(7)
        x = rng.normal(0, 0.05, fs * 60).astype(np.float32)
        # silence exactly one block early in the capture
        x[40 * block : 41 * block] = 0.0

        on, pm, _ = stream_front(cfg, jnp.asarray(x), fs)
        assert np.isfinite(np.asarray(on)).all()

        scfg = StreamConfig.from_config(cfg)
        _, _, thr_u = stream_scan(scfg, stream_init(scfg), on, pm)
        # chunked run: 3 x 100-block chunks threading the carried state
        st = stream_init(scfg)
        thr_parts = []
        for lo in range(0, 300, 100):
            st, _, thr_c = stream_scan(
                scfg, st, on[lo : lo + 100], pm[lo : lo + 100]
            )
            thr_parts.append(np.asarray(thr_c))
        thr_chunked = np.concatenate(thr_parts)
        thr_u = np.asarray(thr_u)
        # NaN inside the first avg_win blocks is the documented stats
        # warm-up (variance over <2 samples), same as the unchunked run;
        # what the ADVICE-r4 bug produced was NaN *after* warm-up in
        # windows near (but not containing) the silent block.
        assert np.isfinite(thr_chunked[scfg.avg_win :]).all()
        assert np.array_equal(thr_u, thr_chunked, equal_nan=True)


class TestHopVmapped:
    def test_wide_batch_equals_per_channel(self):
        """The layout it was built for: one vmapped call over C channels
        equals C independent single-channel runs."""
        scfg = default_cfg()
        C, n = 6, 700
        ons, pms = [], []
        for c in range(C):
            bursts = [(120 + 40 * c, 160 + 40 * c, 6.0)] if c % 2 == 0 else []
            on, pm = make_series(n, seed=20 + c, bursts=bursts)
            ons.append(on)
            pms.append(pm)
        on_b, pm_b = jnp.stack(ons), jnp.stack(pms)

        st0 = stream_init_batch(scfg, C)
        st_b, ev_b, thr_b = jax.vmap(
            lambda s, o, p: stream_scan_jump_batch(scfg, s, o, p)
        )(st0, on_b, pm_b)

        for c in range(C):
            st_s, ev_s, thr_s = stream_scan(scfg, stream_init(scfg), ons[c], pms[c])
            np.testing.assert_array_equal(
                np.asarray(thr_s), np.asarray(thr_b)[c], err_msg=f"thr ch{c}"
            )
            assert int(ev_s.count) == int(np.asarray(ev_b.count)[c])
            cc = min(int(ev_s.count), scfg.cap)
            for f in EXACT_EV:
                np.testing.assert_array_equal(
                    np.asarray(getattr(ev_s, f))[:cc],
                    np.asarray(getattr(ev_b, f))[c][:cc],
                    err_msg=f"events.{f} ch{c}",
                )
            for f in EXACT_STATE:
                np.testing.assert_array_equal(
                    np.asarray(getattr(st_s, f)),
                    np.asarray(getattr(st_b, f))[c],
                    err_msg=f"state.{f} ch{c}",
                )

    def test_episode_overflow_flag(self):
        """Beyond 4·cap+8 lock episodes per chunk the threshold diagnostic
        series degrades (base thresholds substitute inside dropped lock
        windows); the `with_diag` flag must report it (VERDICT r3 item 5),
        mirroring the event buffers' count/overflow contract — while event
        lists stay exact vs the scan regardless."""
        scfg = default_cfg(cap=2, min_dur_sec=2.0)  # ep_cap = 16
        # pathological series: a 1-block spike every 3 blocks — every spike
        # is a track-enter/leave episode (rejected as an event by min_dur,
        # but recorded as a lock episode)
        bursts = [(b, b + 1, 9.0) for b in range(60, 580, 3)]
        on, pm = make_series(600, seed=50, bursts=bursts)
        st_h, ev_h, thr_h, diag = stream_scan_jump_batch(
            scfg, stream_init(scfg), on, pm, with_diag=True
        )
        assert bool(diag["thr_degraded"]), "pathological series must overflow"
        # events still bit-exact vs the scan (degradation is diagnostic-only)
        st_s, ev_s, _ = stream_scan(scfg, stream_init(scfg), on, pm)
        assert int(ev_s.count) == int(ev_h.count)
        for f in EXACT_EV:
            np.testing.assert_array_equal(
                np.asarray(getattr(ev_s, f)), np.asarray(getattr(ev_h, f))
            )
        for f in EXACT_STATE:
            np.testing.assert_array_equal(
                np.asarray(getattr(st_s, f)), np.asarray(getattr(st_h, f))
            )

    def test_episode_flag_clear_on_normal_series(self):
        scfg = default_cfg()
        on, pm = make_series(900, seed=1,
                             bursts=[(100, 110, 8.0), (400, 420, 6.0)])
        st_h, ev_h, thr_h, diag = stream_scan_jump_batch(
            scfg, stream_init(scfg), on, pm, with_diag=True
        )
        assert not bool(diag["thr_degraded"])
        # the 3-tuple form is unchanged for vmapped callers
        st3, ev3, thr3 = stream_scan_jump_batch(scfg, stream_init(scfg), on, pm)
        np.testing.assert_array_equal(np.asarray(thr_h), np.asarray(thr3))

    def test_stream_process_exposes_flag(self):
        """stream_process(impl='hop') folds thr_degraded into diags."""
        from meteor_scatter_tpu.config import DetectionConfig
        from meteor_scatter_tpu.models.streaming import stream_process

        cfg = DetectionConfig(
            signal_freq=1000.0,
            detection_db_over_noise_mean_min=1.0,
            detection_dur_min_sec=0.5,
        )
        fs = 4000
        rng = np.random.default_rng(9)
        x = rng.standard_normal(fs * 20).astype(np.float32) * 0.05
        _, _, diags = stream_process(
            cfg, stream_init(StreamConfig.from_config(cfg)),
            jnp.asarray(x), fs, front="bins", impl="hop",
        )
        assert "thr_degraded" in diags and not bool(diags["thr_degraded"])

    def test_wide_batch_chunked(self):
        scfg = default_cfg()
        C, n, step = 4, 600, 150
        on_b = jnp.stack(
            [make_series(n, seed=40 + c, bursts=[(200, 230, 7.0)])[0] for c in range(C)]
        )
        pm_b = jnp.stack([make_series(n, seed=40 + c)[1] for c in range(C)])

        run = jax.vmap(lambda s, o, p: stream_scan_jump_batch(scfg, s, o, p))
        st = stream_init_batch(scfg, C)
        counts = 0
        for i in range(0, n, step):
            st, ev, _ = run(st, on_b[:, i : i + step], pm_b[:, i : i + step])
            counts += np.asarray(ev.count)
        # single-shot comparison
        st1, ev1, _ = run(stream_init_batch(scfg, C), on_b, pm_b)
        np.testing.assert_array_equal(counts, np.asarray(ev1.count))
        np.testing.assert_array_equal(np.asarray(st.state), np.asarray(st1.state))
        np.testing.assert_array_equal(
            np.asarray(st.block_idx), np.asarray(st1.block_idx)
        )
