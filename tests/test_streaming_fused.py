"""Fused Pallas streaming-machine solver vs the scan.

Contract (`models/streaming.py::stream_scan_fused_batch`):

* vs **vmapped** ``stream_scan``: bit-exact everywhere — same base-
  threshold prologue, op-for-op body mirror, identical compaction;
* vs **unbatched** ``stream_scan``: additionally XLA may FMA-contract
  ``i·bs − t0`` in the scalar graph, shifting the reported ``duration``
  (and one ULP of ``tr_sumsq``/``db_std``) — decisions (boundaries, lock
  windows, counts, accepts) stay comparison/integer-exact.

Kernel: `ops/pallas/stream_kernel.py`, a Triton-route kernel run here in
interpret mode: one program per power-of-two channel group, a time loop
over tiles of rows inside the program, channels and time padded to whole
groups and tiles.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.models.streaming import (
    StreamEvents,
    StreamState,
    stream_init,
    stream_init_batch,
    stream_scan,
    stream_scan_fused,
    stream_scan_fused_batch,
)

from tests.test_streaming_jump import (
    CLOSE_EV,
    CLOSE_STATE,
    EXACT_EV,
    EXACT_STATE,
    default_cfg,
    make_series,
)


def assert_bitexact_vs_vmapped_scan(scfg, C, n, seed, bursts=(), close=()):
    """``close`` names event/state fields compared to 1e-6 instead of
    bit for bit: at C=1 XLA compiles the vmapped scan like the unbatched
    one and may FMA-contract its duration (see the module docstring)."""
    ons, pms = [], []
    for c in range(C):
        on, pm = make_series(n, seed + c, bursts)
        ons.append(on)
        pms.append(pm)
    on = jnp.stack(ons)
    pm = jnp.stack(pms)
    st0 = stream_init_batch(scfg, C)
    st_s, ev_s, thr_s = jax.vmap(lambda s, o, p: stream_scan(scfg, s, o, p))(
        st0, on, pm
    )
    st_f, ev_f, thr_f = stream_scan_fused_batch(scfg, st0, on, pm)
    np.testing.assert_array_equal(np.asarray(thr_s), np.asarray(thr_f))
    for name, a, b in [("events", ev_s, ev_f), ("state", st_s, st_f)]:
        for f in type(a)._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            if f in close:
                np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=f"{name}.{f}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f}")
    return ev_f


class TestFusedVsVmappedScan:
    def test_quiet(self):
        scfg = default_cfg()
        ev = assert_bitexact_vs_vmapped_scan(scfg, 3, 700, seed=0)
        assert int(np.asarray(ev.count).sum()) == 0

    def test_bursts(self):
        scfg = default_cfg()
        ev = assert_bitexact_vs_vmapped_scan(
            scfg, 4, 900, seed=1, bursts=((120, 140, 8.0), (400, 430, 9.0))
        )
        assert np.asarray(ev.count).min() >= 1

    def test_multi_chunk_grid(self):
        # a long series: many tiles of the in-kernel time loop, bursts
        # across tile edges
        scfg = default_cfg()
        assert_bitexact_vs_vmapped_scan(
            scfg, 2, 1300, seed=2, bursts=((500, 530, 8.0), (1000, 1030, 8.0))
        )

    def test_rejected_events_and_locks(self):
        scfg = default_cfg(min_mean_db=6.0)
        assert_bitexact_vs_vmapped_scan(
            scfg, 3, 800, seed=3,
            bursts=((100, 104, 3.0), (300, 330, 12.0), (352, 380, 12.0)),
        )

    def test_fuzz(self):
        scfg = default_cfg()
        rng = np.random.default_rng(11)
        for trial in range(4):
            n = int(rng.integers(300, 1200))
            bursts = tuple(
                (int(b), int(b) + int(rng.integers(2, 40)), float(rng.uniform(2, 10)))
                for b in rng.integers(60, n - 60, size=rng.integers(0, 5))
            )
            assert_bitexact_vs_vmapped_scan(scfg, 2, n, seed=100 + trial, bursts=bursts)


class TestFusedSingleStream:
    def test_vs_unbatched_scan_fma_tolerance(self):
        scfg = default_cfg()
        on, pm = make_series(900, 7, bursts=((150, 180, 8.0), (500, 540, 9.0)))
        st_s, ev_s, thr_s = stream_scan(scfg, stream_init(scfg), on, pm)
        st_f, ev_f, thr_f = stream_scan_fused(
            scfg, stream_init(scfg), on, pm
        )
        np.testing.assert_array_equal(np.asarray(thr_s), np.asarray(thr_f))
        assert int(ev_s.count) == int(ev_f.count)
        c = int(ev_s.count)
        for f in EXACT_EV:
            np.testing.assert_array_equal(
                np.asarray(getattr(ev_s, f))[:c], np.asarray(getattr(ev_f, f))[:c],
                err_msg=f"events.{f}",
            )
        for f in CLOSE_EV:
            np.testing.assert_allclose(
                np.asarray(getattr(ev_s, f))[:c], np.asarray(getattr(ev_f, f))[:c],
                rtol=1e-5, atol=1e-5, err_msg=f"events.{f}",
            )
        for f in EXACT_STATE:
            np.testing.assert_array_equal(
                np.asarray(getattr(st_s, f)), np.asarray(getattr(st_f, f)),
                err_msg=f"state.{f}",
            )
        for f in CLOSE_STATE:
            np.testing.assert_allclose(
                np.asarray(getattr(st_s, f)), np.asarray(getattr(st_f, f)),
                rtol=1e-5, atol=1e-5, err_msg=f"state.{f}",
            )
        np.testing.assert_array_equal(np.asarray(st_s.ring), np.asarray(st_f.ring))

    def test_chunked_state_carry(self):
        # three chunks through the fused path == one whole-series fused run
        scfg = default_cfg()
        on, pm = make_series(900, 9, bursts=((280, 310, 8.0), (600, 640, 9.0)))
        st_w, ev_w, thr_w = stream_scan_fused(
            scfg, stream_init(scfg), on, pm
        )
        st = stream_init(scfg)
        thrs = []
        counts = 0
        for sl in (slice(0, 300), slice(300, 600), slice(600, 900)):
            st, ev, thr = stream_scan_fused(scfg, st, on[sl], pm[sl])
            thrs.append(np.asarray(thr))
            counts += int(ev.count)
        for f in StreamState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(st_w, f)), np.asarray(getattr(st, f)),
                err_msg=f"state.{f}",
            )
        assert counts == int(ev_w.count)
        np.testing.assert_array_equal(np.concatenate(thrs), np.asarray(thr_w))

    def test_stream_process_impl_fused(self):
        from meteor_scatter_tpu.config import DetectionConfig
        from meteor_scatter_tpu.models.streaming import stream_init as si
        from meteor_scatter_tpu.models.streaming import (
            StreamConfig,
            stream_process,
        )

        fs = 4000
        cfg = DetectionConfig(
            signal_freq=1000.0,
            detection_db_over_noise_mean_min=1.0,
            detection_dur_min_sec=0.5,
        )
        scfg = StreamConfig.from_config(cfg)
        rng = np.random.default_rng(4)
        t = np.arange(int(fs * 120)) / fs
        x = rng.standard_normal(len(t)).astype(np.float32) * 0.05
        m = (t >= 40.0) & (t < 41.2)
        x[m] += 0.6 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
        x = jnp.asarray(x)
        _, ev_a, _ = stream_process(cfg, si(scfg), x, fs, front="welch", impl="scan")
        _, ev_b, _ = stream_process(cfg, si(scfg), x, fs, front="welch", impl="fused")
        assert int(ev_a.count) == int(ev_b.count) == 1
        np.testing.assert_array_equal(
            np.asarray(ev_a.time_start), np.asarray(ev_b.time_start)
        )
        np.testing.assert_array_equal(
            np.asarray(ev_a.time_stop), np.asarray(ev_b.time_stop)
        )


class TestFusedManyChannels:
    def test_over_128_channels_split(self):
        scfg = default_cfg()
        C, n = 130, 400
        rng = np.random.default_rng(6)
        on = jnp.asarray(rng.standard_normal((C, n)).astype(np.float32) * 0.3)
        on = on.at[:, 100:120].add(8.0)
        pm = jnp.asarray(rng.standard_normal((C, n)).astype(np.float32) - 80.0)
        st0 = stream_init_batch(scfg, C)
        st_s, ev_s, thr_s = jax.vmap(lambda s, o, p: stream_scan(scfg, s, o, p))(
            st0, on, pm
        )
        st_f, ev_f, thr_f = stream_scan_fused_batch(scfg, st0, on, pm)
        np.testing.assert_array_equal(np.asarray(thr_s), np.asarray(thr_f))
        np.testing.assert_array_equal(np.asarray(ev_s.count), np.asarray(ev_f.count))
        np.testing.assert_array_equal(
            np.asarray(ev_s.time_start), np.asarray(ev_f.time_start)
        )


class TestKernelShapes:
    """Channel counts that fill one group, several groups, and a partial
    last group; series lengths that are not a multiple of the time tile."""

    @pytest.mark.parametrize("C,n", [(1, 333), (3, 501), (17, 259), (64, 613), (130, 203)])
    def test_bitexact_vs_vmapped_scan(self, C, n):
        scfg = default_cfg()
        ev = assert_bitexact_vs_vmapped_scan(
            scfg, C, n, seed=C, bursts=((90, 110, 8.0), (150, 175, 9.0)),
            close=CLOSE_EV + CLOSE_STATE if C == 1 else (),
        )
        assert np.asarray(ev.count).min() >= 1

    @pytest.mark.parametrize("max_group,tile", [(4, 1), (8, 3), (64, 16), (1, 1)])
    def test_launch_shape_does_not_change_results(self, max_group, tile):
        scfg = default_cfg()
        C, n = 11, 301
        series = [make_series(n, 40 + c, ((100, 130, 8.0),)) for c in range(C)]
        on = jnp.stack([o for o, _ in series])
        pm = jnp.stack([p for _, p in series])
        st0 = stream_init_batch(scfg, C)
        _, ev_ref, thr_ref = stream_scan_fused_batch(scfg, st0, on, pm)
        _, ev, thr = stream_scan_fused_batch(
            scfg, st0, on, pm, max_group=max_group, tile=tile
        )
        np.testing.assert_array_equal(np.asarray(thr_ref), np.asarray(thr))
        for f in StreamEvents._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ev_ref, f)), np.asarray(getattr(ev, f))
            )

    @pytest.mark.parametrize("C,max_group,want", [(1, 32, 1), (3, 32, 4), (17, 32, 32), (64, 16, 16)])
    def test_group_size(self, C, max_group, want):
        from meteor_scatter_tpu.ops.pallas.stream_kernel import group_size

        assert group_size(C, max_group) == want

    def test_group_size_rejects_non_power_of_two(self):
        from meteor_scatter_tpu.ops.pallas.stream_kernel import group_size

        with pytest.raises(ValueError):
            group_size(8, 24)


@pytest.mark.gpu
def test_compiled_kernel_equals_scan():
    """The kernel compiled for the card against the vmapped scan at the
    station network's width (chip_smoke.py runs this check there)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this check on the card")
    scfg = default_cfg()
    ev = assert_bitexact_vs_vmapped_scan(
        scfg, 64, 3000, seed=5, bursts=((900, 930, 8.0),),
        close=CLOSE_EV + CLOSE_STATE,
    )
    assert np.asarray(ev.count).min() >= 1
