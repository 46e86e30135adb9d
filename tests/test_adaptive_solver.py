"""The XLA fixpoint adaptive solver against the sequential recurrence.

``detect_adaptive`` runs ``adaptive_thresholds_parallel`` +
``events_from_mask`` on every platform and at every series length; the
reference is the sequential ``adaptive_thresholds`` scan (the
`dsp/src/main.py:450-522` recurrence, itself pinned to the numpy oracle in
test_detectors.py).  Event lists must be identical; thresholds agree to
float32 reduction-order noise (prefix sums vs ring re-reduction).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.models.adaptive import (
    adaptive_thresholds,
    adaptive_thresholds_parallel,
    detect_adaptive,
)
from meteor_scatter_tpu.models.events import events_from_mask


def series(n, seed, n_bursts=14, amp=7.0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n).astype(np.float32)
    if n_bursts:
        for s in np.linspace(60, n - 60, n_bursts).astype(int):
            d[s : s + 5] += amp
    return d


KW = dict(
    threshold_std_factor=4.0,
    window_blocks=300,
    freeze_blocks_before=15,
    freeze_blocks_after=100,
    fixed_threshold_blocks=50,
)


def assert_same_events(d, cap=256, thr_rtol=1e-4, **kw):
    d = jnp.asarray(np.asarray(d, np.float32))
    thr_p, above_p = jax.jit(lambda x: adaptive_thresholds_parallel(x, **kw))(d)
    thr_s, above_s, _ = jax.jit(lambda x: adaptive_thresholds(x, **kw))(d)
    ev_p = events_from_mask(above_p, d, cap)
    ev_s = events_from_mask(above_s, d, cap)
    np.testing.assert_array_equal(np.asarray(above_p), np.asarray(above_s))
    c = int(ev_s.count)
    assert int(ev_p.count) == c
    np.testing.assert_array_equal(np.asarray(ev_p.start)[:c], np.asarray(ev_s.start)[:c])
    np.testing.assert_array_equal(np.asarray(ev_p.stop)[:c], np.asarray(ev_s.stop)[:c])
    np.testing.assert_allclose(
        np.asarray(ev_p.db_mean)[:c], np.asarray(ev_s.db_mean)[:c], rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(thr_p), np.asarray(thr_s), rtol=thr_rtol, atol=1e-5
    )
    return ev_p


class TestParallelVsSequential:
    @pytest.mark.parametrize("seed,k", [(17, 4.0), (23, 3.0), (29, 2.5)])
    def test_window_and_k(self, seed, k):
        ev = assert_same_events(series(4000, seed), **dict(KW, threshold_std_factor=k))
        assert int(ev.count) >= 1

    def test_pure_noise_marginal_crossings(self):
        assert_same_events(
            series(5000, 99, n_bursts=0),
            threshold_std_factor=2.5,
            window_blocks=200,
            freeze_blocks_before=5,
            freeze_blocks_after=30,
            fixed_threshold_blocks=20,
        )

    @pytest.mark.parametrize(
        "n,window",
        [
            (100, 50),  # series shorter than two windows
            (129, 200),  # window longer than the series
            (1024, 128),
            (2047, 601),  # odd length, odd window
        ],
    )
    def test_length_and_window_edges(self, n, window):
        assert_same_events(
            series(n, n, n_bursts=2, amp=6.0),
            threshold_std_factor=2.0,
            window_blocks=window,
            freeze_blocks_before=3,
            freeze_blocks_after=10,
            fixed_threshold_blocks=5,
        )

    def test_minimal_freeze_params(self):
        assert_same_events(
            series(1024, 3, n_bursts=6),
            threshold_std_factor=3.0,
            window_blocks=128,
            freeze_blocks_before=0,
            freeze_blocks_after=1,
            fixed_threshold_blocks=1,
        )

    def test_randomized_parameter_sweep(self):
        rng = np.random.default_rng(2026)
        for trial in range(6):
            n = int(rng.integers(300, 3000))
            kw = dict(
                threshold_std_factor=float(rng.uniform(1.5, 5.0)),
                window_blocks=int(rng.integers(16, max(n // 2, 17))),
                freeze_blocks_before=int(rng.integers(0, 30)),
                freeze_blocks_after=int(rng.integers(1, 200)),
                fixed_threshold_blocks=int(rng.integers(1, 100)),
            )
            d = rng.standard_normal(n).astype(np.float32)
            for s in rng.integers(10, n - 10, size=rng.integers(0, 12)):
                d[s : s + int(rng.integers(1, 8))] += float(rng.uniform(4, 10))
            assert_same_events(d, **kw)

    def test_vmap_over_channels_equals_per_channel(self):
        C = 8
        ds = jnp.asarray(np.stack([series(2000, 30 + c) for c in range(C)]))
        thr_b, above_b = jax.jit(
            jax.vmap(lambda d: adaptive_thresholds_parallel(d, **KW))
        )(ds)
        for c in range(C):
            thr, above = adaptive_thresholds_parallel(ds[c], **KW)
            np.testing.assert_array_equal(np.asarray(above_b)[c], np.asarray(above))
            # batched reductions may sum in another order: one ulp
            np.testing.assert_allclose(np.asarray(thr_b)[c], np.asarray(thr), rtol=1e-6)

    def test_series_longer_than_one_launch_of_the_old_kernel(self):
        # 140,000 blocks: past the 131,072-block capacity at which the
        # removed one-program kernel split a series into chunks; the XLA
        # solver takes it whole.
        # Its float32 prefix sums lose digits with length, so thresholds
        # agree to 1e-3 here while the events stay identical
        kw = dict(KW, window_blocks=100)
        ev = assert_same_events(
            series(140_000, 5, n_bursts=40), cap=64, thr_rtol=1e-3, **kw
        )
        assert int(ev.count) >= 30


class TestDetectAdaptive:
    def test_is_the_parallel_solver(self):
        d = jnp.asarray(series(3000, 41))
        ev, thr = detect_adaptive(
            d, 4.0, 0.2, threshold_estimation_window_sec=60.0, cap=64
        )
        thr_p, above = adaptive_thresholds_parallel(d, 4.0, 300, 15, 100, 50)
        ev_p = events_from_mask(above, d, 64)
        np.testing.assert_array_equal(np.asarray(thr), np.asarray(thr_p))
        for f in ("start", "stop", "count", "overflow"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ev, f)), np.asarray(getattr(ev_p, f))
            )
