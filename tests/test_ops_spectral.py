"""Parity tests: windows, framing, band power, Welch, spectrograms vs
numpy/scipy/matplotlib ground truth (SURVEY.md §4 test plan, item 2)."""

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from meteor_scatter_tpu.ops.window import hann_periodic, hann_symmetric
from meteor_scatter_tpu.ops.framing import frame_signal, num_frames
from meteor_scatter_tpu.ops.bandpower import (
    band_projection_matrix,
    band_power_db,
    delta_power_db,
)
from meteor_scatter_tpu.ops.welch import band_sum_db, welch_freqs, welch_psd
from meteor_scatter_tpu.ops.spectrogram import spectrogram_mpl, spectrogram_scipy


RNG = np.random.default_rng(42)


def make_audio(fs, dur, tone=1003.0, snr_db=10.0):
    t = np.arange(int(fs * dur)) / fs
    sig = np.sin(2 * np.pi * tone * t)
    noise = RNG.standard_normal(len(t))
    a = 10 ** (snr_db / 20.0)
    return (a * sig + noise).astype(np.float64)


class TestWindows:
    def test_hann_symmetric_matches_numpy(self):
        for m in (8, 255, 1024, 1200):
            np.testing.assert_allclose(hann_symmetric(m), np.hanning(m), atol=1e-15)

    def test_hann_periodic_matches_scipy(self):
        for m in (8, 256, 4096):
            np.testing.assert_allclose(
                hann_periodic(m), scipy.signal.get_window("hann", m), atol=1e-15
            )


class TestFraming:
    @pytest.mark.parametrize("n,fl,hop", [(100, 10, 10), (105, 10, 10), (100, 16, 8), (1000, 256, 128), (100, 12, 5)])
    def test_matches_naive(self, n, fl, hop):
        x = RNG.standard_normal(n).astype(np.float32)
        got = np.asarray(frame_signal(jnp.asarray(x), fl, hop))
        nf = num_frames(n, fl, hop)
        want = np.stack([x[i * hop : i * hop + fl] for i in range(nf)])
        assert got.shape == (nf, fl)
        np.testing.assert_array_equal(got, want)

    def test_batched(self):
        x = RNG.standard_normal((3, 100)).astype(np.float32)
        got = np.asarray(frame_signal(jnp.asarray(x), 16, 8))
        for b in range(3):
            want = np.asarray(frame_signal(jnp.asarray(x[b]), 16, 8))
            np.testing.assert_array_equal(got[b], want)


def numpy_hot_loop(x, fs, n_fft, block_size, freq_band, noise_band):
    """Independent oracle for the reference hot loop (dsp/src/main.py:376-388)."""
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / fs)
    nb = len(x) // block_size
    band_db, noise_db = [], []
    w = np.hanning(block_size)
    for i in range(nb):
        blk = x[i * block_size : (i + 1) * block_size]
        X = np.fft.rfft(blk * w, n=n_fft)
        P = np.abs(X) ** 2
        m1 = (freqs >= freq_band[0]) & (freqs <= freq_band[1])
        m2 = (freqs >= noise_band[0]) & (freqs <= noise_band[1])
        band_db.append(10 * np.log10(P[m1].sum() + 1e-12))
        noise_db.append(10 * np.log10(P[m2].sum() + 1e-12))
    return np.array(band_db), np.array(noise_db)


class TestBandPower:
    FS = 6000
    N_FFT = 1024  # effective (reference doubles user 512, main.py:353)
    BLOCK = 1200  # 0.2 s @ 6 kHz — larger than n_fft: exercises rfft crop
    FB = (993.0, 1013.0)
    NB = (690.0, 710.0)

    def test_matches_numpy_hot_loop(self):
        x = make_audio(self.FS, 10.0)
        want_b, want_n = numpy_hot_loop(x, self.FS, self.N_FFT, self.BLOCK, self.FB, self.NB)
        got_b, got_n, got_d = delta_power_db(
            jnp.asarray(x), self.FS, self.N_FFT, self.BLOCK, self.FB, self.NB
        )
        np.testing.assert_allclose(np.asarray(got_b), want_b, atol=2e-3)
        np.testing.assert_allclose(np.asarray(got_n), want_n, atol=2e-3)
        np.testing.assert_allclose(np.asarray(got_d), want_b - want_n, atol=4e-3)

    def test_nfft_larger_than_block(self):
        # zero-padding branch: n_fft > block_size
        fs, nfft, blk = 4000, 4096, 800
        x = make_audio(fs, 5.0, tone=1000.0)
        want_b, want_n = numpy_hot_loop(x, fs, nfft, blk, (950, 1050), (650, 750))
        got_b, got_n, _ = delta_power_db(jnp.asarray(x), fs, nfft, blk, (950, 1050), (650, 750))
        np.testing.assert_allclose(np.asarray(got_b), want_b, atol=2e-3)
        np.testing.assert_allclose(np.asarray(got_n), want_n, atol=2e-3)

    def test_projection_matches_rfft_bins(self):
        M, slices = band_projection_matrix(self.FS, self.N_FFT, self.BLOCK, [self.FB])
        x = RNG.standard_normal(self.BLOCK)
        p = x[: M.shape[0]] @ M
        e = float((p[slices[0]] ** 2).sum())
        X = np.fft.rfft(x * np.hanning(self.BLOCK), n=self.N_FFT)
        freqs = np.fft.rfftfreq(self.N_FFT, 1 / self.FS)
        m = (freqs >= self.FB[0]) & (freqs <= self.FB[1])
        want = float((np.abs(X[m]) ** 2).sum())
        assert abs(e - want) / want < 1e-5

    def test_batched_over_channels(self):
        x = np.stack([make_audio(self.FS, 2.0), make_audio(self.FS, 2.0, tone=1006)])
        M, slices = band_projection_matrix(self.FS, self.N_FFT, self.BLOCK, [self.FB, self.NB])
        frames = frame_signal(jnp.asarray(x, dtype=jnp.float32), self.BLOCK, self.BLOCK)
        b, n = band_power_db(frames, jnp.asarray(M), slices)
        assert b.shape == (2, 10)
        for c in range(2):
            want_b, _ = numpy_hot_loop(x[c], self.FS, self.N_FFT, self.BLOCK, self.FB, self.NB)
            np.testing.assert_allclose(np.asarray(b[c]), want_b, atol=2e-3)


class TestWelch:
    @pytest.mark.parametrize("n,nfft", [(800, 4096), (800, 256), (4000, 1024)])
    def test_matches_scipy_defaults(self, n, nfft):
        fs = 4000.0
        x = make_audio(fs, n / fs, tone=1020.0)
        f_ref, p_ref = scipy.signal.welch(x, fs, nfft=nfft)
        got = np.asarray(welch_psd(jnp.asarray(x), fs, nfft))
        np.testing.assert_allclose(welch_freqs(fs, nfft), f_ref, atol=1e-9)
        np.testing.assert_allclose(got, p_ref, rtol=2e-4, atol=1e-12)

    def test_explicit_nperseg(self):
        fs = 6000.0
        x = make_audio(fs, 1.0)
        nperseg, nfft = 512, 1024
        _, p_ref = scipy.signal.welch(x, fs, nperseg=nperseg, nfft=nfft)
        got = np.asarray(welch_psd(jnp.asarray(x), fs, nfft, nperseg=nperseg))
        np.testing.assert_allclose(got, p_ref, rtol=2e-4, atol=1e-12)

    @pytest.mark.parametrize("n", [128, 100, 255])
    def test_short_input_clamps_like_scipy(self, n):
        """Inputs shorter than the default nperseg=256 must clamp nperseg
        AND re-derive the default noverlap after the clamp, as scipy does —
        deriving noverlap first left hop <= 0 (ZeroDivisionError / empty
        framing, round-5 review finding)."""
        fs, nfft = 4000.0, 1024
        x = make_audio(fs, n / fs, tone=900.0)[:n]
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # scipy warns about the clamp
            _, p_ref = scipy.signal.welch(x, fs, nfft=nfft)
        got = np.asarray(welch_psd(jnp.asarray(x), fs, nfft))
        np.testing.assert_allclose(got, p_ref, rtol=2e-4, atol=1e-12)

    def test_noverlap_ge_nperseg_raises(self):
        with pytest.raises(ValueError):
            welch_psd(jnp.zeros(1000), 4000.0, 1024, nperseg=256, noverlap=256)

    def test_band_sum_matches_reference_masking(self):
        # processor.py:349-358: sum PSD over inclusive band, 10*log10
        fs, nfft = 4000.0, 4096
        x = make_audio(fs, 0.2, tone=1000.0)
        psd = welch_psd(jnp.asarray(x), fs, nfft)
        freqs = welch_freqs(fs, nfft)
        got = float(band_sum_db(psd, freqs, (950.0, 1050.0)))
        _, p_ref = scipy.signal.welch(x, fs, nfft=nfft)
        mask = (freqs >= 950.0) & (freqs <= 1050.0)
        want = 10 * np.log10(p_ref[mask].sum())
        assert abs(got - want) < 1e-3

    def test_batched_blocks(self):
        fs, nfft = 4000.0, 4096
        x = make_audio(fs, 2.0)
        blocks = x[: 8 * 800].reshape(8, 800)
        got = np.asarray(welch_psd(jnp.asarray(blocks), fs, nfft))
        for i in range(8):
            _, p_ref = scipy.signal.welch(blocks[i], fs, nfft=nfft)
            np.testing.assert_allclose(got[i], p_ref, rtol=2e-4, atol=1e-12)


class TestSpectrogram:
    def test_matches_scipy(self):
        fs, nper = 6000.0, 4096
        x = make_audio(fs, 4.0)
        f_ref, t_ref, s_ref = scipy.signal.spectrogram(
            x, fs=fs, window="hann", nperseg=nper, noverlap=nper // 2, nfft=nper,
            scaling="density", mode="psd",
        )
        f, t, s = spectrogram_scipy(jnp.asarray(x), fs, nper)
        np.testing.assert_allclose(f, f_ref, atol=1e-9)
        np.testing.assert_allclose(t, t_ref, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s), s_ref, rtol=3e-4, atol=1e-11)

    def test_matches_matplotlib_specgram(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.mlab as mlab

        fs, nfft = 5000.0, 2048
        x = make_audio(fs, 5.0, tone=1000.0)
        s_ref, f_ref, t_ref = mlab.specgram(x, Fs=fs, NFFT=nfft, noverlap=nfft // 2)
        f, t, s = spectrogram_mpl(jnp.asarray(x), fs, nfft, noverlap=nfft // 2)
        np.testing.assert_allclose(f, f_ref, atol=1e-9)
        np.testing.assert_allclose(t, t_ref, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s), s_ref, rtol=3e-4, atol=1e-11)


class TestBandMatrixCompression:
    def test_compressed_band_sums_match_full(self):
        """Eigen-compressed projection (prolate rank ~2BT per band) must
        reproduce every band sum to far below f32 rounding while cutting
        the matmul width severalfold."""
        from meteor_scatter_tpu.ops.welch import welch_band_matrix

        fs, nfft, nperseg = 4000, 4096, 256
        bands = ((950.0, 1050.0), (650.0, 750.0), (1250.0, 1350.0))
        P0, s0 = welch_band_matrix(fs, nfft, nperseg, bands)
        P1, s1 = welch_band_matrix(fs, nfft, nperseg, bands, compress_rtol=1e-10)
        assert P1.shape[1] * 4 < P0.shape[1], (P0.shape, P1.shape)
        rng = np.random.default_rng(3)
        seg = rng.standard_normal((512, nperseg))
        for (a0, b0), (a1, b1) in zip(s0, s1):
            full = ((seg @ P0[:, a0:b0].astype(np.float64)) ** 2).sum(-1)
            comp = ((seg @ P1[:, a1:b1].astype(np.float64)) ** 2).sum(-1)
            np.testing.assert_allclose(comp, full, rtol=1e-5)

    def test_empty_band_kept(self):
        from meteor_scatter_tpu.ops.welch import welch_band_matrix

        P, slices = welch_band_matrix(
            4000, 4096, 256, ((950.0, 1050.0), (1999.5, 1999.6)),
            compress_rtol=1e-10,
        )
        assert slices[1][0] == slices[1][1]  # empty band -> empty slice

    def test_block_band_matrix_matches_welch(self):
        """The whole-block quadratic-form factor (framing + window + DFT
        selection + segment mean folded into one eigen-compressed GEMM)
        must reproduce band_sum_db(welch_psd(...)) per block."""
        import jax.numpy as jnp
        from meteor_scatter_tpu.ops.welch import (
            band_sum_db,
            block_band_matrix,
            block_band_sums_db,
            welch_freqs,
            welch_psd,
        )

        fs, nfft, nperseg, block = 4000, 4096, 256, 800
        bands = ((950.0, 1050.0), (650.0, 750.0), (1250.0, 1350.0))
        P, slices, nseg = block_band_matrix(fs, nfft, nperseg, block, bands)
        assert nseg == 5 and P.shape[0] == block
        assert P.shape[1] < 3 * 130, P.shape  # rank ~112 per band, not 5*206
        rng = np.random.default_rng(7)
        x = rng.standard_normal((40, block)).astype(np.float32)
        got = block_band_sums_db(jnp.asarray(x), jnp.asarray(P), slices, nseg)
        psd = welch_psd(jnp.asarray(x), fs, nfft, nperseg=nperseg)
        freqs = welch_freqs(fs, nfft)
        for g, band in zip(got, bands):
            want = band_sum_db(psd, freqs, band)
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(want), rtol=0, atol=5e-4,
            )
