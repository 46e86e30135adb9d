"""Band power extraction — the detection hot loop, recast as one matmul.

The reference computes, per 0.2 s block (`dsp/src/main.py:376-388`):

    X = rfft(block * hanning(block_size), n=n_fft)
    band_db  = 10*log10( sum_{k in band}  |X_k|^2 + 1e-12 )
    noise_db = 10*log10( sum_{k in noise} |X_k|^2 + 1e-12 )

Only a handful of frequency bins (BRAMS: ±10 Hz around 1003 Hz and 700 Hz →
~4 bins each) out of the full rfft ever matter.  On an accelerator it is therefore
wasteful to compute an FFT at all: writing the needed bins as inner products
with windowed cos/sin rows turns the whole hot loop into ONE matmul

    frames[num_blocks, L] @ M[L, 2K]   ->  square -> per-band row sums

which streams the audio from device memory exactly once and never
materializes a spectrum.  (The full-spectrum
path for waterfalls lives in :mod:`meteor_scatter_tpu.ops.spectrogram`.)

numpy-exactness notes (all encoded in :func:`band_projection_matrix`):

* ``np.fft.rfft(y, n)`` with ``n < len(y)`` *crops* y to its first n samples
  — the reference's block_size=1200 > n_fft=1024 relies on this.  Hence the
  window is ``hanning(frame_len)[:n_fft]`` and only L=min(frame_len, n_fft)
  samples of each frame enter the matmul.
* band masks are inclusive on both edges (`main.py:382,386`).
* power floor 1e-12 added before the log (`main.py:383,387`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meteor_scatter_tpu.ops.window import hann_symmetric


def band_bins(fs: float, n_fft: int, band: Tuple[float, float]) -> np.ndarray:
    """Indices of rfft bins inside [lo, hi] (inclusive), matching the
    reference's ``(freqs >= lo) & (freqs <= hi)`` masks."""
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / fs)
    return np.nonzero((freqs >= band[0]) & (freqs <= band[1]))[0]


def band_projection_matrix(
    fs: float,
    n_fft: int,
    frame_len: int,
    bands: Sequence[Tuple[float, float]],
    dtype=np.float32,
) -> Tuple[np.ndarray, list]:
    """Build the windowed DFT-selector matrix.

    Returns ``(M, slices)`` where ``M`` has shape ``(L, 2*K_total)`` with
    L = min(frame_len, n_fft), and ``slices[b]`` selects the column range of
    band *b* such that::

        p = frames[:, :L] @ M            # (num_frames, 2*K_total)
        e_b = (p[:, slices[b]] ** 2).sum(-1)   ==  sum |rfft(w*frame, n_fft)[k]|^2

    The Hann window is folded into the matrix, so ``frames`` holds the *raw*
    signal.
    """
    L = min(frame_len, n_fft)
    win = hann_symmetric(frame_len)[:L]  # crop AFTER windowing, like rfft(y,n)
    n = np.arange(L, dtype=np.float64)

    cols = []
    slices = []
    start = 0
    for band in bands:
        ks = band_bins(fs, n_fft, band)
        for k in ks:
            phase = 2.0 * np.pi * k * n / n_fft
            cols.append(win * np.cos(phase))
            cols.append(win * np.sin(phase))
        slices.append(slice(start, start + 2 * len(ks)))
        start += 2 * len(ks)

    M = np.stack(cols, axis=1).astype(dtype) if cols else np.zeros((L, 0), dtype)
    return M, slices


def band_power_db(
    frames: jnp.ndarray,
    projection: jnp.ndarray,
    slices: Sequence[slice],
    power_floor: float = 1e-12,
    precision=jax.lax.Precision.HIGHEST,
) -> Tuple[jnp.ndarray, ...]:
    """dB band powers for each band.

    frames: (..., num_frames, frame_len) raw signal frames.
    projection: (L, 2K) matrix from :func:`band_projection_matrix`.

    Returns one ``(..., num_frames)`` dB array per band.  ``precision`` is
    HIGHEST by default so the f32 matmul does not run in reduced precision
    (TF32 on the GPU; detection thresholds sit 4σ out — keep the numerics
    tight).
    """
    L = projection.shape[0]
    p = jnp.dot(frames[..., :L], projection, precision=precision)
    p2 = p * p
    outs = []
    for s in slices:
        e = jnp.sum(p2[..., s], axis=-1) + power_floor
        outs.append(10.0 * jnp.log10(e))
    return tuple(outs)


def delta_power_db(
    x: jnp.ndarray,
    fs: float,
    n_fft: int,
    block_size: int,
    freq_band: Tuple[float, float],
    noise_band: Tuple[float, float],
    power_floor: float = 1e-12,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """End-to-end reference hot loop: raw signal -> (band_db, noise_db, delta).

    Equivalent to `dsp/src/main.py:373-393` for the whole file at once.
    """
    from meteor_scatter_tpu.ops.framing import frame_signal

    M, slices = band_projection_matrix(fs, n_fft, block_size, [freq_band, noise_band])
    frames = frame_signal(x.astype(jnp.float32), block_size, block_size)
    band_db, noise_db = band_power_db(frames, jnp.asarray(M), slices, power_floor)
    return band_db, noise_db, band_db - noise_db
