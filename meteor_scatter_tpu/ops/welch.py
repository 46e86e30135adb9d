"""Welch PSD with scipy-compatible semantics, as a batched XLA computation.

The streaming pipeline's only spectral op is
``scipy.signal.welch(block, fs, nfft=n_fft)`` (`dsp/src/live/backend/
processor.py:206`), i.e. scipy *defaults* everywhere else:

    nperseg=256, window='hann' (periodic), noverlap=nperseg//2,
    detrend='constant', scaling='density', onesided, average='mean'

Re-derived here (no scipy at runtime):

    seg   = frame(x, nperseg, nperseg - noverlap)
    seg  -= mean(seg, -1)                      # detrend 'constant'
    X     = rfft(seg * win, nfft)
    Pxx   = |X|^2 / (fs * sum(win^2))          # density scaling
    Pxx[..., 1:-1] *= 2 (even nfft) / [..., 1:] *= 2 (odd)   # onesided
    Pxx   = mean over segments

vmaps cleanly over blocks/channels: the live pipeline calls it on
(num_blocks, block_size) at once instead of per-block Python loops.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meteor_scatter_tpu.ops.framing import frame_signal, num_frames
from meteor_scatter_tpu.ops.window import hann_periodic


def welch_freqs(fs: float, nfft: int) -> np.ndarray:
    return np.fft.rfftfreq(nfft, d=1.0 / fs)


def welch_psd(
    x: jnp.ndarray,
    fs: float,
    nfft: int,
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: str = "constant",
) -> jnp.ndarray:
    """PSD of the last axis; returns (..., nfft//2 + 1) in power/Hz.

    Matches ``scipy.signal.welch(x, fs, nperseg=nperseg, noverlap=noverlap,
    nfft=nfft)`` with a periodic Hann window to f32 accuracy.
    """
    nperseg = min(nperseg, x.shape[-1])  # scipy clamps when input is short
    if noverlap is None:
        # derived AFTER the clamp, as scipy does — deriving first leaves
        # hop <= 0 for short inputs (division by zero / empty framing)
        noverlap = nperseg // 2
    elif noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    hop = nperseg - noverlap

    win = jnp.asarray(hann_periodic(nperseg, dtype=np.float32))
    seg = frame_signal(x.astype(jnp.float32), nperseg, hop)
    if detrend == "constant":
        seg = seg - jnp.mean(seg, axis=-1, keepdims=True)
    X = jnp.fft.rfft(seg * win, n=nfft, axis=-1)
    p = (X.real * X.real + X.imag * X.imag) / (fs * float(np.sum(hann_periodic(nperseg) ** 2)))
    # one-sided doubling: every bin except DC, and except Nyquist when nfft even
    nbins = nfft // 2 + 1
    scale = np.ones(nbins, dtype=np.float32) * 2.0
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    p = p * jnp.asarray(scale)
    return jnp.mean(p, axis=-2)


def welch_band_matrix(
    fs: float,
    nfft: int,
    nperseg: int,
    bands: Tuple[Tuple[float, float], ...],
    compress_rtol: float | None = None,
):
    """Projection matrix computing Welch *band sums* without the full PSD.

    For detection, only ``band_sum_db(welch_psd(...), band)`` for a few
    bands is needed — i.e. Σ_k∈band |X_k|²·c_k per segment, which is the
    squared norm of a handful of DFT rows.  Those rows (window, constant
    detrend, density scaling and one-sided doubling all folded in) become
    columns of one (nperseg, 2·total_bins) matrix, so the whole front half
    is a single matmul on the raw segments instead of zero-padded
    nfft-point FFTs producing nfft/2+1 bins that are then discarded.

    Returns ``(P, slices)``: ``seg @ P`` squared and summed over
    ``slices[b]`` equals the Welch band sum of band ``b`` exactly (up to
    f32 reduction order).

    ``compress_rtol`` eigen-compresses each band's factor: the band sum is
    the quadratic form ``segᵀ(V_b V_bᵀ)seg``, and for a contiguous band
    ``V_b V_bᵀ`` is a prolate-spheroidal-type bandlimit operator whose
    eigenvalues plunge after ≈ 2·(band width)·(window duration) — e.g. a
    100 Hz band over a 64 ms window has numerical rank ~26 against 206
    columns of windowed DFT selectors.  Replacing ``V_b`` by
    ``U_r·√λ_r`` (eigenpairs with λ > compress_rtol·λ_max, computed in
    float64) preserves every band sum to relative error ≤ the truncated
    eigenmass (measured 7.9e-10 at rtol 1e-10, i.e. 3.4e-9 dB — three
    orders below f32 rounding) while cutting the matmul width ~8x.  The
    downstream ``seg @ P`` / square / slice-sum contract is unchanged.
    """
    freqs = welch_freqs(fs, nfft)
    win = hann_periodic(nperseg)  # float64
    norm = fs * float(np.sum(win**2))
    nbins = nfft // 2 + 1
    scale = np.ones(nbins) * 2.0
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0

    n = np.arange(nperseg)
    band_blocks = []
    slices = []
    start = 0
    for band in bands:
        idx = np.nonzero((freqs >= band[0]) & (freqs <= band[1]))[0]
        cols = []
        for k in idx:
            c = np.sqrt(scale[k] / norm)
            ang = 2.0 * np.pi * k * n / nfft
            for basis in (np.cos(ang), np.sin(ang)):  # sign of -sin is squared away
                v = win * basis * c
                v = v - v.mean()  # detrend 'constant' folded in (symmetric)
                cols.append(v)
        V = (
            np.stack(cols, axis=1)
            if cols
            else np.zeros((nperseg, 0), np.float64)
        )
        if compress_rtol is not None and V.shape[1] > 1:
            lam, U = np.linalg.eigh(V @ V.T)  # float64 throughout
            keep = lam > compress_rtol * lam[-1]
            V = U[:, keep] * np.sqrt(lam[keep])
        band_blocks.append(V)
        slices.append((start, start + V.shape[1]))
        start += V.shape[1]
    P = np.concatenate(band_blocks, axis=1).astype(np.float32)
    return P, tuple(slices)


def block_band_matrix(
    fs: float,
    nfft: int,
    nperseg: int,
    block: int,
    bands: Tuple[Tuple[float, float], ...],
    noverlap: int | None = None,
    rtol: float = 1e-10,
):
    """Whole-block Welch band sums as ONE quadratic form per block.

    The per-block Welch band level is ``Σ_seg ‖S_o x · stuff‖²`` over the
    overlapped segments of the block — i.e. ``xᵀ M_b x`` with
    ``M_b = Σ_o S_oᵀ V_b V_bᵀ S_o`` (``S_o`` selects segment offset o,
    ``V_b`` the :func:`welch_band_matrix` factor).  ``M_b`` is a
    (block, block) PSD bandlimit operator whose numerical rank is again
    ≈ 2·(band width)·(BLOCK duration) — e.g. ~56 for a 100 Hz band over a
    0.2 s block — so its float64 eigen-factor ``U_r·√λ_r`` turns the whole
    front (framing + window + DFT selection + segment mean) into a single
    contiguous (..., block) @ (block, K) GEMM: no overlapped frame tensor,
    no per-segment batch of M=2-3 GEMMs.

    Returns ``(P, slices, nseg)``: ``‖x_block @ P[:, a:b]‖² / nseg`` is
    band b's Welch level, accurate to the truncated eigenmass (≤ rtol·λmax
    per direction; ~1e-9 relative at the default — three orders below f32
    rounding).  Semantics anchor: `dsp/src/live/backend/processor.py:206`
    (scipy.signal.welch per 0.2 s block).
    """
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    nseg = num_frames(block, nperseg, hop)
    if nseg <= 0:
        raise ValueError(f"block {block} shorter than nperseg {nperseg}")
    V_full, v_slices = welch_band_matrix(fs, nfft, nperseg, bands)
    band_blocks = []
    slices = []
    start = 0
    for a, b in v_slices:
        V = V_full[:, a:b].astype(np.float64)
        M = np.zeros((block, block))
        for s in range(nseg):
            o = s * hop
            M[o : o + nperseg, o : o + nperseg] += V @ V.T
        if M.any():
            lam, U = np.linalg.eigh(M)
            keep = lam > rtol * lam[-1]
            U_r = U[:, keep] * np.sqrt(lam[keep])
        else:
            U_r = np.zeros((block, 0))
        band_blocks.append(U_r)
        slices.append((start, start + U_r.shape[1]))
        start += U_r.shape[1]
    P = np.concatenate(band_blocks, axis=1).astype(np.float32)
    return P, tuple(slices), nseg


def block_band_sums_db(
    x3: jnp.ndarray,  # (..., block)
    projection: jnp.ndarray,  # (block, K) from block_band_matrix
    slices,
    nseg: int,
):
    """Band dB levels per block via :func:`block_band_matrix` — one GEMM on
    the contiguous block tensor (flattened to 2-D: a free reshape, unlike
    the strided overlapped-frame views).  Equal to the segment-framed
    Welch path up to the factor's truncated eigenmass + f32 reduction
    order."""
    xf = x3.astype(jnp.float32)
    lead = xf.shape[:-1]
    # HIGHEST: a default-precision f32 GEMM may run in TF32 on the GPU
    # (about three decimal digits), and these band levels decide events
    proj = jnp.matmul(
        xf.reshape(-1, xf.shape[-1]), projection, precision=jax.lax.Precision.HIGHEST
    )
    pw = jnp.square(proj).reshape(lead + (projection.shape[-1],))
    return [
        10.0 * jnp.log10(jnp.sum(pw[..., a:b], axis=-1) / nseg)
        for a, b in slices
    ]


def welch_band_sums_db(
    x: jnp.ndarray,
    nperseg: int,
    projection: jnp.ndarray,
    slices,
    noverlap: int | None = None,
):
    """Band dB levels over the last axis via :func:`welch_band_matrix` —
    equal to ``band_sum_db(welch_psd(x, ...), band)`` per band to f32
    reduction-order noise.  Returns a list of (...,)-shaped dB arrays.

    When ``hop`` divides ``nperseg`` (the standard 50% overlap), the Welch
    mean over segments is computed as per-offset *group sums*: segments at
    offset class r (r·hop, r·hop + nperseg, ...) are a contiguous slice +
    reshape that XLA fuses straight into the matmul, so the overlapped
    frame tensor — ~1.6x the input, and several copies through
    ``frame_signal``'s pad/stack/interleave — is never materialized.  The
    mean is segment-order-free, so this changes only f32 summation order
    (the contract this function already carries)."""
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    xf = x.astype(jnp.float32)
    n = xf.shape[-1]
    nseg = num_frames(n, nperseg, hop)
    if nseg > 0 and nperseg % hop == 0:
        k = nperseg // hop
        sums = None
        for r in range(k):
            off = r * hop
            if n - off < nperseg:
                continue
            nf_r = (n - off - nperseg) // nperseg + 1
            seg = xf[..., off : off + nf_r * nperseg].reshape(
                xf.shape[:-1] + (nf_r, nperseg)
            )
            # for the per-block streaming front, `block_band_matrix`
            # removes the segment dimension entirely and is the fast path
            pw = jnp.square(
                jnp.matmul(seg, projection, precision=jax.lax.Precision.HIGHEST)
            )
            s_r = [jnp.sum(pw[..., a:b], axis=(-2, -1)) for a, b in slices]
            sums = s_r if sums is None else [s + t for s, t in zip(sums, s_r)]
        return [10.0 * jnp.log10(s / nseg) for s in sums]
    seg = frame_signal(xf, nperseg, hop)  # (..., nseg, nperseg)
    proj = jnp.matmul(  # (..., nseg, 2*total)
        seg, projection, precision=jax.lax.Precision.HIGHEST
    )
    pw = proj * proj
    out = []
    for a, b in slices:
        s = jnp.mean(jnp.sum(pw[..., a:b], axis=-1), axis=-1)
        out.append(10.0 * jnp.log10(s))
    return out


def band_sum_db(
    psd: jnp.ndarray, freqs: np.ndarray, band: Tuple[float, float], floor: float = 0.0
) -> jnp.ndarray:
    """10*log10 of the PSD summed over a band (inclusive edges), the
    streaming pipeline's per-block channel level (`processor.py:349-367`).

    The reference emits -inf when the band sum is exactly 0; with floor=0
    jnp.log10(0) = -inf reproduces that.
    """
    mask = (freqs >= band[0]) & (freqs <= band[1])
    idx = np.nonzero(mask)[0]
    s = jnp.sum(psd[..., idx], axis=-1) + floor
    return 10.0 * jnp.log10(s)
