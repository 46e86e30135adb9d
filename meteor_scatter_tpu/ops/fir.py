"""FIR design + filtering + polyphase resampling.

The reference ingests *pre-resampled* recordings (filenames like
``..._resampled.wav`` / ``..._sampled.wav``, `dsp/src/live/main.py:23,45`) —
the decimation happened offline in GQRX/HDSDR.  This framework does it on
device: an SDR front-end at its native rate is FIR-bandpassed around the
beacon tone and polyphase-decimated to the analysis rate, all expressed as
strided/dilated convolutions and output-rate matmuls.

FIR design is the classic window method (scipy.firwin-equivalent, Hamming
window, unity passband gain), implemented from first principles in numpy.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _hamming(m: int) -> np.ndarray:
    n = np.arange(m, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (m - 1))


def firwin_lowpass(numtaps: int, cutoff: float, fs: float = 2.0) -> np.ndarray:
    """Windowed-sinc lowpass; ``cutoff`` in Hz for sample rate ``fs``.
    Normalized to unity gain at DC (scipy.firwin convention)."""
    fc = cutoff / (fs / 2.0)  # normalized to Nyquist
    m = numtaps
    alpha = (m - 1) / 2.0
    n = np.arange(m, dtype=np.float64) - alpha
    h = fc * np.sinc(fc * n) * _hamming(m)
    return h / np.sum(h)


def firwin_bandpass(numtaps: int, f_lo: float, f_hi: float, fs: float) -> np.ndarray:
    """Bandpass as difference of two lowpasses, gain-normalized at the band
    center so the beacon tone passes at unity."""
    if numtaps % 2 == 0:
        raise ValueError("bandpass FIR needs odd numtaps (type-I symmetry)")

    def _lp(cut):  # un-normalized windowed sinc

        fc = cut / (fs / 2.0)
        alpha = (numtaps - 1) / 2.0
        n = np.arange(numtaps, dtype=np.float64) - alpha
        return fc * np.sinc(fc * n) * _hamming(numtaps)

    h = _lp(f_hi) - _lp(f_lo)
    # normalize to unity gain at band center
    fc_mid = 0.5 * (f_lo + f_hi)
    n = np.arange(numtaps, dtype=np.float64)
    gain = abs(np.sum(h * np.exp(-2j * np.pi * fc_mid / fs * n)))
    return h / gain


def fir_filter(x: jnp.ndarray, taps: np.ndarray, mode: str = "same") -> jnp.ndarray:
    """1-D FIR along the last axis via XLA convolution.

    mode 'same' matches np.convolve(x, taps, 'same'); 'valid' drops the
    transient edges; 'full' keeps everything.
    """
    t = len(taps)
    if mode == "same":
        pad = ((t - 1) // 2, t - 1 - (t - 1) // 2)
    elif mode == "valid":
        pad = (0, 0)
    elif mode == "full":
        pad = (t - 1, t - 1)
    else:
        raise ValueError(mode)
    return _conv1d(x, taps, stride=1, pad=pad, lhs_dilation=1)


def _reversed_tap_matrix(taps: np.ndarray, q: int, a_cols: int) -> np.ndarray:
    """(q, a_cols) reversed-tap polyphase matrix (convolution order) — the
    single source of truth for the tap split, shared by the decimator plan
    and the DDC bank tables (a change to centering or tap order must land
    in both consumers at once)."""
    t = len(taps)
    rev = np.asarray(taps, np.float64)[::-1]
    h = np.zeros((q, a_cols), np.float64)
    for tap in range(t):
        h[tap % q, tap // q] = rev[tap]
    return h


def _polyphase_plan(n: int, taps: np.ndarray, q: int):
    """Shared framing math for the matmul polyphase formulation: output length,
    the (q, A) tap matrix, and the padded frame count.  The tap order is
    reversed so the result matches *convolution*, like the
    conv_general_dilated form this replaces — the correlation/convolution
    distinction matters for asymmetric taps.

    Centering matches np.convolve 'same' for odd tap counts (every filter in
    this framework is odd-length by construction — firwin designs).  For
    even tap counts the output is the conv_general_dilated 'SAME' alignment,
    one sample left of numpy's choice."""
    t = len(taps)
    pl, pr = (t - 1) // 2, t - 1 - (t - 1) // 2
    n_out = (n + pl + pr - t) // q + 1  # == conv output length
    a_cols = -(-t // q)
    h = _reversed_tap_matrix(taps, q, a_cols)
    m = n_out + a_cols - 1
    return pl, n_out, a_cols, h, m


def _polyphase_frames(x: jnp.ndarray, pl: int, m: int, q: int) -> jnp.ndarray:
    """(..., m, q) frames of the left-padded signal at the output stride;
    frame o+a holds samples [(o+a)q, (o+a)q + q)."""
    n = x.shape[-1]
    need = m * q
    xp = jnp.pad(
        x.astype(jnp.float32), [(0, 0)] * (x.ndim - 1) + [(pl, max(need - n - pl, 0))]
    )
    return xp[..., :need].reshape(x.shape[:-1] + (m, q))


def polyphase_decimate(x: jnp.ndarray, taps: np.ndarray, q: int) -> jnp.ndarray:
    """Anti-alias filter + keep every q-th sample, computed polyphase: the
    filter runs at the *output* rate (q× cheaper than filter-then-slice).

    Formulated as a matmul instead of ``conv_general_dilated``, whose
    large-stride lowering is far from the roofline.  Splitting the
    (reversed) tap index t = a·q + b
    turns the decimation into ``reshape(x, (m, q)) @ H`` — one matmul at the
    output rate — followed by a sum of the A = ceil(T/q) shifted columns.
    Same output length/centering/convolution semantics as the conv form.
    """
    if q == 1:
        return fir_filter(x, taps, mode="same")
    pl, n_out, a_cols, h, m = _polyphase_plan(x.shape[-1], taps, q)
    f = _polyphase_frames(x, pl, m, q)
    g = jnp.dot(f, jnp.asarray(h, jnp.float32), precision=jax.lax.Precision.HIGHEST)
    y = g[..., :n_out, 0]
    for a in range(1, a_cols):
        y = y + g[..., a : a + n_out, a]
    return y


def resample_poly(x: jnp.ndarray, up: int, down: int, numtaps_per_phase: int = 20) -> jnp.ndarray:
    """Rational-rate polyphase resampler (scipy.signal.resample_poly
    analog).  Upsampling is expressed as lhs_dilation and downsampling as
    window stride of one XLA convolution — the compiler sees the whole
    upfirdn structure and skips the zero multiplies."""
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    max_rate = max(up, down)
    numtaps = 2 * numtaps_per_phase * max_rate + 1
    # cutoff at min(1/up, 1/down) of the upsampled Nyquist
    h = firwin_lowpass(numtaps, 1.0 / max_rate, fs=2.0) * up
    t = len(h)
    n = x.shape[-1]
    n_out = int(math.ceil(n * up / down))
    # left pad centers the filter (phase-preserving); right pad is sized so
    # the strided conv emits exactly n_out samples even when the dilated
    # input (n-1)*up+1 ends short of the last output's support
    pl = (t - 1) // 2
    l_dil = (n - 1) * up + 1
    pr = max((n_out - 1) * down + t - l_dil - pl, 0)
    y = _conv1d(x, h, stride=down, pad=(pl, pr), lhs_dilation=up)
    return y[..., :n_out]


def _conv1d(x, taps, stride, pad, lhs_dilation):
    taps = jnp.asarray(np.asarray(taps, dtype=np.float32)[::-1].copy())
    orig_shape = x.shape
    xf = x.astype(jnp.float32).reshape(-1, 1, orig_shape[-1])  # (N, C=1, W)
    k = taps.reshape(1, 1, -1)  # (O=1, I=1, W)
    y = jax.lax.conv_general_dilated(
        xf,
        k,
        window_strides=(stride,),
        padding=[pad],
        lhs_dilation=(lhs_dilation,),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(orig_shape[:-1] + (y.shape[-1],))


def _bank_tables(
    fs_i: int,
    freqs: list,
    taps: np.ndarray,
    q: int,
    a_cols: int,
    m: int,
    pl: int,
):
    """Host-side tables for the one-matmul DDC bank (see :func:`_channel_bank`):
    the (q, 2·C·A) polyphase tap matrix with the intra-frame mixer folded in
    by angle addition, and the (C, m) output-rate row phases.  Row phases are
    exact integer arithmetic mod fs for frame row ri at padded offset
    ``ri·q − pl``."""
    hp = _reversed_tap_matrix(taps, q, a_cols)

    c_n = len(freqs)
    hh = np.zeros((q, 2, c_n, a_cols), np.float64)
    b_idx = np.arange(q, dtype=np.int64)
    for c, fc in enumerate(freqs):
        ang_b = 2.0 * np.pi * ((b_idx * (fc % fs_i)) % fs_i) / fs_i
        hh[:, 0, c, :] = np.cos(ang_b)[:, None] * hp
        hh[:, 1, c, :] = np.sin(ang_b)[:, None] * hp
    hh_j = jnp.asarray(hh.reshape(q, 2 * c_n * a_cols), jnp.float32)

    ri = np.arange(m, dtype=np.int64)
    cr = np.empty((c_n, m), np.float32)
    sr = np.empty((c_n, m), np.float32)
    for c, fc in enumerate(freqs):
        p = ((ri * q - pl) * fc) % fs_i
        ang = 2.0 * np.pi * p / fs_i
        cr[c] = np.cos(ang)
        sr[c] = np.sin(ang)
    return hh_j, jnp.asarray(cr), jnp.asarray(sr)


def _bank_apply(
    f: jnp.ndarray,  # (..., m, q) frames of the padded signal
    hh_j: jnp.ndarray,
    cr_j: jnp.ndarray,
    sr_j: jnp.ndarray,
    c_n: int,
    a_cols: int,
    n_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device half of the DDC bank: one matmul + per-row phase rotation.

    dc = Σ_a cr·G_cos − sr·G_sin ; ds = Σ_a sr·G_cos + cr·G_sin
    (angle addition: cos(r+b) = cr·cb − sr·sb, sin(r+b) = sr·cb + cr·sb).
    """
    batch = f.shape[:-2]
    m = f.shape[-2]
    g = jnp.dot(f, hh_j, precision=jax.lax.Precision.HIGHEST)
    g = g.reshape(batch + (m, 2, c_n, a_cols))
    dc = jnp.zeros(batch + (c_n, n_out), jnp.float32)
    ds = jnp.zeros_like(dc)
    for a in range(a_cols):
        gc = jnp.moveaxis(g[..., a : a + n_out, 0, :, a], -1, -2)  # (..., C, n_out)
        gs = jnp.moveaxis(g[..., a : a + n_out, 1, :, a], -1, -2)
        crs = cr_j[:, a : a + n_out]
        srs = sr_j[:, a : a + n_out]
        dc = dc + crs * gc - srs * gs
        ds = ds + srs * gc + crs * gs
    return dc, ds


def _validated_int_rate_and_freqs(fs: float, center_freqs) -> Tuple[int, list]:
    fs_i = int(round(fs))
    if abs(fs - fs_i) > 1e-6:
        raise ValueError("channelize requires an integer sample rate")
    freqs = [int(round(f)) for f in np.asarray(center_freqs).ravel()]
    if any(abs(f - g) > 1e-9 for f, g in zip(np.asarray(center_freqs).ravel(), freqs)):
        raise ValueError("channel centers must be integer Hz")
    return fs_i, freqs


def channel_bank_plan(
    n: int,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int,
):
    """Host-side half of the one-matmul DDC bank, split out so callers can
    pre-frame the capture on the HOST (a numpy pad+reshape is a plain copy)
    instead of the in-graph pad+reshape of a flat capture to ``(m, q)``
    frames — the same choice ``models/streaming.py::_blocked`` offers for
    detection blocks.

    Returns ``(plan, (hh, cr, sr))``: ``plan`` holds the framing geometry
    (pl / n_out / a_cols / m / q / c_n for an input of length ``n``) and
    the tables are jnp arrays sized ``(q, 2·C·A)`` / ``(C, m)`` / ``(C, m)``
    meant to be passed as jit *arguments* (large baked-in literals slow
    compilation)."""
    fs_i, freqs = _validated_int_rate_and_freqs(fs, center_freqs)
    h = firwin_lowpass(numtaps, bandwidth / 2.0, fs)
    q, c_n = int(decim), len(freqs)
    pl, n_out, a_cols, _, m = _polyphase_plan(n, h, q)
    hh_j, cr_j, sr_j = _bank_tables(fs_i, freqs, h, q, a_cols, m, pl)
    plan = {
        "n": int(n), "pl": int(pl), "n_out": int(n_out),
        "a_cols": int(a_cols), "m": int(m), "q": q, "c_n": c_n,
    }
    return plan, (hh_j, cr_j, sr_j)


def frame_capture_host(x_np: np.ndarray, plan: dict) -> np.ndarray:
    """HOST-side polyphase framing: numpy pad + reshape of a flat capture
    to the ``(..., m, q)`` frames :func:`channelize_frames` /
    :func:`channelize_iq_frames` consume.  Frames sit at stride q == their
    length, so this is a pure copy (no size blowup) and the uploaded array
    keeps a layout under which the in-graph flatten for the bank GEMM is
    free — the device never pays the flat→framed relayout."""
    pl, m, q = plan["pl"], plan["m"], plan["q"]
    x_np = np.asarray(x_np, np.float32)
    n = x_np.shape[-1]
    if n != plan["n"]:
        raise ValueError(
            f"capture length {n} does not match the plan's n={plan['n']} — "
            "frames built from a mismatched plan would silently pad or "
            "truncate the capture"
        )
    need = m * q
    pad = [(0, 0)] * (x_np.ndim - 1) + [(pl, max(need - n - pl, 0))]
    xp = np.pad(x_np, pad)
    return xp[..., :need].reshape(x_np.shape[:-1] + (m, q))


def frame_capture_sharded_host(x_np: np.ndarray, plan: dict, n_shards: int) -> np.ndarray:
    """Per-time-shard polyphase frames with the ``a_cols−1`` halo frames
    baked in: shard k's rows are global frames ``[k·n_out_loc,
    k·n_out_loc + m_loc)`` (``m_loc = n_out_loc + a_cols − 1``), so a
    time-sharded DDC bank (`parallel.sharded.sharded_channelize_iq_frames`)
    pays neither the in-graph flat→framed reshape nor a ppermute halo
    exchange —
    the duplicated halo rows cost ``(a_cols−1)·n_shards·q`` samples of
    host memcpy, ~0.01% of the capture.  Returns
    ``(n_shards,) + x.shape[:-1] + (m_loc, q)``."""
    f = frame_capture_host(x_np, plan)
    a_cols, n_out = plan["a_cols"], plan["n_out"]
    if n_out % n_shards:
        raise ValueError(f"n_out ({n_out}) must divide across {n_shards} shards")
    n_out_loc = n_out // n_shards
    m_loc = n_out_loc + a_cols - 1
    return np.stack(
        [f[..., k * n_out_loc : k * n_out_loc + m_loc, :] for k in range(n_shards)]
    )


def channelize_frames(
    f: jnp.ndarray, tables, plan: dict
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`channelize` on pre-framed input (see
    :func:`channel_bank_plan` / :func:`frame_capture_host`) — bit-identical
    output, no in-graph framing."""
    dc, ds = _bank_apply(f, *tables, plan["c_n"], plan["a_cols"], plan["n_out"])
    return dc, -ds


def channelize_iq_frames(
    f: jnp.ndarray, tables, plan: dict
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`channelize_iq` on pre-framed input: ``f`` is the framed
    ``(2, ..., m, q)`` stack of (re, im) from
    ``frame_capture_host(np.stack([x_re, x_im]), plan)`` — bit-identical
    output, no in-graph framing."""
    dc, ds = _bank_apply(f, *tables, plan["c_n"], plan["a_cols"], plan["n_out"])
    return dc[0] + ds[1], dc[1] - ds[0]


def _channel_bank(
    x: jnp.ndarray,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shared DDC machinery behind :func:`channelize` / :func:`channelize_iq`:
    for every channel c returns the decimated quadrature projections

        dc = decim((x · cos φ_c) * h),   ds = decim((x · sin φ_c) * h)

    with φ_c(s) = 2π·fc·s/fs at input-sample index s, each output
    ``x.shape[:-1] + (n_channels, n_out)`` float32.

    Formulation: nothing ever runs at the input rate except one matmul.  Splitting the input index ``s = ri·q + b`` (ri = output-rate
    frame row, b = intra-frame offset) splits the mixer phase by angle
    addition, so the intra-frame factor ``cos/sin(2π·fc·b/fs)`` folds into
    the polyphase tap matrix **per channel** on the host, and the whole
    bank becomes

        frames(x) @ [Hcos | Hsin]        # (m, q) @ (q, 2·C·A), one matmul
        y = rotate by per-row phase      # output-rate cos/sin, O(C·m)

    No (C, n) mixer tables or mixed copies of x are materialized (the
    previous elementwise formulation wrote C mixed copies of x to device
    memory; this reads x once).  Mixer phases are exact integer arithmetic mod fs.
    """
    plan, tables = channel_bank_plan(
        x.shape[-1], fs, center_freqs, bandwidth, decim, numtaps
    )
    f = _polyphase_frames(x, plan["pl"], plan["m"], plan["q"])
    return _bank_apply(f, *tables, plan["c_n"], plan["a_cols"], plan["n_out"])


def channelize(
    x: jnp.ndarray,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Multi-channel DDC bank over a *real* capture: mix each beacon channel
    to baseband (``x·e^{-jφ_c}``), lowpass, and decimate — the front half of
    BASELINE config 4's "polyphase channelizer".  Returns the complex
    baseband as a *real pair* ``(re, im)``, each (n_channels, n_out)
    float32 (ROADMAP C6 asks whether complex64 is as fast on the GPU).  See
    :func:`_channel_bank` for the one-matmul formulation.
    """
    dc, ds = _channel_bank(x, fs, center_freqs, bandwidth, decim, numtaps)
    return dc, -ds


def channelize_iq(
    x_re: jnp.ndarray,
    x_im: jnp.ndarray,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`channelize` for a *complex* (I/Q) SDR capture, passed as the
    real pair ``(x_re, x_im)``.  Channel
    centers are baseband offsets and may be **negative** — the lower half
    of the captured span, unreachable from a real capture.

    With x = xr + j·xi and y = decim(LPF(x·e^{-jφ_c})):

        y_re = decim((xr·cosφ)·h) + decim((xi·sinφ)·h)
        y_im = decim((xi·cosφ)·h) − decim((xr·sinφ)·h)

    Both components ride one stacked frames-matmul through
    :func:`_channel_bank` (the tap/phase tables are shared), so the cost is
    exactly 2× the real path — still one matmul at the input rate.
    Returns ``(y_re, y_im)``, each ``x_re.shape[:-1] + (C, n_out)``.
    """
    if x_re.shape != x_im.shape:
        raise ValueError(f"I/Q shape mismatch: {x_re.shape} vs {x_im.shape}")
    x = jnp.stack([x_re, x_im])
    dc, ds = _channel_bank(x, fs, center_freqs, bandwidth, decim, numtaps)
    y_re = dc[0] + ds[1]
    y_im = dc[1] - ds[0]
    return y_re, y_im
