"""Sharded pipelines over the (station, time) mesh via ``shard_map``.

Division of labor (SURVEY.md §2.6, BASELINE configs 3-5):

* the *sample-rate* work (framing, band projection, PSD, FIR) runs fully
  sharded — this is where the FLOPs and HBM traffic are;
* the *block-rate* series (one delta-dB value per 0.2 s) is ~4 orders of
  magnitude smaller, so detection scans run per time-shard with warm-up
  halos and the final event extraction happens on the gathered block
  series, which makes the sharded event list exactly equal the unsharded
  one for the fixed detector and equal up to halo warm-up for the adaptive
  one (exact on shard 0; elsewhere exact whenever the warm-up halo covers
  the estimation window + freeze reach).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from meteor_scatter_tpu.models.adaptive import adaptive_thresholds
from meteor_scatter_tpu.ops.bandpower import band_projection_matrix, band_power_db
from meteor_scatter_tpu.ops.framing import frame_signal
from meteor_scatter_tpu.ops.welch import welch_psd
from meteor_scatter_tpu.ops.window import hann_periodic
from meteor_scatter_tpu.parallel.halo import halo_exchange
from meteor_scatter_tpu.parallel.mesh import STATION_AXIS, TIME_AXIS


def _spec(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def _ensure_varying(x: jnp.ndarray, axes) -> jnp.ndarray:
    """pcast ``x`` to be varying over exactly the union of its current
    varying axes and ``axes`` (pcast rejects no-op casts)."""
    cur = getattr(jax.typeof(x), "vma", frozenset())
    missing = tuple(a for a in axes if a not in cur)
    return lax.pcast(x, missing, to="varying") if missing else x


def _place(x: jnp.ndarray, mesh: Mesh, *axes) -> jnp.ndarray:
    """Pin inputs to the given mesh layout (default: (station, time)).
    Needed because degenerate mesh axes (size 1) leave arrays with a
    replicated GSPMD sharding that eager shard_map refuses to reinterpret;
    device_put alone keeps the original sharding object when it considers
    the layouts equivalent, so route through a jitted identity."""
    spec = _spec(mesh, *(axes or (STATION_AXIS, TIME_AXIS)))
    if getattr(x, "sharding", None) == spec:
        return x
    return jax.jit(lambda a: a, out_shardings=spec)(x)


def sharded_delta_power(
    x: jnp.ndarray,  # (C, S)
    mesh: Mesh,
    fs: float,
    n_fft: int,
    block_size: int,
    freq_band: Tuple[float, float],
    noise_band: Tuple[float, float],
    power_floor: float = 1e-12,
):
    """Blockwise delta power, channels over ``station``, samples over
    ``time``.  Blocks never straddle sample shards (S/n_time must divide by
    block_size), so no halo is needed — pure local matmuls.

    Returns (band_db, noise_db, delta) each (C, num_blocks) sharded
    (station, time).
    """
    M, slices = band_projection_matrix(fs, n_fft, block_size, [freq_band, noise_band])
    Mj = jnp.asarray(M)

    def local(xl):  # (C_loc, S_loc)
        frames = frame_signal(xl.astype(jnp.float32), block_size, block_size)
        band, noise = band_power_db(frames, Mj, slices, power_floor)
        return band, noise, band - noise

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=P(STATION_AXIS, TIME_AXIS),
    )
    return fn(_place(x, mesh))


def sharded_detect_fixed(
    delta: jnp.ndarray,  # (C, B) sharded (station, time)
    mesh: Mesh,
    threshold_std_factor: float,
):
    """Per-channel global threshold via psum over the time axis; returns
    (above mask sharded like delta, per-channel thresholds)."""

    def local(dl):  # (C_loc, B_loc)
        n_loc = dl.shape[-1]
        s = lax.psum(jnp.sum(dl, -1), TIME_AXIS)
        s2 = lax.psum(jnp.sum(dl * dl, -1), TIME_AXIS)
        n = lax.psum(jnp.asarray(n_loc, dl.dtype), TIME_AXIS)
        mean = s / n
        std = jnp.sqrt(jnp.maximum(s2 / n - mean * mean, 0))
        thr = mean + threshold_std_factor * std
        return dl > thr[:, None], thr

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=(P(STATION_AXIS, TIME_AXIS), P(STATION_AXIS)),
    )
    return fn(_place(delta, mesh))


def sharded_detect_adaptive(
    delta: jnp.ndarray,  # (C, B) sharded (station, time)
    mesh: Mesh,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    warmup_blocks: int | None = None,
):
    """Adaptive detection across time shards with warm-up halo recompute.

    Each shard receives the trailing ``warmup_blocks`` delta values of its
    left neighbor (ppermute), replays the threshold recurrence over them to
    converge the rolling statistics, then emits thresholds/above for its
    own range.  Shard 0's replay runs over masked padding with *absolute*
    block indices, so its output is bit-exact to the unsharded scan.
    """
    if warmup_blocks is None:
        warmup_blocks = window_blocks + freeze_blocks_after
    # the halo (warm-up replay + ring seed) cannot exceed one shard's block
    # count (ppermute moves data between direct neighbors only)
    n_time = mesh.shape[TIME_AXIS]
    b_loc_glob = delta.shape[-1] // n_time
    if n_time == 1:
        # no seams — the plain scan from block 0 is already exact
        warmup_blocks = 0
        halo_blocks = 0
    else:
        warmup_blocks = min(warmup_blocks, max(b_loc_glob - window_blocks, 0))
        halo_blocks = warmup_blocks + window_blocks
        if halo_blocks > b_loc_glob:
            raise ValueError(
                f"time shards too small: need >= {window_blocks} blocks/shard "
                f"for the rolling window, have {b_loc_glob}"
            )

    def local(dl):  # (C_loc, B_loc)
        c_loc, b_loc = dl.shape
        dtype = dl.dtype
        # global per-channel stats for the fixed initial threshold
        s = lax.psum(jnp.sum(dl, -1), TIME_AXIS)
        s2 = lax.psum(jnp.sum(dl * dl, -1), TIME_AXIS)
        n = lax.psum(jnp.asarray(float(b_loc), dtype), TIME_AXIS)
        g_mean = s / n
        g_std = jnp.sqrt(jnp.maximum(s2 / n - g_mean * g_mean, 0))

        haloed = halo_exchange(dl, halo_blocks, 0, TIME_AXIS)  # (C_loc, halo+B_loc)
        offset = lax.axis_index(TIME_AXIS) * b_loc
        i0 = (offset - warmup_blocks).astype(jnp.int32)

        # Seed the rolling-stats ring with the true `window` delta values
        # preceding the replay start, at their absolute slot positions.
        # (Shard 0's seed is zeros, but the scan's count-based validity
        # mask hides pre-stream slots there, keeping it bit-exact.)
        w = window_blocks
        if halo_blocks > 0:
            seed_vals = haloed[:, :w]  # absolute indices i0-w .. i0-1
            slots = jnp.mod(i0 + jnp.arange(w, dtype=jnp.int32), w)
            ring0 = jnp.zeros((c_loc, w), dtype).at[:, slots].set(seed_vals)
        else:
            ring0 = _ensure_varying(
                jnp.zeros((c_loc, w), dtype), (STATION_AXIS, TIME_AXIS)
            )

        fixed_thr = (g_mean + threshold_std_factor * g_std).astype(dtype)
        # scan carries must have consistent varying-manual-axes types under
        # shard_map: mark the shard-constant initializers as varying
        both = (STATION_AXIS, TIME_AXIS)
        init_carry = (
            ring0,
            jnp.broadcast_to(i0, (c_loc,)),
            _ensure_varying(jnp.full((c_loc,), -1, jnp.int32), both),
            _ensure_varying(fixed_thr, both),
        )

        def one_channel(d_ch, ring, i0_ch, fz, thr0, gm, gs):
            thr, above, _ = adaptive_thresholds(
                d_ch,
                threshold_std_factor,
                window_blocks,
                freeze_blocks_before,
                freeze_blocks_after,
                fixed_threshold_blocks,
                init_carry=(ring, i0_ch, fz, thr0),
                global_stats=(gm, gs),
            )
            return thr, above

        # with no halo the scan runs over the local blocks directly
        replay = haloed[:, w:] if halo_blocks > 0 else haloed  # (C_loc, warmup + B_loc)
        thr, above = jax.vmap(one_channel)(
            replay, init_carry[0], init_carry[1], init_carry[2], init_carry[3], g_mean, g_std
        )
        thr = _ensure_varying(thr, both)
        above = _ensure_varying(above, both)
        return thr[:, warmup_blocks:], above[:, warmup_blocks:]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=(P(STATION_AXIS, TIME_AXIS), P(STATION_AXIS, TIME_AXIS)),
    )
    return fn(_place(delta, mesh))


def sharded_detect_adaptive_exact(
    delta: jnp.ndarray,  # (C, B) sharded (station, time)
    mesh: Mesh,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
):
    """Bit-exact adaptive detection on time-sharded data.

    The block-rate series is ~4 orders of magnitude smaller than the audio
    (one value per 0.2 s), so gathering each channel's full delta series
    over the time axis and running the vectorized fixpoint solver
    replicated is essentially free next to the sample-rate work — and,
    unlike the warm-up-halo variant (:func:`sharded_detect_adaptive`),
    exactly equals the unsharded result for *every* shard.  Use the halo
    variant only when the block series itself is too large to replicate
    (multi-day × many-station runs).

    Returns (thresholds, above) replicated over time, sharded over station.
    """
    from meteor_scatter_tpu.models.adaptive import adaptive_thresholds_parallel

    def local(dl):  # (C_loc, B_loc)
        full = lax.all_gather(dl, TIME_AXIS, axis=1, tiled=True)  # (C_loc, B)

        def one_channel(d_ch):
            return adaptive_thresholds_parallel(
                d_ch,
                threshold_std_factor,
                window_blocks,
                freeze_blocks_before,
                freeze_blocks_after,
                fixed_threshold_blocks,
            )

        thr, above = jax.vmap(one_channel)(full)
        return thr, above

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=(P(STATION_AXIS), P(STATION_AXIS)),
        # outputs are replicated over 'time' by construction (tiled
        # all_gather feeds every shard the identical full series), but the
        # varying-axes checker can't prove that through the fixpoint loop
        check_vma=False,
    )
    return fn(_place(delta, mesh))


def sharded_spectrogram_psd(
    x: jnp.ndarray,  # (C, S)
    mesh: Mesh,
    fs: float,
    nperseg: int,
    noverlap: int | None = None,
):
    """Overlapped STFT PSD with seam frames computed from a right halo —
    the distributed overlap-save of the reference's noverlap=NFFT//2
    spectrograms.

    Works for any hop: each shard owns the frames whose start sample falls
    in its range.  Per-shard first-frame offsets and counts are static
    (computed from shard size and hop at trace time); inside ``shard_map``
    the shard picks its offset from a small table via ``axis_index`` and
    frames a fixed-size dynamic slice of its haloed samples, so shapes stay
    static even when counts differ by one across shards.  A final gather
    compacts the per-shard padding away.

    Returns (C, n_frames, nbins) with exactly the unsharded frame count
    ``(S - nperseg)//hop + 1``.
    """
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    n_time = mesh.shape[TIME_AXIS]
    S = x.shape[-1]
    if S % n_time:
        raise ValueError(f"signal length {S} must divide over {n_time} time shards")
    s_loc = S // n_time
    nf_global = (S - nperseg) // hop + 1
    if nf_global <= 0:
        raise ValueError("signal shorter than one frame")

    # static per-shard bookkeeping: first global frame starting in shard k,
    # its sample offset inside the shard, and the frame count
    firsts = [min(-(-(k * s_loc) // hop), nf_global) for k in range(n_time)] + [nf_global]
    nf_k = [firsts[k + 1] - firsts[k] for k in range(n_time)]
    nf_max = max(max(nf_k), 1)
    offs = np.asarray(
        [firsts[k] * hop - k * s_loc for k in range(n_time)], np.int32
    )  # ∈ [0, hop)
    slice_len = nf_max * hop + (nperseg - hop)
    right_halo = max(0, int(offs.max()) + slice_len - s_loc)
    if right_halo > s_loc:
        raise ValueError(
            f"time shards too small: frame window needs a {right_halo}-sample "
            f"halo but shards hold only {s_loc} samples"
        )

    win = jnp.asarray(hann_periodic(nperseg, dtype=np.float32))
    norm = float(np.sum(hann_periodic(nperseg) ** 2))
    offs_j = jnp.asarray(offs)

    def local(xl):  # (C_loc, S_loc)
        haloed = halo_exchange(xl.astype(jnp.float32), 0, right_halo, TIME_AXIS)
        k = jax.lax.axis_index(TIME_AXIS)
        windowed = jax.lax.dynamic_slice_in_dim(haloed, offs_j[k], slice_len, axis=-1)
        seg = frame_signal(windowed, nperseg, hop)  # exactly nf_max frames
        seg = seg - jnp.mean(seg, -1, keepdims=True)
        X = jnp.fft.rfft(seg * win, n=nperseg, axis=-1)
        p = (X.real**2 + X.imag**2) / (fs * norm)
        nbins = nperseg // 2 + 1
        scale = np.ones(nbins, np.float32) * 2.0
        scale[0] = 1.0
        if nperseg % 2 == 0:
            scale[-1] = 1.0
        return p * jnp.asarray(scale)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=P(STATION_AXIS, TIME_AXIS, None),
    )
    padded = fn(_place(x, mesh))  # (C, n_time*nf_max, nbins)
    keep = np.concatenate(
        [k * nf_max + np.arange(nf_k[k]) for k in range(n_time)]
    ).astype(np.int32)
    return jnp.take(padded, jnp.asarray(keep), axis=1)


def sharded_fir_filter(
    x: jnp.ndarray,  # (C, S)
    mesh: Mesh,
    taps: np.ndarray,
):
    """'same'-mode FIR across time shards: each shard convolves its range
    plus (t-1)/2-sample halos from both neighbors, exactly matching the
    unsharded result (zero halos at the stream edges = 'same' padding)."""
    t = len(taps)
    lh = (t - 1) // 2
    rh = t - 1 - lh
    k = jnp.asarray(np.asarray(taps, np.float32)[::-1].copy()).reshape(1, 1, -1)

    def local(xl):
        haloed = halo_exchange(xl.astype(jnp.float32), lh, rh, TIME_AXIS)
        y = lax.conv_general_dilated(
            haloed[:, None, :],
            k,
            window_strides=(1,),
            padding=[(0, 0)],
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=lax.Precision.HIGHEST,
        )
        return y[:, 0, :]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=P(STATION_AXIS, TIME_AXIS),
    )
    return fn(_place(x, mesh))


def sharded_stream_process(
    cfg,  # DetectionConfig
    state,  # StreamState with per-channel leaves, or None to initialize
    x: jnp.ndarray,  # (C, S) flat, or (C, n_blocks, block) pre-blocked
    fs: float,
    mesh: Mesh,
    front: str = "auto",
    impl: str = "auto",
):
    """Time-sharded streaming 3-state machine (the reference's
    `processor.py:444-510` sequential loop, SURVEY.md §2.6
    "sequential-state parallelism").

    Division of labor mirrors :func:`sharded_detect_adaptive_exact`: the
    Welch front half — where all the FLOPs and HBM traffic are — runs fully
    sharded over (station, time); the resulting block-rate series (one
    scalar per 0.2 s, ~4 orders of magnitude smaller than the audio) is
    all-gathered over the time axis and the sequential state-machine scan
    runs replicated per device.  The scan is inherently serial (the locked
    threshold can chain across arbitrarily many blocks, so no bounded halo
    recomputes it exactly); replicating the tiny scan wastes nothing — its
    wall-clock equals a single-device scan — and keeps the result bit-exact
    to the unsharded :func:`stream_process`, which
    `tests/test_parallel.py` pins on the 8-device mesh.

    The carried ``StreamState`` is per-channel (leading C axis, see
    ``stream_init_batch``), so chunked long-stream processing keeps working
    across calls exactly like the single-device path.

    ``impl="jump"``/``"hop"`` swap the replicated block-rate scan for the
    episode-jump solvers (same parity caveats as the single-device path).
    ``impl="fused"`` runs the batch-native fused Pallas streaming-machine
    kernel (`ops/pallas/stream_kernel.py`) on each device's *local* station
    group — the bins/welch front stays sharded over (station, time), the
    block-rate series is all-gathered over time as usual, and one kernel
    launch walks every local channel's series
    (bit-exact vs the vmapped scan, tests/test_streaming_fused.py).
    ``front``/``impl="auto"`` resolve to the platform's defaults
    (``resolve_stream_auto``).
    ``front="bins"`` selects the headless bins-only front half
    (:func:`meteor_scatter_tpu.models.streaming.stream_front_headless` —
    one matmul per shard instead of full Welch PSDs); no psd waterfall
    is produced and the same opt-in caveats apply as on the single-device
    path.

    Returns (new_state, events, diags): state/events with per-channel
    leading dims (sharded over station, replicated over time); diags with
    the full over_noise/threshold series (replicated over time) and the
    psd waterfall left sharded (station, time) — Welch front only.
    """
    from meteor_scatter_tpu.models.streaming import (
        StreamConfig,
        resolve_stream_auto,
        stream_front,
        stream_front_headless,
        stream_init_batch,
        stream_scan,
        stream_scan_fused_batch,
        stream_scan_jump,
        stream_scan_jump_batch,
    )
    from meteor_scatter_tpu.ops.welch import welch_freqs

    block = int(round(cfg.proc_block_sec * fs))
    n_time = mesh.shape[TIME_AXIS]
    preblocked = x.ndim == 3
    if preblocked:
        # (C, n_blocks, block), see models/streaming.py::_blocked; the
        # time axis shards blocks.
        n_ch, B = x.shape[:2]
        if x.shape[-1] != block:
            raise ValueError(
                f"pre-blocked input must have trailing dim {block}, "
                f"got {x.shape[-1]}"
            )
        if B % n_time:
            raise ValueError(
                f"blocks per time shard ({B}/{n_time}) must be whole"
            )
    else:
        n_ch, S = x.shape
        if S % n_time or (S // n_time) % block:
            raise ValueError(
                f"samples per time shard ({S}/{n_time}) must be a whole "
                f"number of {block}-sample blocks"
            )
    front, impl = resolve_stream_auto(front, impl)
    scfg = StreamConfig.from_config(cfg)
    if state is None:
        state = stream_init_batch(scfg, n_ch)

    if front not in ("welch", "bins"):
        raise ValueError(f"unknown front {front!r} (use 'welch' or 'bins')")
    if impl == "scan":
        solver = stream_scan
    elif impl == "jump":
        solver = stream_scan_jump
    elif impl == "hop":
        solver = stream_scan_jump_batch
    elif impl == "fused":
        solver = None  # batch-native: one kernel per local station group
    else:
        raise ValueError(
            f"unknown impl {impl!r} (use 'scan', 'jump', 'hop' or 'fused')"
        )
    headless = front == "bins"

    def local(xl, st):  # (C_loc, S_loc); state leaves (C_loc, ...)
        if headless:
            on, pm, _ = stream_front_headless(cfg, xl, fs)  # (C_loc, B_loc)
        else:
            on, pm, dfront = stream_front(cfg, xl, fs)
        on_full = lax.all_gather(on, TIME_AXIS, axis=-1, tiled=True)
        pm_full = lax.all_gather(pm, TIME_AXIS, axis=-1, tiled=True)
        if solver is None:
            st2, ev, thr = stream_scan_fused_batch(scfg, st, on_full, pm_full)
        else:
            st2, ev, thr = jax.vmap(lambda s, o, p: solver(scfg, s, o, p))(
                st, on_full, pm_full
            )
        if headless:
            return st2, ev, thr, on_full
        return st2, ev, thr, on_full, dfront["psd_db"]

    out_specs = (
        P(STATION_AXIS),  # state (replicated over time by construction)
        P(STATION_AXIS),  # events
        P(STATION_AXIS),  # thresholds (C, B)
        P(STATION_AXIS),  # over_noise (C, B)
    )
    if not headless:
        out_specs = out_specs + (P(STATION_AXIS, TIME_AXIS, None),)  # psd waterfall
    x_spec = (
        P(STATION_AXIS, TIME_AXIS, None) if preblocked
        else P(STATION_AXIS, TIME_AXIS)
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(x_spec, P(STATION_AXIS)),
        out_specs=out_specs,
        # the gathered block series is identical on every time shard, so
        # state/events/thresholds are time-replicated by construction; the
        # checker can't prove that through the scan
        check_vma=False,
    )
    state_placed = jax.tree_util.tree_map(
        lambda a: _place(a, mesh, STATION_AXIS), state
    )
    out = fn(_place(x, mesh), state_placed)
    st2, ev, thr, on_full = out[:4]
    diags = {"over_noise": on_full, "threshold": thr}
    if not headless:
        diags["psd_db"] = out[4]
        diags["freqs"] = welch_freqs(fs, cfg.n_fft)
    return st2, ev, diags


def _iq_bank_setup(n, fs, center_freqs, bandwidth, decim, numtaps, n_time):
    """Shared host-side setup for the time-sharded DDC bank (tables, local
    framing geometry, and the exact-integer per-(shard, channel) phase
    rotation) — used by both the flat and the pre-framed forms."""
    from meteor_scatter_tpu.ops.fir import (
        _bank_tables,
        _validated_int_rate_and_freqs,
        firwin_lowpass,
    )

    fs_i, freqs = _validated_int_rate_and_freqs(fs, center_freqs)
    q, c_n = int(decim), len(freqs)
    if n % (q * n_time):
        raise ValueError(
            f"samples ({n}) must divide into whole decimation frames per "
            f"time shard (q·n_time = {q * n_time})"
        )
    t = int(numtaps)
    pl = (t - 1) // 2
    a_cols = -(-t // q)
    rh = (a_cols - 1) * q - pl
    if rh < 0:
        raise ValueError("numtaps must be >= 2*decim for the sharded bank")
    s_loc = n // n_time
    n_out_loc = s_loc // q
    m_loc = n_out_loc + a_cols - 1

    h = firwin_lowpass(t, bandwidth / 2.0, fs)
    hh_j, cr_j, sr_j = _bank_tables(fs_i, freqs, h, q, a_cols, m_loc, pl)

    # per-(shard, channel) constant rotation, exact integer phase arithmetic
    ks = np.arange(n_time, dtype=np.int64)[:, None] * s_loc
    ph = (ks * np.asarray(freqs, np.int64)[None, :]) % fs_i
    ang = 2.0 * np.pi * ph / fs_i
    cth = jnp.asarray(np.cos(ang), jnp.float32)  # (n_time, C)
    sth = jnp.asarray(np.sin(ang), jnp.float32)
    return (q, c_n, a_cols, pl, rh, s_loc, n_out_loc, m_loc,
            hh_j, cr_j, sr_j, cth, sth)


def sharded_channelize_iq(
    x_re: jnp.ndarray,  # (S,) wideband I component
    x_im: jnp.ndarray,  # (S,) wideband Q component
    mesh: Mesh,
    fs: float,
    center_freqs,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
):
    """Time-sharded one-matmul DDC bank — BASELINE config 4's wideband I/Q
    front half at pod scale (`meteor_scatter_tpu.ops.fir.channelize_iq` is
    the single-device form; reference anchor: the offline GQRX/HDSDR
    resampling the reference assumes, `dsp/src/live/main.py:23,45`).

    Each time shard frames its samples plus a ``(pl, (A−1)·q − pl)`` halo
    and runs the same polyphase matmul + phase rotation as the unsharded
    bank.  The mixer is linear and its phase is linear in the absolute
    sample index, so the only global bookkeeping is one constant complex
    rotation per (shard, channel):

        φ_global(s) = φ_local(s_loc) + φ(k·S_loc)
        ⟹  y_global = e^{−jθ_{k,c}} · y_local,  θ_{k,c} = 2π·((k·S_loc·f_c) mod fs)/fs

    with θ computed in exact integer arithmetic on the host and passed in
    as a per-shard table.  Equal to :func:`channelize_iq` up to one extra
    f32 rotation per sample (the halo zeros at the stream edges match its
    'same' padding); pinned in ``tests/test_parallel.py``.

    Returns ``(y_re, y_im)``, each (C, n_out) sharded over the time axis.
    """
    n = x_re.shape[-1]
    if x_re.shape != x_im.shape:
        raise ValueError(f"I/Q shape mismatch: {x_re.shape} vs {x_im.shape}")
    n_time = mesh.shape[TIME_AXIS]
    (q, c_n, a_cols, pl, rh, s_loc, n_out_loc, m_loc,
     hh_j, cr_j, sr_j, cth, sth) = _iq_bank_setup(
        n, fs, center_freqs, bandwidth, decim, numtaps, n_time
    )
    from meteor_scatter_tpu.ops.fir import _bank_apply

    def local(xr, xi, hh, cr, sr, ct, st):
        xs = jnp.stack([xr.astype(jnp.float32), xi.astype(jnp.float32)])
        xh = halo_exchange(xs, pl, rh, TIME_AXIS)  # (2, m_loc·q)
        f = xh.reshape(2, m_loc, q)
        dc, ds = _bank_apply(f, hh, cr, sr, c_n, a_cols, n_out_loc)
        y_re = dc[0] + ds[1]  # channelize_iq combination
        y_im = dc[1] - ds[0]
        c = ct[0][:, None]  # (C, 1) — this shard's rotation
        s = st[0][:, None]
        return c * y_re + s * y_im, c * y_im - s * y_re

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(TIME_AXIS), P(TIME_AXIS),
            P(), P(), P(),
            P(TIME_AXIS, None), P(TIME_AXIS, None),
        ),
        out_specs=(P(None, TIME_AXIS), P(None, TIME_AXIS)),
    )
    return fn(
        _place(x_re, mesh, TIME_AXIS), _place(x_im, mesh, TIME_AXIS),
        hh_j, cr_j, sr_j,
        _place(cth, mesh, TIME_AXIS, None), _place(sth, mesh, TIME_AXIS, None),
    )


def sharded_channelize_iq_frames(
    f_sh: jnp.ndarray,  # (n_time, 2, m_loc, q) per-shard frames incl. halo
    mesh: Mesh,
    fs: float,
    center_freqs,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
):
    """Pre-framed multi-device form of :func:`sharded_channelize_iq`: the
    host bakes per-shard polyphase frames *with the halo rows included*
    (`meteor_scatter_tpu.ops.fir.frame_capture_sharded_host`), so each time
    shard pays neither the in-graph flat→framed reshape nor any ppermute
    halo exchange (the a_cols−1 duplicated frame rows per shard replace it
    at ~0.01% of the capture in host memcpy).  Bit-identical to the flat form: the
    local frames and tables are the same values, so `_bank_apply` and the
    per-shard rotation see identical inputs
    (pinned in ``tests/test_parallel.py``).

    Returns ``(y_re, y_im)``, each (C, n_out) sharded over the time axis.
    """
    from meteor_scatter_tpu.ops.fir import _bank_apply

    n_time = mesh.shape[TIME_AXIS]
    if f_sh.ndim != 4 or f_sh.shape[0] != n_time or f_sh.shape[1] != 2:
        raise ValueError(
            f"expected (n_time={n_time}, 2, m_loc, q) pre-framed input, "
            f"got {f_sh.shape}"
        )
    q = int(decim)
    a_cols = -(-int(numtaps) // q)
    m_loc = f_sh.shape[2]
    n_out_loc = m_loc - (a_cols - 1)
    n = n_out_loc * q * n_time
    (q, c_n, a_cols, pl, rh, s_loc, n_out_loc2, m_loc2,
     hh_j, cr_j, sr_j, cth, sth) = _iq_bank_setup(
        n, fs, center_freqs, bandwidth, decim, numtaps, n_time
    )
    if (n_out_loc2, m_loc2) != (n_out_loc, m_loc):
        # frames were built with a different decim/numtaps than this call's
        # plan — proceeding would feed _bank_apply inconsistent a_cols and
        # return silently wrong channel outputs (and a bare assert would be
        # stripped under `python -O`)
        raise ValueError(
            f"pre-framed geometry (m_loc={m_loc}, n_out_loc={n_out_loc}) "
            f"does not match the bank plan for decim={decim}, "
            f"numtaps={numtaps} (expected m_loc={m_loc2}, "
            f"n_out_loc={n_out_loc2})"
        )

    def local(fl, hh, cr, sr, ct, st):
        f = fl[0].astype(jnp.float32)  # (2, m_loc, q)
        dc, ds = _bank_apply(f, hh, cr, sr, c_n, a_cols, n_out_loc)
        y_re = dc[0] + ds[1]
        y_im = dc[1] - ds[0]
        c = ct[0][:, None]
        s = st[0][:, None]
        return c * y_re + s * y_im, c * y_im - s * y_re

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(TIME_AXIS, None, None, None),
            P(), P(), P(),
            P(TIME_AXIS, None), P(TIME_AXIS, None),
        ),
        out_specs=(P(None, TIME_AXIS), P(None, TIME_AXIS)),
    )
    return fn(
        _place(f_sh, mesh, TIME_AXIS, None, None, None),
        hh_j, cr_j, sr_j,
        _place(cth, mesh, TIME_AXIS, None), _place(sth, mesh, TIME_AXIS, None),
    )


def sharded_welch_blocks(
    x: jnp.ndarray,  # (C, S)
    mesh: Mesh,
    fs: float,
    block_size: int,
    nfft: int,
    nperseg: int = 256,
):
    """Per-block Welch PSDs (the streaming front half, processor.py:206)
    sharded over channels and time; blocks are hop-aligned so no halo."""

    def local(xl):
        blocks = frame_signal(xl.astype(jnp.float32), block_size, block_size)
        return welch_psd(blocks, fs, nfft, nperseg=nperseg)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(STATION_AXIS, TIME_AXIS),
        out_specs=P(STATION_AXIS, TIME_AXIS, None),
    )
    return fn(_place(x, mesh))
