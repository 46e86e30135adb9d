"""Streaming 3-state detector (Initialization → Detection → Tracking).

Accelerator re-design of `dsp/src/live/backend/processor.py:176-510`.  The
reference walks blocks in a Python loop mutating dataclass states
(`aggregates.py:4-24`); here the whole decision process is ONE flat carry
struct advanced by ``lax.scan``, and the per-block spectral work (Welch PSD
+ three band sums) is batched *outside* the scan so it runs as a single
fused FFT+reduction over the whole chunk.

Per-block semantics preserved exactly (verified in tests against a numpy
oracle of the reference loop):

* over-noise level: ms_db − mean(noise1_db, noise2_db)   (`processor.py:393`)
* rolling mean/std over the last ``avg_win`` values *excluding* the current
  block (`processor.py:394-404`; the history slice is taken before append)
* threshold = mean + k·std, overridden by the locked threshold while
  Tracking, or while Detection inside the post-tracking lock window
  (`processor.py:406-413`).  The reference compares float seconds
  (``use_locked_until > block_end_sec``); here the lock window and the
  minimum-duration acceptance are evaluated in **exact integer block
  arithmetic** (:func:`lock_tail_blocks` / :func:`min_duration_blocks`) —
  identical to the float comparison everywhere except exact
  real-arithmetic ties (lock expiring precisely on a block edge), where
  float rounding direction is compiler-dependent: XLA may or may not
  contract ``i·bs + W`` into an FMA per graph, so two formulations of the
  same machine could legitimately disagree at those blocks.  Integer
  arithmetic removes the instability and matches exact real semantics.
* Initialization: accumulate mean PSD dB until
  ``block_start_sec >= init_detection_wait_sec`` (`processor.py:444-457`)
* Detection→Tracking on ``over_noise > threshold`` with the threshold
  locked at that value (`processor.py:459-471`)
* Tracking appends the current block to the event history *before* the
  below-threshold check, so the terminating block is included in the event
  statistics (`processor.py:475-488`)
* event accepted iff mean ≥ detection_db_over_noise_mean_min and duration
  ≥ detection_dur_min_sec; duration = block_start − track_start
  (`processor.py:476-493`)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import functools

from meteor_scatter_tpu import platform
from meteor_scatter_tpu.config import DetectionConfig
from meteor_scatter_tpu.ops.welch import (
    band_sum_db,
    block_band_matrix,
    block_band_sums_db,
    welch_freqs,
    welch_psd,
)

# State machine encoding
INIT, DETECT, TRACK = 0, 1, 2


def lock_tail_blocks(after_wait_sec: float, block_sec: float) -> int:
    """Largest integer m with ``m·block_sec < after_wait_sec`` in exact real
    arithmetic: after a track-leave at block j, the locked threshold applies
    in Detection through block ``j + m − 1`` (the reference condition
    ``t_start(j) + W > t_end(i)`` ⟺ ``(i+1−j)·bs < W``, processor.py:406)."""
    import math

    return int(math.ceil(after_wait_sec / block_sec - 1e-9)) - 1


def min_duration_blocks(min_dur_sec: float, block_sec: float) -> int:
    """Smallest integer n with ``n·block_sec ≥ min_dur_sec`` in exact real
    arithmetic — the accept rule ``duration ≥ detection_dur_min_sec``
    (processor.py:476-493) with duration = (leave − entry) blocks."""
    import math

    return int(math.ceil(min_dur_sec / block_sec - 1e-9))


class StreamConfig(NamedTuple):
    """Static (trace-time) parameters derived from DetectionConfig."""

    block_sec: float
    avg_win: int  # blocks
    init_wait_sec: float
    after_wait_sec: float
    k_std: float
    min_mean_db: float
    min_dur_sec: float
    cap: int

    @staticmethod
    def from_config(cfg: DetectionConfig) -> "StreamConfig":
        return StreamConfig(
            block_sec=cfg.proc_block_sec,
            avg_win=int(cfg.avg_win_sec / cfg.proc_block_sec),
            init_wait_sec=cfg.init_detection_wait_sec,
            after_wait_sec=cfg.after_tracking_wait_sec,
            k_std=cfg.threshold_std_factor,
            min_mean_db=cfg.detection_db_over_noise_mean_min,
            min_dur_sec=cfg.detection_dur_min_sec,
            cap=cfg.max_events,
        )


class StreamEvents(NamedTuple):
    """DetectedMeteor fields (`aggregates.py:66-74`) as fixed-cap arrays."""

    time_start: jnp.ndarray
    time_stop: jnp.ndarray
    duration: jnp.ndarray
    db_min: jnp.ndarray
    db_max: jnp.ndarray
    db_mean: jnp.ndarray
    db_std: jnp.ndarray
    count: jnp.ndarray
    overflow: jnp.ndarray


class StreamState(NamedTuple):
    """Scan carry — the flattened union of the reference's three state
    dataclasses plus the rolling history."""

    state: jnp.ndarray  # int32: INIT/DETECT/TRACK
    block_idx: jnp.ndarray  # int32 absolute block counter
    ring: jnp.ndarray  # f32 [avg_win] trailing over-noise values
    locked_threshold: jnp.ndarray
    locked_until_block: jnp.ndarray  # int32: last block the lock applies to
    track_start_sec: jnp.ndarray
    track_start_block: jnp.ndarray  # int32 absolute entry block
    # running stats of the tracking history
    tr_count: jnp.ndarray
    tr_sum: jnp.ndarray
    tr_sumsq: jnp.ndarray
    tr_min: jnp.ndarray
    tr_max: jnp.ndarray
    # initialization-phase PSD accumulation (auto-gain, processor.py:448-454)
    init_sum: jnp.ndarray
    init_count: jnp.ndarray
    psd_db_mean_from_init: jnp.ndarray


def stream_init(cfg: StreamConfig, dtype=jnp.float32) -> StreamState:
    z = jnp.zeros((), dtype)
    return StreamState(
        state=jnp.asarray(INIT, jnp.int32),
        block_idx=jnp.asarray(0, jnp.int32),
        ring=jnp.zeros(cfg.avg_win, dtype),
        locked_threshold=z - 1.0,
        locked_until_block=jnp.asarray(-1, jnp.int32),
        track_start_sec=z,
        track_start_block=jnp.asarray(0, jnp.int32),
        tr_count=jnp.asarray(0, jnp.int32),
        tr_sum=z,
        tr_sumsq=z,
        tr_min=z + jnp.inf,
        tr_max=z - jnp.inf,
        init_sum=z,
        init_count=jnp.asarray(0, jnp.int32),
        psd_db_mean_from_init=z,
    )


def stream_init_batch(cfg: StreamConfig, n_channels: int, dtype=jnp.float32) -> StreamState:
    """Per-channel initial state: every :func:`stream_init` leaf gains a
    leading (n_channels,) axis — the carry layout the sharded/vmapped
    streaming paths use."""
    s = stream_init(cfg, dtype)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_channels,) + x.shape), s
    )


def _empty_events(cap: int, dtype) -> StreamEvents:
    zf = jnp.zeros(cap, dtype)
    return StreamEvents(
        time_start=zf,
        time_stop=zf,
        duration=zf,
        db_min=zf,
        db_max=zf,
        db_mean=zf,
        db_std=zf,
        count=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(False),
    )


def stream_step(cfg: StreamConfig, state: StreamState, events: StreamEvents, over_noise, psd_db_mean):
    """Advance one block.  Returns (state, events, effective_threshold)."""
    dtype = over_noise.dtype
    i = state.block_idx
    bs = jnp.asarray(cfg.block_sec, dtype)
    t_start = i.astype(dtype) * bs
    lock_tail = lock_tail_blocks(cfg.after_wait_sec, cfg.block_sec)
    min_dur_b = min_duration_blocks(cfg.min_dur_sec, cfg.block_sec)

    # rolling stats over trailing window (current block excluded)
    w = cfg.avg_win
    cnt = jnp.minimum(i, w)
    valid = jnp.arange(w) < cnt
    cnt_f = jnp.maximum(cnt, 1).astype(dtype)
    m = jnp.sum(jnp.where(valid, state.ring, 0)) / cnt_f
    m2 = jnp.sum(jnp.where(valid, state.ring * state.ring, 0)) / cnt_f
    std = jnp.sqrt(jnp.maximum(m2 - m * m, 0))
    base_thr = jnp.where(cnt > 0, m + cfg.k_std * std, jnp.nan)

    thr = jnp.where(
        state.state == TRACK,
        state.locked_threshold,
        jnp.where(
            (state.state == DETECT) & (i <= state.locked_until_block),
            state.locked_threshold,
            base_thr,
        ),
    )

    # ---- INIT ----
    new_init_sum = state.init_sum + psd_db_mean
    new_init_count = state.init_count + 1
    init_done = t_start >= cfg.init_wait_sec
    psd_mean_from_init = new_init_sum / jnp.maximum(new_init_count, 1).astype(dtype)

    # ---- DETECT: enter tracking? ----
    enter_track = over_noise > thr

    # ---- TRACK: update history stats (current block appended first) ----
    tr_count = state.tr_count + 1
    tr_sum = state.tr_sum + over_noise
    tr_sumsq = state.tr_sumsq + over_noise * over_noise
    tr_min = jnp.minimum(state.tr_min, over_noise)
    tr_max = jnp.maximum(state.tr_max, over_noise)
    leave_track = over_noise < thr

    dur = t_start - state.track_start_sec
    h_cnt = jnp.maximum(tr_count, 1).astype(dtype)
    h_mean = tr_sum / h_cnt
    h_var = jnp.maximum(tr_sumsq / h_cnt - h_mean * h_mean, 0)
    h_std = jnp.sqrt(h_var)
    accept = (h_mean >= cfg.min_mean_db) & (i - state.track_start_block >= min_dur_b)

    is_init = state.state == INIT
    is_detect = state.state == DETECT
    is_track = state.state == TRACK

    emit = is_track & leave_track & accept
    slot = jnp.where(emit & (events.count < cfg.cap), events.count, cfg.cap)
    events = StreamEvents(
        time_start=events.time_start.at[slot].set(state.track_start_sec, mode="drop"),
        time_stop=events.time_stop.at[slot].set(t_start, mode="drop"),
        duration=events.duration.at[slot].set(dur, mode="drop"),
        db_min=events.db_min.at[slot].set(tr_min, mode="drop"),
        db_max=events.db_max.at[slot].set(tr_max, mode="drop"),
        db_mean=events.db_mean.at[slot].set(h_mean, mode="drop"),
        db_std=events.db_std.at[slot].set(h_std, mode="drop"),
        count=events.count + emit.astype(jnp.int32),
        overflow=events.overflow | (emit & (events.count >= cfg.cap)),
    )

    next_state = jnp.where(
        is_init,
        jnp.where(init_done, DETECT, INIT),
        jnp.where(
            is_detect,
            jnp.where(enter_track, TRACK, DETECT),
            jnp.where(leave_track, DETECT, TRACK),
        ),
    ).astype(jnp.int32)

    new_state = StreamState(
        state=next_state,
        block_idx=i + 1,
        ring=state.ring.at[jnp.mod(i, w)].set(over_noise),
        locked_threshold=jnp.where(
            is_detect & enter_track, thr, state.locked_threshold
        ),
        locked_until_block=jnp.where(
            is_track & leave_track, i + (lock_tail - 1), state.locked_until_block
        ).astype(jnp.int32),
        track_start_sec=jnp.where(is_detect & enter_track, t_start, state.track_start_sec),
        track_start_block=jnp.where(
            is_detect & enter_track, i, state.track_start_block
        ).astype(jnp.int32),
        tr_count=jnp.where(is_detect & enter_track, 0, jnp.where(is_track, tr_count, state.tr_count)),
        tr_sum=jnp.where(is_detect & enter_track, 0.0, jnp.where(is_track, tr_sum, state.tr_sum)),
        tr_sumsq=jnp.where(is_detect & enter_track, 0.0, jnp.where(is_track, tr_sumsq, state.tr_sumsq)),
        tr_min=jnp.where(is_detect & enter_track, jnp.inf, jnp.where(is_track, tr_min, state.tr_min)),
        tr_max=jnp.where(is_detect & enter_track, -jnp.inf, jnp.where(is_track, tr_max, state.tr_max)),
        init_sum=jnp.where(is_init, new_init_sum, state.init_sum),
        init_count=jnp.where(is_init, new_init_count, state.init_count),
        psd_db_mean_from_init=jnp.where(
            is_init & init_done, psd_mean_from_init, state.psd_db_mean_from_init
        ),
    )
    return new_state, events, thr


def _ring_base_thresholds(ring, i0, on, w: int, k_std, dtype):
    """Per-block rolling threshold, bit-compatible with the in-scan ring.

    The scan's reduction sums the ring in *physical slot order*; slot j just
    before absolute step i holds the value at block ``k = i-w + ((j-i) mod
    w)``, so the trailing-window matrix is ``concat(previous-ring-in-
    absolute-order, chunk)`` windowed and per-row rotated.

    The window matrix is built WITHOUT data-dependent gather indices
    (a batched gather whose indices depend on a traced ``i0`` was a
    serialized path on the previous accelerator; ROADMAP C5 asks whether
    the GPU needs this).  Instead: ``w`` *static* slices give the natural
    sliding windows
    ``nat[i, m] = ext[i+m]``, and the slot-order rotation — whose amount
    ``(-(i0+i)) mod w`` depends on ``i`` only through the row class
    ``c = i mod w`` — is applied by one (w, w, w) one-hot einsum.  A
    one-hot contraction copies each element exactly (1·x plus
    0-terms), so the result is bit-identical to the gather it replaces
    for finite inputs; a raw ±inf level would turn into NaN over its whole
    window via 0·inf terms, so the front halves clamp ±inf to a finite
    sentinel before any solver sees it (:func:`_sanitize_levels`).
    """
    n = on.shape[0]
    j2 = jnp.arange(w)
    # prev_vals[m] = ring[(i0 - w + m) mod w] — one-hot matmul, not gather.
    # Precision.HIGHEST on every one-hot contraction here: a DEFAULT f32 dot
    # may lower to reduced-precision bf16 passes on some XLA versions, which
    # would silently round thresholds — the repo convention for
    # exactness-critical dots (ops/fir.py, ops/bandpower.py).
    src = jnp.mod(i0 - w + j2, w)
    prev_vals = jnp.matmul(
        (src[:, None] == j2[None, :]).astype(dtype),
        ring.astype(dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    ext = jnp.concatenate([prev_vals, on.astype(dtype)])

    g = -(-n // w)
    n_pad = g * w
    ext_p = jnp.concatenate([ext, jnp.zeros(n_pad - n + w - 1, dtype)])
    nat = jnp.stack([ext_p[m : m + n_pad] for m in range(w)], axis=1)  # (n_pad, w)

    # v[i, j] = nat[i, (j - i0 - i) mod w]; rotation shared by row class
    rot = jnp.mod(j2[None, :] - i0 - j2[:, None], w)  # (class c, j)
    onehot = (rot[:, None, :] == j2[None, :, None]).astype(dtype)  # (c, m, j)
    v = jnp.einsum(
        "gcm,cmj->gcj", nat.reshape(g, w, w), onehot,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(n_pad, w)[:n]

    i_abs = i0 + jnp.arange(n)[:, None]
    j = jnp.arange(w)[None, :]
    cnt = jnp.minimum(i_abs[:, 0], w)
    valid = j < cnt[:, None]
    cnt_f = jnp.maximum(cnt, 1).astype(dtype)
    m = jnp.sum(jnp.where(valid, v, 0), axis=1) / cnt_f
    m2 = jnp.sum(jnp.where(valid, v * v, 0), axis=1) / cnt_f
    std = jnp.sqrt(jnp.maximum(m2 - m * m, 0))
    return jnp.where(cnt > 0, m + k_std * std, jnp.nan), ext


def _blocked(samples: jnp.ndarray, block: int) -> jnp.ndarray:
    """Shape audio as ``(..., n_blocks, block)``.

    Arrays uploaded already shaped ``(..., n_blocks, block)`` (ndim ≥ 3; a
    host-side numpy reshape is free) pass through; a flat ``(..., S)``
    capture is cut to whole blocks and reshaped in-graph.  The pre-blocked
    form was a layout workaround for the previous accelerator; ROADMAP C4
    asks whether the GPU needs it.
    """
    if samples.ndim >= 3 and samples.shape[-1] == block:
        return samples
    n_blocks = samples.shape[-1] // block
    return samples[..., : n_blocks * block].reshape(
        samples.shape[:-1] + (n_blocks, block)
    )


def _sanitize_levels(on: jnp.ndarray) -> jnp.ndarray:
    """Clamp ±inf over-noise levels (digital-silence / saturated-capture dB)
    to a large finite sentinel at the front/solver boundary.  The one-hot
    threshold contraction in :func:`_ring_base_thresholds` would turn a ±inf
    sample into NaN over its whole trailing window via 0·inf terms, whereas
    the reference-formulation gather kept ±inf localized (ADVICE r3);
    clamping restores locality for degenerate captures.  Finite values pass
    through bit-unchanged (`clip` is the identity inside the bounds), so
    every solver-parity and oracle contract is unaffected on real signals.
    The sentinel is 1e15, not f32-max: the rolling-variance sums square the
    levels, and the square must itself stay finite in f32 (1e30 < 3.4e38)
    or the ±inf would just reappear one op later.  Physical dB levels are
    O(±100), so the clamp can never touch a real signal.

    NaN is mapped to the negative sentinel too (``jnp.clip`` alone would
    pass it through): a NaN here can only come from degenerate arithmetic
    on non-finite levels, and once inside a solver it spreads through the
    0·NaN terms of the one-hot contractions to windows that never saw the
    bad block — breaking the chunked==unchunked bit-equality contract
    (ADVICE r4).  Callers must also sanitize the three band levels
    *individually* before the band subtraction (silence then becomes
    ``sentinel - sentinel = 0`` instead of ``-inf - (-inf) = NaN``) rather
    than only the difference."""
    big = jnp.asarray(1e15, on.dtype)
    return jnp.clip(jnp.nan_to_num(on, nan=-big), -big, big)


def stream_front(cfg: DetectionConfig, samples: jnp.ndarray, fs: float):
    """Vectorized front half (Welch PSD + three band sums for every block
    at once, `processor.py:206,349-393`) — the sample-rate part of the
    streaming pipeline, batched over any leading dims.

    Returns (over_noise, psd_db_mean, front_diags) with per-block series of
    shape ``samples.shape[:-1] + (n_blocks,)``.

    Accepts audio either flat (``(..., S)``) or **pre-blocked**
    (``(..., n_blocks, block)``, ndim ≥ 3) — see :func:`_blocked`.
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)

    psd = welch_psd(x, fs, cfg.n_fft, nperseg=cfg.welch_nperseg)
    psd_db = 10.0 * jnp.log10(psd)
    freqs = welch_freqs(fs, cfg.n_fft)

    ms_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.signal_band))
    n1_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_1))
    n2_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_2))
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = jnp.mean(psd_db, axis=-1)
    diags = {
        "ms_db": ms_db,
        "noise1_db": n1_db,
        "noise2_db": n2_db,
        "psd_db": psd_db,
        "freqs": freqs,
    }
    return over_noise, psd_db_mean, diags


@functools.lru_cache(maxsize=8)
def _headless_projection(fs: float, nfft: int, nperseg: int, bands, block: int):
    # whole-block eigen-compressed quadratic form (prolate rank ~2·B·T_block
    # per band, see block_band_matrix): folding framing + segment mean into
    # one (block, ~170) factor makes the front a single contiguous GEMM and
    # moves band sums by ≲1e-9 dB — three orders below the f32 rounding the
    # bins front already carries.
    return block_band_matrix(fs, nfft, nperseg, block, bands)


def stream_front_headless(cfg: DetectionConfig, samples: jnp.ndarray, fs: float):
    """Bins-only front half: the three Welch band levels via one matmul
    on the raw blocks (:func:`block_band_matrix` — framing, window, DFT
    selection, and segment mean all folded into one eigen-compressed
    per-block factor) instead of zero-padded nfft-point PSDs whose other
    ~2000 bins detection never reads.

    Accepts audio flat (``(..., S)``) or pre-blocked (``(..., n_blocks,
    block)``, ndim ≥ 3, see :func:`_blocked`).

    Event decisions depend only on ``over_noise``; ``psd_db_mean`` feeds
    nothing but the visualization auto-gain (`processor.py:448-454`), so
    headless mode returns zeros for it and carries no PSD waterfall.  Band
    numerics equal the Welch path to f32 reduction-order noise — measured
    delta and the event-list comparison live in
    ``tests/test_streaming_headless.py``; because a tie at the threshold
    could in principle flip a block, headless stays opt-in
    (``stream_process(..., front="bins")`` / ``apps/live.py --headless``).
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)
    nperseg = min(cfg.welch_nperseg, block)
    P, slices, nseg = _headless_projection(
        fs, cfg.n_fft, nperseg,
        (cfg.signal_band, cfg.noise_band_1, cfg.noise_band_2),
        block,
    )
    ms_db, n1_db, n2_db = (
        _sanitize_levels(v)
        for v in block_band_sums_db(x, jnp.asarray(P), slices, nseg)
    )
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = jnp.zeros_like(over_noise)
    diags = {"ms_db": ms_db, "noise1_db": n1_db, "noise2_db": n2_db}
    return over_noise, psd_db_mean, diags


def _init_prefix(scfg: StreamConfig, state: StreamState, psd_db_mean, t_vec, idx, n_blocks, dtype):
    """Closed-form INIT prefix shared by the episode-jump solvers
    (processor.py:444-457): accumulate the PSD mean until
    ``block_start_sec >= init_wait_sec``, then hand off to Detection.
    Returns (k0, s0, isum, icnt, pinit, init_sel)."""
    is_init = state.state == INIT
    t_ge = t_vec >= scfg.init_wait_sec
    any_switch = t_ge.any()
    k_switch = jnp.argmax(t_ge).astype(jnp.int32)
    init_hi = jnp.where(any_switch, k_switch, n_blocks - 1)  # inclusive
    init_sel = is_init & (idx <= init_hi)
    icnt = state.init_count + init_sel.sum(dtype=jnp.int32)
    isum = state.init_sum + jnp.where(init_sel, psd_db_mean, 0).sum()
    pinit = jnp.where(
        is_init & any_switch,
        isum / jnp.maximum(icnt, 1).astype(dtype),
        state.psd_db_mean_from_init,
    )
    k0 = jnp.where(
        is_init, jnp.where(any_switch, k_switch + 1, n_blocks), 0
    ).astype(jnp.int32)
    s0 = jnp.where(
        is_init, jnp.where(any_switch, DETECT, INIT), state.state
    ).astype(jnp.int32)
    return k0, s0, isum, icnt, pinit, init_sel


def stream_scan_jump(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: jnp.ndarray,  # (n_blocks,)
    psd_db_mean: jnp.ndarray,  # (n_blocks,)
) -> Tuple[StreamState, StreamEvents, jnp.ndarray]:
    """Episode-jump formulation of :func:`stream_scan`: O(episodes)
    sequential steps instead of O(blocks).

    Why it is possible: the 3-state machine's *transitions* depend only on
    comparisons of ``over_noise`` against (a) the precomputable rolling
    base thresholds and (b) locked values, which are themselves copies of
    base thresholds chained through lock windows — the tracking statistics
    never feed back into a transition.  So a `lax.while_loop` can jump from
    decision point to decision point: in Detection, the next threshold
    crossing is one vectorized masked-argmax; in Tracking, the next
    below-lock block is another; the tracked span's dB statistics are
    masked reductions over that span.  A quiet hour (~18000 blocks, a few
    dozen crossings) costs dozens of O(n) vector passes instead of 18000
    sequential scalar steps.

    Parity contract vs :func:`stream_scan` (pinned in
    ``tests/test_streaming_jump.py``):

    * event boundary times, thresholds, state transitions, lock windows,
      and duration acceptance: **bit-exact** (same comparisons on the same
      values — lock windows and duration acceptance are integer block
      arithmetic precisely so no float expression sits on a decision path,
      see the module docstring);
    * event/tracking dB statistics (mean/std/min/max, init PSD mean) and
      the *reported* float duration: equal up to f32 reduction-order/FMA
      noise (masked vector sums vs sequential adds; ``i·bs − t0`` may be
      FMA-contracted in one graph and not the other).  An event whose dB
      mean sits exactly at ``detection_db_over_noise_mean_min`` could in
      principle flip its accept decision — the same caveat class as the
      bins front half, which is why this stays opt-in
      (``stream_process(..., impl="jump")``).

    Worst case (a series alternating around the threshold every block) is
    O(n) episodes of O(n) work; for σ·4 thresholds on real signals the
    episode count is the event count plus rejected crossings.
    """
    n_blocks = over_noise.shape[0]
    dtype = over_noise.dtype
    w = scfg.avg_win
    cap = scfg.cap
    bs = jnp.asarray(scfg.block_sec, dtype)
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)
    base_thr, ext = _ring_base_thresholds(
        state.ring, state.block_idx, over_noise, w, scfg.k_std, dtype
    )
    on = over_noise.astype(dtype)
    idx = jnp.arange(n_blocks, dtype=jnp.int32)
    iabs = state.block_idx + idx  # absolute block indices
    # absolute block times, same arithmetic as the scan (i.astype * bs)
    t_vec = iabs.astype(dtype) * bs
    inf = jnp.asarray(jnp.inf, dtype)

    # ---- INIT prefix, closed form (processor.py:444-457) ----
    k0, s0, isum, icnt, pinit, init_sel = _init_prefix(
        scfg, state, psd_db_mean, t_vec, idx, n_blocks, dtype
    )
    thr0 = jnp.where(init_sel, base_thr, jnp.zeros(n_blocks, dtype))

    ev0 = _empty_events(cap, dtype)
    carry0 = (
        k0, s0, state.locked_threshold, state.locked_until_block,
        state.track_start_sec, state.track_start_block,
        state.tr_count, state.tr_sum, state.tr_sumsq,
        state.tr_min, state.tr_max,
        ev0.time_start, ev0.time_stop, ev0.duration, ev0.db_min, ev0.db_max,
        ev0.db_mean, ev0.db_std, ev0.count, ev0.overflow,
        thr0,
    )

    def detect_phase(c):
        (k, s, L, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
         e_ts, e_tp, e_du, e_mn, e_mx, e_me, e_sd, e_cnt, e_ovf, thr_out) = c
        locked = iabs <= luntil
        thr_vec = jnp.where(locked, L, base_thr)
        cand = (idx >= k) & (on > thr_vec)
        has = cand.any()
        i_star = jnp.argmax(cand).astype(jnp.int32)
        fill_hi = jnp.where(has, i_star, n_blocks - 1)  # inclusive
        sel = (idx >= k) & (idx <= fill_hi)
        thr_out = jnp.where(sel, thr_vec, thr_out)
        return (
            jnp.where(has, i_star + 1, n_blocks).astype(jnp.int32),
            jnp.where(has, TRACK, DETECT).astype(jnp.int32),
            jnp.where(has, thr_vec[i_star], L),
            luntil,
            jnp.where(has, t_vec[i_star], tstart),
            jnp.where(has, iabs[i_star], tsblk).astype(jnp.int32),
            jnp.where(has, 0, trc),
            jnp.where(has, 0.0, trs),
            jnp.where(has, 0.0, trss),
            jnp.where(has, inf, trmn),
            jnp.where(has, -inf, trmx),
            e_ts, e_tp, e_du, e_mn, e_mx, e_me, e_sd, e_cnt, e_ovf,
            thr_out,
        )

    def track_phase(c):
        (k, s, L, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
         e_ts, e_tp, e_du, e_mn, e_mx, e_me, e_sd, e_cnt, e_ovf, thr_out) = c
        cand = (idx >= k) & (on < L)
        has = cand.any()
        j = jnp.argmax(cand).astype(jnp.int32)
        span_hi = jnp.where(has, j, n_blocks - 1)  # inclusive tracked span
        sel = (idx >= k) & (idx <= span_hi)
        trc2 = trc + sel.sum(dtype=jnp.int32)
        trs2 = trs + jnp.where(sel, on, 0).sum()
        trss2 = trss + jnp.where(sel, on * on, 0).sum()
        trmn2 = jnp.minimum(trmn, jnp.where(sel, on, inf).min())
        trmx2 = jnp.maximum(trmx, jnp.where(sel, on, -inf).max())
        thr_out = jnp.where(sel, L, thr_out)

        t_leave = t_vec[j]
        dur = t_leave - tstart
        h_cnt = jnp.maximum(trc2, 1).astype(dtype)
        h_mean = trs2 / h_cnt
        h_std = jnp.sqrt(jnp.maximum(trss2 / h_cnt - h_mean * h_mean, 0))
        emit = has & (h_mean >= scfg.min_mean_db) & (iabs[j] - tsblk >= min_dur_b)
        slot = jnp.where(emit & (e_cnt < cap), e_cnt, cap)
        return (
            jnp.where(has, j + 1, n_blocks).astype(jnp.int32),
            jnp.where(has, DETECT, TRACK).astype(jnp.int32),
            L,
            jnp.where(has, iabs[j] + (lock_tail - 1), luntil).astype(jnp.int32),
            tstart,
            tsblk,
            trc2, trs2, trss2, trmn2, trmx2,
            e_ts.at[slot].set(tstart, mode="drop"),
            e_tp.at[slot].set(t_leave, mode="drop"),
            e_du.at[slot].set(dur, mode="drop"),
            e_mn.at[slot].set(trmn2, mode="drop"),
            e_mx.at[slot].set(trmx2, mode="drop"),
            e_me.at[slot].set(h_mean, mode="drop"),
            e_sd.at[slot].set(h_std, mode="drop"),
            e_cnt + emit.astype(jnp.int32),
            e_ovf | (emit & (e_cnt >= cap)),
            thr_out,
        )

    carry = jax.lax.while_loop(
        lambda c: c[0] < n_blocks,
        lambda c: jax.lax.cond(c[1] == DETECT, detect_phase, track_phase, c),
        carry0,
    )
    (k, s, L, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     e_ts, e_tp, e_du, e_mn, e_mx, e_me, e_sd, e_cnt, e_ovf, thr_out) = carry

    events = StreamEvents(
        time_start=e_ts, time_stop=e_tp, duration=e_du,
        db_min=e_mn, db_max=e_mx, db_mean=e_me, db_std=e_sd,
        count=e_cnt, overflow=e_ovf,
    )

    i_end = state.block_idx + n_blocks
    ring = _final_ring(ext, state.block_idx, i_end, w, state.ring.dtype)

    new_state = StreamState(
        state=s,
        block_idx=i_end,
        ring=ring,
        locked_threshold=L,
        locked_until_block=luntil,
        track_start_sec=tstart,
        track_start_block=tsblk,
        tr_count=trc, tr_sum=trs, tr_sumsq=trss, tr_min=trmn, tr_max=trmx,
        init_sum=isum, init_count=icnt, psd_db_mean_from_init=pinit,
    )
    return new_state, events, thr_out


def stream_scan_jump_batch(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: jnp.ndarray,  # (n_blocks,)
    psd_db_mean: jnp.ndarray,  # (n_blocks,)
    track_hop: int = 128,
    with_diag: bool = False,
):
    """Episode-jump solver built for wide vmapped batches (VERDICT r2 §2).

    :func:`stream_scan_jump`'s loop body costs O(n_blocks) per iteration
    (full-series masked argmaxes and threshold fills), so under ``vmap``
    every lockstep iteration pays O(n_blocks · n_channels) while waiting
    for the worst channel.  This formulation makes each decision O(1) or
    O(window):

    * **Detection, unlocked** — the next crossing of the *base* threshold
      is position-independent, so ``nxt_base[i]`` (first j ≥ i with
      ``on[j] > base_thr[j]``) is precomputed once with a reverse cummin:
      the in-loop search is a single gather.
    * **Detection, inside a lock window** — the lock window is at most
      ``lock_tail`` blocks (the window opened by the last track-leave), so
      the crossing test against the locked value is one fixed-width
      ``dynamic_slice`` + masked argmax.
    * **Tracking** — hop ``track_hop`` blocks at a time: one fixed-width
      window per hop finds the first ``on < locked`` block and accumulates
      the span statistics with masked sums.  Typical meteor events fit one
      hop; a series tracked end-to-end degrades to n/track_hop iterations,
      still far below the scan's n.
    * **Thresholds output** — reconstructed *after* the loop from the
      recorded lock episodes (entry block, lock-window end, locked value):
      per block, the most recent episode whose lock window covers it wins,
      else the base threshold.  Bit-exact vs the scan because every
      reconstructed value is a copy of the same base-threshold array or of
      a locked value chained through the identical comparisons.

    Parity contract vs :func:`stream_scan` (pinned in
    ``tests/test_streaming_hop.py``): event boundaries, thresholds, state
    transitions, lock windows, duration acceptance — bit-exact; dB
    statistics and reported float durations to f32 reduction order
    (per-hop masked sums vs sequential adds), the same caveat class as
    :func:`stream_scan_jump`.  Threshold reconstruction degrades (only the
    diagnostic series, never events) beyond ``4·cap + 8`` lock episodes
    per chunk; that condition is detectable at runtime — pass
    ``with_diag=True`` to get a fourth return value ``{"thr_degraded":
    bool}`` mirroring the event buffers' ``count``/``overflow`` contract
    (True iff a lock-episode record was dropped, i.e. the returned
    threshold series may substitute base thresholds inside dropped lock
    windows).

    Reference semantics anchor: `dsp/src/live/backend/processor.py:444-510`.

    Implementation notes for the vmapped-batch regime: a vmapped
    ``while_loop`` pays per lockstep iteration *in structure alone*
    (batched cond + carry plumbing), and ``jnp.searchsorted`` lowers to a
    binary-search loop — so the body is merged (one shared W-wide window
    slice, branchless selects instead of ``lax.cond``, which executes both
    branches under vmap anyway), the event/episode buffers are packed into
    single arrays (17 carry leaves and 3 scatters per iteration instead of
    24 and 12), and the threshold reconstruction's rank query is one
    scatter-add + cumsum (bit-identical integers to the searchsorted it
    replaces).
    """
    n_blocks = over_noise.shape[0]
    dtype = over_noise.dtype
    w = scfg.avg_win
    cap = scfg.cap
    ep_cap = 4 * cap + 8
    bs = jnp.asarray(scfg.block_sec, dtype)
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)
    w_lock = max(lock_tail, 1)
    w_track = track_hop
    W = max(w_lock, w_track)
    base_thr, ext = _ring_base_thresholds(
        state.ring, state.block_idx, over_noise, w, scfg.k_std, dtype
    )
    on = over_noise.astype(dtype)
    idx = jnp.arange(n_blocks, dtype=jnp.int32)
    i0 = state.block_idx
    t_vec = (i0 + idx).astype(dtype) * bs
    inf = jnp.asarray(jnp.inf, dtype)
    big = jnp.asarray(2**30, jnp.int32)

    # Precompute: first base-threshold crossing at or after each block.
    cross = on > base_thr  # NaN base_thr (cnt==0 head) compares False
    nxt_base = jax.lax.cummin(
        jnp.where(cross, idx, n_blocks), axis=0, reverse=True
    )
    nxt_ext = jnp.concatenate([nxt_base, jnp.full((1,), n_blocks, jnp.int32)])
    on_pad = jnp.concatenate([on, jnp.zeros(W, dtype)])

    k0, s0, isum, icnt, pinit, _ = _init_prefix(
        scfg, state, psd_db_mean, t_vec, idx, n_blocks, dtype
    )

    lane = jnp.arange(W, dtype=jnp.int32)
    lock_lane = lane < w_lock
    track_lane = lane < w_track

    # packed buffers: e_buf rows = (time_start, time_stop, duration, db_min,
    # db_max, db_mean, db_std); ep_i rows = (entry_rel_block, thr_end_rel);
    # ep_lv = locked values.  Slot 0 of the episode records carries the
    # incoming lock window (shadowed by any carried-in track's own record).
    e_buf0 = jnp.zeros((7, cap), dtype)
    ep_i0 = jnp.stack([
        jnp.full(ep_cap, big).at[0].set(-big),
        jnp.full(ep_cap, -big).at[0].set(state.locked_until_block - i0),
    ])
    ep_lv0 = jnp.zeros(ep_cap, dtype).at[0].set(state.locked_threshold)

    carry0 = (
        k0, s0, state.locked_threshold, state.locked_until_block,
        state.track_start_sec, state.track_start_block,
        state.tr_count, state.tr_sum, state.tr_sumsq,
        state.tr_min, state.tr_max,
        e_buf0, jnp.asarray(0, jnp.int32), jnp.asarray(False),
        ep_i0, ep_lv0, jnp.asarray(1, jnp.int32), jnp.asarray(False),
    )

    def body(c):
        (k, s, L, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
         e_buf, e_cnt, e_ovf, ep_i, ep_lv, ep_cnt, ep_ovf) = c
        is_det = s == DETECT
        wv = jax.lax.dynamic_slice(on_pad, (k,), (W,))
        widx = k + lane
        valid = widx < n_blocks

        # -- detection: crossing against the locked value inside the
        #    (bounded) lock window, else the precomputed next base crossing
        #    after the lock expires
        rel_until = luntil - i0
        lock_cand = lock_lane & (widx <= rel_until) & valid & (wv > L)
        lock_has = lock_cand.any()
        j_lock = k + jnp.argmax(lock_cand).astype(jnp.int32)
        start_base = jnp.maximum(k, rel_until + 1)
        j_base = nxt_ext[jnp.minimum(start_base, n_blocks)]
        i_star = jnp.where(lock_has, j_lock, j_base)
        d_has = i_star < n_blocks
        i_c = jnp.minimum(i_star, n_blocks - 1)
        thr_at = jnp.where(lock_has, L, base_thr[i_c])

        # -- tracking: first below-lock block within the hop window; span
        #    statistics as masked reductions (zero/±inf padding beyond
        #    w_track lanes is exact: appended identities never change a
        #    partial sum)
        leave_cand = track_lane & valid & (wv < L)
        t_has = leave_cand.any()
        j = k + jnp.argmax(leave_cand).astype(jnp.int32)
        span_hi = jnp.where(t_has, j, k + w_track - 1)  # inclusive
        sel = track_lane & valid & (widx <= span_hi)
        trc2 = trc + sel.sum(dtype=jnp.int32)
        trs2 = trs + jnp.where(sel, wv, 0).sum()
        trss2 = trss + jnp.where(sel, wv * wv, 0).sum()
        trmn2 = jnp.minimum(trmn, jnp.where(sel, wv, inf).min())
        trmx2 = jnp.maximum(trmx, jnp.where(sel, wv, -inf).max())

        j_c = jnp.minimum(j, n_blocks - 1)
        t_leave = t_vec[j_c]
        dur = t_leave - tstart
        h_cnt = jnp.maximum(trc2, 1).astype(dtype)
        h_mean = trs2 / h_cnt
        h_std = jnp.sqrt(jnp.maximum(trss2 / h_cnt - h_mean * h_mean, 0))
        emit = (~is_det) & t_has & (h_mean >= scfg.min_mean_db) & (
            (i0 + j) - tsblk >= min_dur_b
        )
        rec = (~is_det) & t_has
        slot = jnp.where(emit & (e_cnt < cap), e_cnt, cap)
        eslot = jnp.where(rec & (ep_cnt < ep_cap), ep_cnt, ep_cap)
        e_buf2 = e_buf.at[:, slot].set(
            jnp.stack([tstart, t_leave, dur, trmn2, trmx2, h_mean, h_std]),
            mode="drop",
        )
        ep_i2 = ep_i.at[:, eslot].set(
            jnp.stack([tsblk - i0, j + max(lock_tail - 1, 0)]), mode="drop"
        )
        ep_lv2 = ep_lv.at[eslot].set(L, mode="drop")

        enter = is_det & d_has
        leave = (~is_det) & t_has
        k_next = jnp.where(
            is_det,
            jnp.where(d_has, i_star + 1, n_blocks),
            jnp.where(t_has, j + 1, jnp.minimum(k + w_track, n_blocks)),
        ).astype(jnp.int32)
        s_next = jnp.where(
            is_det,
            jnp.where(d_has, TRACK, DETECT),
            jnp.where(t_has, DETECT, TRACK),
        ).astype(jnp.int32)
        return (
            k_next,
            s_next,
            jnp.where(enter, thr_at, L),
            jnp.where(leave, (i0 + j) + (lock_tail - 1), luntil).astype(jnp.int32),
            jnp.where(enter, t_vec[i_c], tstart),
            jnp.where(enter, i0 + i_star, tsblk).astype(jnp.int32),
            jnp.where(enter, 0, jnp.where(is_det, trc, trc2)),
            jnp.where(enter, 0.0, jnp.where(is_det, trs, trs2)),
            jnp.where(enter, 0.0, jnp.where(is_det, trss, trss2)),
            jnp.where(enter, inf, jnp.where(is_det, trmn, trmn2)),
            jnp.where(enter, -inf, jnp.where(is_det, trmx, trmx2)),
            e_buf2,
            e_cnt + emit.astype(jnp.int32),
            e_ovf | (emit & (e_cnt >= cap)),
            ep_i2,
            ep_lv2,
            ep_cnt + rec.astype(jnp.int32),
            ep_ovf | (rec & (ep_cnt >= ep_cap)),
        )

    carry = jax.lax.while_loop(lambda c: c[0] < n_blocks, body, carry0)
    (k, s, L, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     e_buf, e_cnt, e_ovf, ep_i, ep_lv, ep_cnt, ep_ovf) = carry

    # a chunk that ends mid-track keeps its locked value live to the end
    end_track = s == TRACK
    ep_ovf = ep_ovf | (end_track & (ep_cnt >= ep_cap))
    eslot = jnp.where(end_track & (ep_cnt < ep_cap), ep_cnt, ep_cap)
    ep_i = ep_i.at[:, eslot].set(
        jnp.stack([tsblk - i0, jnp.asarray(n_blocks - 1, jnp.int32)]),
        mode="drop",
    )
    ep_lv = ep_lv.at[eslot].set(L, mode="drop")
    ep_en = ep_i[0]
    ep_te = ep_i[1]

    # threshold reconstruction: most recent lock episode covering each
    # block.  eidx[i] = searchsorted_left(ep_en, i) − 1 = (# entries < i)
    # − 1, computed as one scatter-add + cumsum (entries clip to the
    # [0, n_blocks] histogram range; −big → bin 0 counts for every block,
    # big → bin n_blocks counts for none) — integer-identical to
    # searchsorted, without a binary-search loop.
    p = jnp.clip(ep_en + 1, 0, n_blocks)
    cnt_hist = jnp.zeros(n_blocks + 1, jnp.int32).at[p].add(1)
    eidx = jnp.cumsum(cnt_hist)[:n_blocks] - 1
    eidx = jnp.maximum(eidx, 0)  # slot 0 (entry −big) precedes every block
    covered = idx <= ep_te[eidx]
    thr_out = jnp.where(covered, ep_lv[eidx], base_thr)

    events = StreamEvents(
        time_start=e_buf[0], time_stop=e_buf[1], duration=e_buf[2],
        db_min=e_buf[3], db_max=e_buf[4], db_mean=e_buf[5], db_std=e_buf[6],
        count=e_cnt, overflow=e_ovf,
    )

    i_end = i0 + n_blocks
    ring = _final_ring(ext, i0, i_end, w, state.ring.dtype)

    new_state = StreamState(
        state=s,
        block_idx=i_end,
        ring=ring,
        locked_threshold=L,
        locked_until_block=luntil,
        track_start_sec=tstart,
        track_start_block=tsblk,
        tr_count=trc, tr_sum=trs, tr_sumsq=trss, tr_min=trmn, tr_max=trmx,
        init_sum=isum, init_count=icnt, psd_db_mean_from_init=pinit,
    )
    if with_diag:
        return new_state, events, thr_out, {"thr_degraded": ep_ovf}
    return new_state, events, thr_out


def resolve_stream_auto(front: str, impl: str) -> Tuple[str, str]:
    """Resolve ``front``/``impl`` ``"auto"`` selections to the platform's
    defaults (:mod:`meteor_scatter_tpu.platform`): the reference welch
    front and scan on the CPU, where the oracles pin them bit-exactly; the
    fastest pair measured on the GPU whose event lists equal the scan's
    (PERF.md).

    The decision-flip risk of the fast formulations is bounded in
    PARITY.md (accept margins sit orders of magnitude above the
    formulation deltas; boundary comparisons and lock windows are
    shared/integer-exact).

    Callers that need the PSD waterfall (live UI, spec export) must pass
    ``front="welch"`` explicitly — the bins front computes only the three
    band levels.
    """
    if front == "auto":
        front = platform.stream_front()
    if impl == "auto":
        impl = platform.stream_solver()
    return front, impl


def stream_process(
    cfg: DetectionConfig,
    state: StreamState,
    samples: jnp.ndarray,
    fs: float,
    front: str = "auto",
    impl: str = "auto",
) -> Tuple[StreamState, StreamEvents, dict]:
    """Process a chunk of audio (any whole number of blocks).

    Vectorized front half (:func:`stream_front`), then the sequential state
    machine as one scan (:func:`stream_scan`).  Returns (new_state,
    events_found_in_chunk, diagnostics) where diagnostics carries the
    per-block series the live UI plots (over_noise, threshold, band dBs,
    psd waterfall — Welch front only).

    The scan is restructured for the accelerator relative to :func:`stream_step` (which
    stays as the reference formulation): the O(avg_win) rolling-window
    reduction is hoisted out as a batched gather+sum with the identical
    summation order, and event emission becomes per-step *outputs*
    compacted afterwards, so the carry is pure scalars.  Equality with the
    stream_step scan is pinned in tests.

    ``front``/``impl`` default to ``"auto"`` (:func:`resolve_stream_auto`):
    the platform's defaults (`meteor_scatter_tpu/platform.py`) — the
    reference-formulation welch:scan on the CPU.  ``impl="jump"``/``"hop"``
    select the episode-jump solvers explicitly — bit-exact event
    boundaries and thresholds, dB statistics to f32 reduction order; see
    their docstrings and PARITY.md for the tie-risk accounting
    (``fused`` is bit-exact vs the scan outright).
    """
    front, impl = resolve_stream_auto(front, impl)
    scfg = StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * fs))
    n_blocks = samples.shape[-1] // block
    if n_blocks == 0:
        # keep the diagnostics contract: length-0 per-block series with the
        # SAME key schema the resolved front/impl produces on non-empty
        # chunks (bins carries no psd waterfall; hop adds thr_degraded) —
        # per-chunk diag accumulation must never see a schema change at an
        # empty chunk
        dtype = jnp.float32
        z = jnp.zeros(0, dtype)
        diags = {
            "over_noise": z,
            "threshold": z,
            "ms_db": z,
            "noise1_db": z,
            "noise2_db": z,
        }
        if front == "welch":
            freqs = welch_freqs(fs, cfg.n_fft)
            diags["psd_db"] = jnp.zeros((0, len(freqs)), dtype)
            diags["freqs"] = freqs
        if impl == "hop":
            diags["thr_degraded"] = jnp.zeros((), bool)
        return state, _empty_events(scfg.cap, dtype), diags

    if front == "bins":
        over_noise, psd_db_mean, front_diags = stream_front_headless(cfg, samples, fs)
    elif front == "welch":
        over_noise, psd_db_mean, front_diags = stream_front(cfg, samples, fs)
    else:
        raise ValueError(f"unknown front {front!r} (use 'welch' or 'bins')")
    extra_diags = {}
    if impl == "scan":
        state, events, thresholds = stream_scan(scfg, state, over_noise, psd_db_mean)
    elif impl == "jump":
        state, events, thresholds = stream_scan_jump(scfg, state, over_noise, psd_db_mean)
    elif impl == "hop":
        state, events, thresholds, extra_diags = stream_scan_jump_batch(
            scfg, state, over_noise, psd_db_mean, with_diag=True
        )
    elif impl == "fused":
        state, events, thresholds = stream_scan_fused(scfg, state, over_noise, psd_db_mean)
    else:
        raise ValueError(
            f"unknown impl {impl!r} (use 'scan', 'jump', 'hop' or 'fused')"
        )
    diags = {
        "over_noise": over_noise, "threshold": thresholds,
        **extra_diags, **front_diags,
    }
    return state, events, diags


def _final_ring(ext: jnp.ndarray, i0, i_end, w: int, dtype) -> jnp.ndarray:
    """Reconstruct the carry ring after a chunk: slot s holds the value at
    the largest written block k with k ≡ s (mod w) — one gather over the
    extended series ``ext`` (the chunk's over_noise prefixed by the
    incoming ring, so index 0 is absolute block ``i0 - w``).  All four
    streaming solvers share this helper: the slot arithmetic is subtle and
    must stay identical for the chunked==unchunked carry contract."""
    s = jnp.arange(w)
    k_last = i_end - w + jnp.mod(s - i_end, w)
    return ext[k_last - (i0 - w)].astype(dtype)


def stream_scan(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: jnp.ndarray,  # (n_blocks,)
    psd_db_mean: jnp.ndarray,  # (n_blocks,)
    unroll: int | None = None,
) -> Tuple[StreamState, StreamEvents, jnp.ndarray]:
    """The sequential 3-state machine over one block series — the
    block-rate back half of :func:`stream_process` (reference semantics:
    `processor.py:444-510`; restructuring notes there).  Returns
    (new_state, events, per-block thresholds).  ``unroll`` overrides the
    backend-default scan unroll factor (semantics unchanged)."""
    n_blocks = over_noise.shape[0]
    dtype = over_noise.dtype
    w = scfg.avg_win
    bs = jnp.asarray(scfg.block_sec, dtype)
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)
    base_thr, ext = _ring_base_thresholds(
        state.ring, state.block_idx, over_noise, w, scfg.k_std, dtype
    )

    def body(carry, inp):
        (st_state, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
         isum, icnt, pinit, i) = carry
        on, pm, bt = inp
        t_start = i.astype(dtype) * bs

        thr = jnp.where(
            st_state == TRACK,
            locked,
            jnp.where((st_state == DETECT) & (i <= luntil), locked, bt),
        )

        new_isum = isum + pm
        new_icnt = icnt + 1
        init_done = t_start >= scfg.init_wait_sec
        pinit_new = new_isum / jnp.maximum(new_icnt, 1).astype(dtype)

        enter_track = on > thr
        n_trc = trc + 1
        n_trs = trs + on
        n_trss = trss + on * on
        n_trmn = jnp.minimum(trmn, on)
        n_trmx = jnp.maximum(trmx, on)
        leave_track = on < thr

        dur = t_start - tstart
        h_cnt = jnp.maximum(n_trc, 1).astype(dtype)
        h_mean = n_trs / h_cnt
        h_std = jnp.sqrt(jnp.maximum(n_trss / h_cnt - h_mean * h_mean, 0))
        accept = (h_mean >= scfg.min_mean_db) & (i - tsblk >= min_dur_b)

        is_init = st_state == INIT
        is_detect = st_state == DETECT
        is_track = st_state == TRACK
        emit = is_track & leave_track & accept

        next_state = jnp.where(
            is_init,
            jnp.where(init_done, DETECT, INIT),
            jnp.where(
                is_detect,
                jnp.where(enter_track, TRACK, DETECT),
                jnp.where(leave_track, DETECT, TRACK),
            ),
        ).astype(jnp.int32)

        start_track = is_detect & enter_track
        new_carry = (
            next_state,
            jnp.where(start_track, thr, locked),
            jnp.where(is_track & leave_track, i + (lock_tail - 1), luntil).astype(jnp.int32),
            jnp.where(start_track, t_start, tstart),
            jnp.where(start_track, i, tsblk).astype(jnp.int32),
            jnp.where(start_track, 0, jnp.where(is_track, n_trc, trc)),
            jnp.where(start_track, 0.0, jnp.where(is_track, n_trs, trs)),
            jnp.where(start_track, 0.0, jnp.where(is_track, n_trss, trss)),
            jnp.where(start_track, jnp.inf, jnp.where(is_track, n_trmn, trmn)),
            jnp.where(start_track, -jnp.inf, jnp.where(is_track, n_trmx, trmx)),
            jnp.where(is_init, new_isum, isum),
            jnp.where(is_init, new_icnt, icnt),
            jnp.where(is_init & init_done, pinit_new, pinit),
            i + 1,
        )
        out = (thr, emit, tstart, t_start, dur, n_trmn, n_trmx, h_mean, h_std)
        return new_carry, out

    carry0 = (
        state.state, state.locked_threshold, state.locked_until_block,
        state.track_start_sec, state.track_start_block,
        state.tr_count, state.tr_sum, state.tr_sumsq,
        state.tr_min, state.tr_max, state.init_sum, state.init_count,
        state.psd_db_mean_from_init, state.block_idx,
    )
    # the unroll factor is a per-platform measurement (platform.py);
    # semantics are unchanged by it
    if unroll is None:
        unroll = platform.scan_unroll()
    carry, outs = jax.lax.scan(
        body, carry0, (over_noise, psd_db_mean, base_thr), unroll=unroll
    )
    (thresholds, emit, e_start, e_stop, e_dur, e_min, e_max, e_mean, e_std) = outs

    # compact emitted events into the fixed-cap buffer (order preserved);
    # scatter-free matmul compaction shared with the fused kernel path — see
    # :func:`_compact_scan_outs` for why scatter/searchsorted are avoided
    events = _compact_scan_outs(
        scfg, n_blocks,
        (emit, e_start, e_stop, e_dur, e_min, e_max, e_mean, e_std),
    )

    i_end = state.block_idx + n_blocks
    ring = _final_ring(ext, state.block_idx, i_end, w, state.ring.dtype)

    (st_state, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     isum, icnt, pinit, i_final) = carry
    state = StreamState(
        state=st_state,
        block_idx=i_final,
        ring=ring,
        locked_threshold=locked,
        locked_until_block=luntil,
        track_start_sec=tstart,
        track_start_block=tsblk,
        tr_count=trc,
        tr_sum=trs,
        tr_sumsq=trss,
        tr_min=trmn,
        tr_max=trmx,
        init_sum=isum,
        init_count=icnt,
        psd_db_mean_from_init=pinit,
    )

    return state, events, thresholds

def _compact_scan_outs(scfg: StreamConfig, n_blocks: int, outs) -> StreamEvents:
    """Turn one channel's per-step scan outputs into the fixed-cap event
    buffer: the m-th emitting block lands in slot m.

    The slot→block map is recovered *scatter-free* (a large scatter was a
    serialized loop on the previous accelerator; ROADMAP C5 asks whether a
    cumsum-plus-scatter is as fast on the GPU): the slot index m = c[i]−1
    of each emitting block is split into digits (hi, lo) = (m // 32,
    m % 32) and ``slot_c[m] = Σ_i E_hi[i,hi] · E_lo[i,lo] · i`` becomes one
    (A, n)·(n, 32) matmul.  At
    most one term per slot is nonzero and block indices are < 2²⁴, so the
    f32 contraction is integer-exact and equal to the scatter it
    replaces."""
    (emit, e_start, e_stop, e_dur, e_min, e_max, e_mean, e_std) = outs
    cap = scfg.cap
    B = 32
    A = -(-cap // B)
    c = jnp.cumsum(emit.astype(jnp.int32))
    num = c[-1]
    em = emit.astype(bool)
    m = c - 1  # slot index of each emitting block
    f32 = e_start.dtype
    e_hi = (
        jnp.where(em, m // B, -1)[:, None] == jnp.arange(A, dtype=jnp.int32)[None, :]
    ).astype(f32)
    e_lo = (
        (m % B)[:, None] == jnp.arange(B, dtype=jnp.int32)[None, :]
    ).astype(f32)
    v = jnp.arange(n_blocks, dtype=f32)
    # HIGHEST: a bf16 pass would corrupt block indices above 256 (not
    # bf16-representable) and mis-map event slots
    slots = jnp.einsum(
        "na,nb->ab", e_hi, e_lo * v[:, None],
        precision=jax.lax.Precision.HIGHEST,
    )
    slot_c = slots.reshape(A * B)[:cap].astype(jnp.int32)
    valid = jnp.arange(cap) < num

    def pick(arr):
        return jnp.where(valid, arr[slot_c], 0)

    return StreamEvents(
        time_start=pick(e_start),
        time_stop=pick(e_stop),
        duration=pick(e_dur),
        db_min=pick(e_min),
        db_max=pick(e_max),
        db_mean=pick(e_mean),
        db_std=pick(e_std),
        count=num,
        overflow=num > cap,
    )


def stream_scan_fused_batch(
    scfg: StreamConfig,
    state: StreamState,        # batched: every leaf has leading dim (C,)
    over_noise: jnp.ndarray,   # (C, n_blocks)
    psd_db_mean: jnp.ndarray,  # (C, n_blocks)
    **kernel_kw,
) -> Tuple[StreamState, StreamEvents, jnp.ndarray]:
    """Batched fused-kernel form of :func:`stream_scan` — the wide-station
    solver (BASELINE config 5).  One Pallas kernel
    (`ops/pallas/stream_kernel.py`) walks the whole block series of every
    channel group in one launch, the groups in parallel.  ``kernel_kw``
    (``max_group``, ``tile``) passes launch shape through to
    :func:`~meteor_scatter_tpu.ops.pallas.stream_kernel.stream_machine_fused`.

    Contract: bit-exact vs ``vmap(stream_scan)`` in interpret mode — same
    base-threshold prologue, an op-for-op mirror of the scan body, and the
    identical compaction epilogue; pinned in
    ``tests/test_streaming_fused.py``.  (The *unbatched* ``stream_scan``
    additionally differs by FMA contraction of ``i·bs − t0`` in the
    reported ``duration`` and one ULP of ``tr_sumsq``/``db_std`` —
    decisions are integer/comparison-exact, same caveat class as
    :func:`stream_scan_jump`.)

    The kernel is compiled on the GPU and interpreted on the CPU
    (:func:`meteor_scatter_tpu.platform.interpret_kernels`).
    """
    from meteor_scatter_tpu.ops.pallas.stream_kernel import stream_machine_fused

    C, n_blocks = over_noise.shape
    dtype = over_noise.dtype
    w = scfg.avg_win
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)
    base_thr, ext = jax.vmap(
        lambda r, i, o: _ring_base_thresholds(r, i, o, w, scfg.k_std, dtype)
    )(state.ring, state.block_idx, over_noise)

    carry_f = jnp.stack([
        state.locked_threshold, state.track_start_sec,
        state.tr_sum, state.tr_sumsq, state.tr_min, state.tr_max,
        state.init_sum, state.psd_db_mean_from_init,
    ]).astype(jnp.float32)
    carry_i = jnp.stack([
        state.state, state.locked_until_block, state.track_start_block,
        state.tr_count, state.init_count, state.block_idx,
    ]).astype(jnp.int32)

    ys, cf1, ci1 = stream_machine_fused(
        over_noise.T.astype(jnp.float32),
        psd_db_mean.T.astype(jnp.float32),
        base_thr.T.astype(jnp.float32),
        carry_f,
        carry_i,
        block_sec=float(scfg.block_sec),
        init_wait_sec=float(scfg.init_wait_sec),
        min_mean_db=float(scfg.min_mean_db),
        min_dur_b=int(min_dur_b),
        lock_tail=int(lock_tail),
        interpret=platform.interpret_kernels(),
        **kernel_kw,
    )
    thresholds = ys[0].T  # (C, n_blocks)
    outs_c = tuple(y.T for y in ys[1:])
    events = jax.vmap(lambda *o: _compact_scan_outs(scfg, n_blocks, o))(*outs_c)

    i_end = state.block_idx + n_blocks
    ring = jax.vmap(
        lambda ext_row, i0, ie: _final_ring(ext_row, i0, ie, w, state.ring.dtype)
    )(ext, state.block_idx, i_end)

    new_state = StreamState(
        state=ci1[0], block_idx=i_end, ring=ring,
        locked_threshold=cf1[0], locked_until_block=ci1[1],
        track_start_sec=cf1[1], track_start_block=ci1[2],
        tr_count=ci1[3], tr_sum=cf1[2], tr_sumsq=cf1[3],
        tr_min=cf1[4], tr_max=cf1[5],
        init_sum=cf1[6], init_count=ci1[4],
        psd_db_mean_from_init=cf1[7],
    )
    return new_state, events, thresholds


def stream_scan_fused(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: jnp.ndarray,   # (n_blocks,)
    psd_db_mean: jnp.ndarray,  # (n_blocks,)
) -> Tuple[StreamState, StreamEvents, jnp.ndarray]:
    """Single-series fused-kernel form of :func:`stream_scan` (same
    (new_state, events, thresholds) contract) — a C=1 slice of
    :func:`stream_scan_fused_batch`; see there for the exactness
    contract."""
    state_b = jax.tree_util.tree_map(lambda a: a[None], state)
    st, ev, thr = stream_scan_fused_batch(
        scfg, state_b, over_noise[None], psd_db_mean[None]
    )
    return (
        jax.tree_util.tree_map(lambda a: a[0], st),
        jax.tree_util.tree_map(lambda a: a[0], ev),
        thr[0],
    )
