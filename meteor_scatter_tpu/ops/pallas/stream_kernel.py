"""Streaming 3-state machine as one Pallas kernel on the Triton route.

One program runs the reference's sequential live detector
(`dsp/src/live/backend/processor.py:444-510`) over a whole block series
for one group of channels.  The time loop is a ``fori_loop`` inside the
kernel with the 13-field machine state held in registers, so a chunk of n
blocks is one launch; ``lax.scan`` launches the step body's fused kernels
once per block.  The grid runs over channel groups, one program per group,
in parallel and in no order: nothing is carried between programs.

Layout: series arrays are time-major ``(n_pad, C_pad)``.  Each step loads
one ``(1, group)`` row each of over-noise, PSD mean and base threshold and
stores nine.  Triton wants power-of-two tensor sizes, so the group is a
power of two and channels are padded to whole groups.  Time is padded to
whole tiles of ``tile`` rows; one loop iteration walks one tile, unrolled
in Python, while the next tile's rows load.  The program is latency-bound:
one warp walks a chain of dependent steps, so the win over ``lax.scan`` is
the launches it saves, and many groups keep many SMs busy at once.
Padded channels compute values that never cross channels (the body has no
cross-channel operation) and are sliced off; padded steps keep the carry
through the ``active`` mask.

Exactness: the step body mirrors
:func:`meteor_scatter_tpu.models.streaming.stream_scan`'s scan body op for
op (same float32 operations in the same order, the same ``base_thr``
computed by the identical XLA prologue), so in interpret mode thresholds,
transitions and event statistics are bit-exact against the vmapped scan —
pinned in ``tests/test_streaming_fused.py``.  Compiled for the GPU, the
compiler may contract a multiply and an add into one FMA in the event
statistics; decisions are comparisons of the same values and integer block
arithmetic, so event boundaries stay identical (checked on the card by
``chip_smoke.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

INIT = 0
DETECT = 1
TRACK = 2

# rows of the (8, C) carry arrays
_F_LOCKED, _F_TSTART, _F_TRS, _F_TRSS, _F_TRMN, _F_TRMX, _F_ISUM, _F_PINIT = range(8)
_I_STATE, _I_LUNTIL, _I_TSBLK, _I_TRC, _I_ICNT, _I_I0 = range(6)
CARRY_ROWS = 8


def _step(on, pm, bt, i, active, c, *, block_sec, init_wait_sec, min_mean_db,
          min_dur_b, lock_tail):
    """One block of the machine on a (1, group) row — the scan body."""
    (st, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     isum, icnt, pinit) = c
    t_start = i.astype(jnp.float32) * jnp.float32(block_sec)

    thr = jnp.where(
        st == TRACK,
        locked,
        jnp.where((st == DETECT) & (i <= luntil), locked, bt),
    )

    new_isum = isum + pm
    new_icnt = icnt + 1
    init_done = t_start >= init_wait_sec
    pinit_new = new_isum / jnp.maximum(new_icnt, 1).astype(jnp.float32)

    enter_track = on > thr
    n_trc = trc + 1
    n_trs = trs + on
    n_trss = trss + on * on
    n_trmn = jnp.minimum(trmn, on)
    n_trmx = jnp.maximum(trmx, on)
    leave_track = on < thr

    dur = t_start - tstart
    h_cnt = jnp.maximum(n_trc, 1).astype(jnp.float32)
    h_mean = n_trs / h_cnt
    h_std = jnp.sqrt(jnp.maximum(n_trss / h_cnt - h_mean * h_mean, 0))
    accept = (h_mean >= min_mean_db) & (i - tsblk >= min_dur_b)

    is_init = st == INIT
    is_detect = st == DETECT
    is_track = st == TRACK
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

    out = (thr, emit.astype(jnp.int32), tstart, t_start, dur,
           n_trmn, n_trmx, h_mean, h_std)
    new_c = (
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
    )
    return tuple(jnp.where(active, n, o) for n, o in zip(new_c, c)), out


def _kernel(
    on_ref, pm_ref, bt_ref,            # (n_pad, group) f32
    cf0_ref, ci0_ref,                  # (8, group) f32 / i32 initial state
    thr_ref, emit_ref,                 # (n_pad, group) f32 / i32
    ts_ref, tp_ref, du_ref, mn_ref, mx_ref, me_ref, sd_ref,  # (n_pad, group) f32
    cf_ref, ci_ref,                    # (8, group) final state
    *,
    n_total: int,
    tile: int,
    **step_kw,
):
    def row(ref, r):
        return ref[pl.ds(r, 1), :]

    carry0 = (
        row(ci0_ref, _I_STATE), row(cf0_ref, _F_LOCKED),
        row(ci0_ref, _I_LUNTIL), row(cf0_ref, _F_TSTART),
        row(ci0_ref, _I_TSBLK), row(ci0_ref, _I_TRC),
        row(cf0_ref, _F_TRS), row(cf0_ref, _F_TRSS),
        row(cf0_ref, _F_TRMN), row(cf0_ref, _F_TRMX),
        row(cf0_ref, _F_ISUM), row(ci0_ref, _I_ICNT),
        row(cf0_ref, _F_PINIT),
    )
    i0 = row(ci0_ref, _I_I0)
    out_refs = (thr_ref, emit_ref, ts_ref, tp_ref, du_ref, mn_ref, mx_ref,
                me_ref, sd_ref)

    n_tiles = -(-n_total // tile)

    def load_tile(tb):
        s0 = tb * tile
        return tuple(
            (row(on_ref, s0 + r), row(pm_ref, s0 + r), row(bt_ref, s0 + r))
            for r in range(tile)
        )

    def run_tile(tb, c, rows):
        s0 = tb * tile
        for r, (on, pm, bt) in enumerate(rows):
            s = s0 + r
            c, out = _step(on, pm, bt, i0 + s, s < n_total, c, **step_kw)
            for ref, v in zip(out_refs, out):
                ref[pl.ds(s, 1), :] = v
        return c

    # the next tile's rows load before this tile's steps run, so their
    # latency hides behind a whole tile of dependent arithmetic
    def tile_body(tb, cr):
        c, rows = cr
        nxt = load_tile(jnp.minimum(tb + 1, n_tiles - 1))
        return run_tile(tb, c, rows), nxt

    carry, _ = jax.lax.fori_loop(0, n_tiles, tile_body, (carry0, load_tile(0)))
    (st, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     isum, icnt, pinit) = carry

    for r, v in ((_F_LOCKED, locked), (_F_TSTART, tstart), (_F_TRS, trs),
                 (_F_TRSS, trss), (_F_TRMN, trmn), (_F_TRMX, trmx),
                 (_F_ISUM, isum), (_F_PINIT, pinit)):
        cf_ref[pl.ds(r, 1), :] = v
    for r, v in ((_I_STATE, st), (_I_LUNTIL, luntil), (_I_TSBLK, tsblk),
                 (_I_TRC, trc), (_I_ICNT, icnt), (_I_I0, i0 + n_total)):
        ci_ref[pl.ds(r, 1), :] = v


def group_size(n_channels: int, max_group: int) -> int:
    """Channels per program: the smallest power of two that holds every
    channel, capped at ``max_group`` (itself a power of two)."""
    if max_group < 1 or max_group & (max_group - 1):
        raise ValueError(f"max_group must be a power of two, got {max_group}")
    g = 1
    while g < min(n_channels, max_group):
        g *= 2
    return g


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_sec", "init_wait_sec", "min_mean_db", "min_dur_b",
        "lock_tail", "max_group", "tile", "interpret",
    ),
)
def stream_machine_fused(
    on2: jnp.ndarray,   # (n, C) f32
    pm2: jnp.ndarray,   # (n, C) f32
    bt2: jnp.ndarray,   # (n, C) f32 — base thresholds from _ring_base_thresholds
    carry_f: jnp.ndarray,  # (8, C) f32 init state rows (see _F_* order)
    carry_i: jnp.ndarray,  # (6, C) i32 init state rows (see _I_* order)
    *,
    block_sec: float,
    init_wait_sec: float,
    min_mean_db: float,
    min_dur_b: int,
    lock_tail: int,
    max_group: int = 16,
    tile: int | None = None,
    interpret: bool = False,
):
    """Run the machine; returns ``(ys, carry_f', carry_i')`` with ys =
    (thr, emit, tstart, t_stop, dur, trmn, trmx, h_mean, h_std), each
    (n, C) — the exact per-step outputs of ``stream_scan``'s scan.

    The launch shape is the fastest measured on an H100 (PERF.md): groups
    of up to 16 channels, one warp per program, tiles of 8 rows; a single
    channel runs one row per loop iteration (``tile=None`` picks between
    the two).  ``max_group`` and ``tile`` override them; results do not
    depend on them."""
    n, C = on2.shape
    if tile is None:
        tile = 1 if C == 1 else 8
    group = group_size(C, max_group)
    c_pad = -(-C // group) * group
    n_pad = -(-n // tile) * tile

    def pad(x, rows):
        return jnp.pad(x, ((0, rows - x.shape[0]), (0, c_pad - C)))

    on_p, pm_p, bt_p = (pad(x, n_pad) for x in (on2, pm2, bt2))
    cf0 = pad(carry_f, CARRY_ROWS)
    ci0 = pad(carry_i, CARRY_ROWS)

    series = pl.BlockSpec((n_pad, group), lambda g: (0, g))
    state = pl.BlockSpec((CARRY_ROWS, group), lambda g: (0, g))
    f32 = jnp.float32
    kernel = functools.partial(
        _kernel,
        n_total=n,
        tile=tile,
        block_sec=float(block_sec),
        init_wait_sec=float(init_wait_sec),
        min_mean_db=float(min_mean_db),
        min_dur_b=int(min_dur_b),
        lock_tail=int(lock_tail),
    )
    outs = pl.pallas_call(
        kernel,
        grid=(c_pad // group,),
        in_specs=[series, series, series, state, state],
        out_specs=(series,) * 9 + (state, state),
        out_shape=(
            jax.ShapeDtypeStruct((n_pad, c_pad), f32),        # thr
            jax.ShapeDtypeStruct((n_pad, c_pad), jnp.int32),  # emit
            *[jax.ShapeDtypeStruct((n_pad, c_pad), f32) for _ in range(7)],
            jax.ShapeDtypeStruct((CARRY_ROWS, c_pad), f32),        # carry_f out
            jax.ShapeDtypeStruct((CARRY_ROWS, c_pad), jnp.int32),  # carry_i out
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="stream_machine",
    )(on_p, pm_p, bt_p, cf0, ci0)

    ys = tuple(o[:n, :C] for o in outs[:9])
    return ys, outs[9][:, :C], outs[10][:6, :C]
