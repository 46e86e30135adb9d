"""Fixed-capacity event tensors and mask→event extraction.

The reference accumulates detections in growing Python lists
(`dsp/src/main.py:417,454`); under XLA everything must be static-shape, so
events live in a fixed-capacity struct-of-arrays with a validity count.
Extraction of [start, stop) runs from a boolean "above threshold" series is
a fully vectorized cumsum/segment-sum program — no sequential loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Events(NamedTuple):
    """Struct-of-arrays event buffer.  Rows < ``count`` are valid.

    ``start``/``stop`` are block indices with *exclusive* stop;
    ``db_mean`` is the mean of the detection series over [start, stop)
    (matching `main.py:501-502`).  ``overflow`` flags dropped events when
    more than the capacity were found.
    """

    start: jnp.ndarray  # int32 [cap]
    stop: jnp.ndarray  # int32 [cap] (exclusive)
    db_mean: jnp.ndarray  # f32 [cap]
    count: jnp.ndarray  # int32 scalar
    overflow: jnp.ndarray  # bool scalar

    @property
    def capacity(self) -> int:
        return self.start.shape[0]


def empty_events(cap: int, dtype=jnp.float32) -> Events:
    return Events(
        start=jnp.zeros(cap, jnp.int32),
        stop=jnp.zeros(cap, jnp.int32),
        db_mean=jnp.zeros(cap, dtype),
        count=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), bool),
    )


def events_from_mask(above: jnp.ndarray, series: jnp.ndarray, cap: int) -> Events:
    """Extract maximal runs of True from ``above`` with per-run mean of
    ``series``.

    Vectorized equivalent of the reference's diff-based run splitting
    (`main.py:408-415`) and of the adaptive detector's consecutive-block
    merging (`main.py:486-489`): both produce exactly the maximal runs.
    """
    n = above.shape[0]
    dtype = series.dtype
    prev = jnp.concatenate([jnp.zeros(1, bool), above[:-1]])
    nxt = jnp.concatenate([above[1:], jnp.zeros(1, bool)])
    is_start = above & ~prev
    is_stop = above & ~nxt  # last block of each run

    run_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1  # valid where above
    num = jnp.sum(is_start.astype(jnp.int32))

    idx = jnp.arange(n, dtype=jnp.int32)
    scatter_to = jnp.where(is_start, run_id, cap)  # cap = out of range → dropped
    start = jnp.zeros(cap, jnp.int32).at[scatter_to].set(idx, mode="drop")
    scatter_to = jnp.where(is_stop, run_id, cap)
    stop = jnp.zeros(cap, jnp.int32).at[scatter_to].set(idx + 1, mode="drop")

    seg = jnp.where(above, run_id, cap)
    sums = jax.ops.segment_sum(jnp.where(above, series, 0).astype(dtype), seg, num_segments=cap + 1)[:cap]
    cnts = jax.ops.segment_sum(above.astype(jnp.int32), seg, num_segments=cap + 1)[:cap]
    mean = jnp.where(cnts > 0, sums / jnp.maximum(cnts, 1).astype(dtype), jnp.nan)

    return Events(
        start=start,
        stop=stop,
        db_mean=mean,
        count=jnp.minimum(num, cap),
        overflow=num > cap,
    )


def truncate_events(ev: Events, cap: int) -> Events:
    """Restore the fixed-cap contract after merges grew the buffer:
    capacity back to ``cap``, count ≤ cap, overflow set when events beyond
    the cap were dropped (matching :func:`events_from_mask`)."""
    if ev.capacity == cap:
        return ev
    if ev.capacity < cap:
        pad = cap - ev.capacity
        return Events(
            start=jnp.pad(ev.start, (0, pad)),
            stop=jnp.pad(ev.stop, (0, pad)),
            db_mean=jnp.pad(ev.db_mean, (0, pad)),
            count=ev.count,
            overflow=ev.overflow,
        )
    return Events(
        start=ev.start[:cap],
        stop=ev.stop[:cap],
        db_mean=ev.db_mean[:cap],
        count=jnp.minimum(ev.count, cap),
        overflow=ev.overflow | (ev.count > cap),
    )


def merge_adjacent(left: Events, right: Events, right_offset: int | jnp.ndarray) -> Events:
    """Concatenate two event buffers from adjacent time shards, merging a run
    that spans the seam (left's last event ends exactly where right's first
    begins after offsetting).  Used by the sharded pipelines to make
    time-sharded detection equal the unsharded run (SURVEY.md §2.6, "global
    event merge")."""
    cap = left.capacity + right.capacity
    r_start = right.start + right_offset
    r_stop = right.stop + right_offset

    ln = left.count
    l_last = jnp.maximum(ln - 1, 0)
    spans = (
        (ln > 0)
        & (right.count > 0)
        & (left.stop[l_last] == r_start[0])
    )

    # When spanning: fold right's first event into left's last.
    l_len = left.stop[l_last] - left.start[l_last]
    r_len = r_stop[0] - r_start[0]
    merged_mean = (
        left.db_mean[l_last] * l_len.astype(left.db_mean.dtype)
        + right.db_mean[0] * r_len.astype(left.db_mean.dtype)
    ) / (l_len + r_len).astype(left.db_mean.dtype)

    l_stop = jnp.where(
        spans, left.stop.at[l_last].set(r_stop[0]), left.stop
    )
    l_mean = jnp.where(spans, left.db_mean.at[l_last].set(merged_mean), left.db_mean)

    # Right events shift down by one when its first was merged away.
    shift = spans.astype(jnp.int32)
    r_idx = jnp.arange(right.capacity) + shift
    rs = jnp.take(r_start, jnp.minimum(r_idx, right.capacity - 1))
    rp = jnp.take(r_stop, jnp.minimum(r_idx, right.capacity - 1))
    rm = jnp.take(right.db_mean, jnp.minimum(r_idx, right.capacity - 1))
    r_count = right.count - shift

    # Place right events after left's.
    out_start = jnp.zeros(cap, jnp.int32)
    out_stop = jnp.zeros(cap, jnp.int32)
    out_mean = jnp.zeros(cap, left.db_mean.dtype)
    out_start = out_start.at[: left.capacity].set(left.start)
    out_stop = out_stop.at[: left.capacity].set(l_stop)
    out_mean = out_mean.at[: left.capacity].set(l_mean)

    pos = ln + jnp.arange(right.capacity)
    valid = jnp.arange(right.capacity) < r_count
    pos = jnp.where(valid, pos, cap)
    out_start = out_start.at[pos].set(rs, mode="drop")
    out_stop = out_stop.at[pos].set(rp, mode="drop")
    out_mean = out_mean.at[pos].set(rm, mode="drop")

    return Events(
        start=out_start,
        stop=out_stop,
        db_mean=out_mean,
        count=ln + r_count,
        overflow=left.overflow | right.overflow,
    )
