"""Fixed global-threshold detector.

Accelerator re-design of `dsp/src/main.py:396-448` (``get_detections``):
threshold = mean(delta) + k·std(delta) over the whole series (population
std, ddof=0), runs of above-threshold blocks become detections.  Fully
parallel — one reduction plus a vectorized run extraction, no scan.

Reference edge-case semantics preserved exactly:

* a run that reaches the end of the series gets stop index ``n-1``
  (`main.py:414-415` appends ``len(delta)-1``, not ``len(delta)``), so its
  final block is excluded from the dB mean and the duration;
* otherwise stop is the first below-threshold index after the run
  (exclusive), and the dB mean runs over ``delta[start:stop]``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from meteor_scatter_tpu.models.events import Events, events_from_mask


def detect_fixed(
    delta: jnp.ndarray,
    threshold_std_factor: float,
    cap: int = 4096,
) -> Tuple[Events, jnp.ndarray]:
    """Returns (events, threshold).  Event indices are block indices; convert
    to seconds by multiplying with block_duration_sec (`main.py:425-426`)."""
    mean = jnp.mean(delta)
    std = jnp.std(delta)
    threshold = mean + threshold_std_factor * std
    above = delta > threshold

    ev = events_from_mask(above, delta, cap)

    # Reference end-of-series semantics: if the last block is above
    # threshold, its run is reported with stop = n-1 (exclusive) and the
    # dB mean recomputed over [start, n-1).
    n = delta.shape[0]
    last = jnp.maximum(ev.count - 1, 0)
    # under overflow the end-touching run (the highest run id) was dropped
    # by events_from_mask, so slot count-1 holds an unrelated earlier event
    # — patching it would corrupt its stop/mean
    ends_open = (ev.count > 0) & above[-1] & ~ev.overflow
    open_stop = jnp.asarray(n - 1, jnp.int32)
    open_start = ev.start[last]
    length = jnp.maximum(open_stop - open_start, 0)
    # re-mean over the truncated range: remove the final block's value
    full_len = ev.stop[last] - ev.start[last]
    sum_full = ev.db_mean[last] * full_len.astype(delta.dtype)
    sum_trunc = sum_full - delta[-1]
    mean_trunc = jnp.where(length > 0, sum_trunc / jnp.maximum(length, 1).astype(delta.dtype), jnp.nan)

    new_stop = jnp.where(ends_open, ev.stop.at[last].set(open_stop), ev.stop)
    new_mean = jnp.where(ends_open, ev.db_mean.at[last].set(mean_trunc), ev.db_mean)

    return (
        Events(ev.start, new_stop, new_mean, ev.count, ev.overflow),
        threshold,
    )
