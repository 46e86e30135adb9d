"""Adaptive-threshold detector with post-detection freeze.

Accelerator re-design of `dsp/src/main.py:450-522`
(``get_detections_adaptive``).  The reference's recurrence per block i:

* first ``fixed_init`` seconds: threshold = global mean + k·global std
  (population std over the *whole* series — it is a two-pass algorithm);
* else if i > freeze_until: threshold = mean + k·std over the trailing
  window ``delta[max(0, i-W) : i]`` (current block excluded);
* else: threshold keeps its previous value (frozen);
* any above-threshold block sets
  ``freeze_until = max(i + freeze_after, max(0, i - freeze_before))``
  (`main.py:491-493`).

The recurrence is inherently sequential, so it runs as one ``lax.scan``
whose carry holds a ring buffer of the last W delta values plus running
window sums — O(1) state per step, O(W) work for the masked mean/std (the
re-reduction over the ring keeps f32 numerics exact instead of drifting
running sums).  Event extraction afterwards is the same vectorized
run-splitting as the fixed detector: the reference merges only directly
consecutive above-threshold blocks (`main.py:486-489`), i.e. maximal runs,
with stop = last index + 1 (`main.py:498-499`).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.models.events import Events, events_from_mask


def adaptive_thresholds(
    delta: jnp.ndarray,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    init_carry=None,
    global_stats: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, tuple]:
    """Scan the freeze/threshold recurrence.

    Returns ``(thresholds, above, carry)``.  ``init_carry`` / the returned
    carry allow chunked execution over long streams (and warm-started time
    shards): feed the carry of chunk c into chunk c+1 together with the
    absolute block offset it contains.

    ``global_stats=(mean, std)`` are the whole-series statistics used for
    the fixed initial threshold; pass them explicitly when processing in
    chunks (the reference computes them over the full file).
    """
    dtype = delta.dtype
    w = window_blocks

    if global_stats is None:
        g_mean = jnp.mean(delta)
        g_std = jnp.std(delta)
    else:
        g_mean, g_std = global_stats
    fixed_threshold = g_mean + threshold_std_factor * g_std

    if init_carry is None:
        init_carry = (
            jnp.zeros(w, dtype),  # ring of trailing deltas
            jnp.asarray(0, jnp.int32),  # absolute block index i
            jnp.asarray(-1, jnp.int32),  # freeze_until
            fixed_threshold.astype(dtype),  # previous threshold
        )

    slot_ids = jnp.arange(w, dtype=jnp.int32)

    def step(carry, d):
        ring, i, freeze_until, prev_thr = carry

        cnt = jnp.minimum(i, w)
        valid = slot_ids < cnt  # ring fills slots 0..i-1 before wrapping
        cnt_f = jnp.maximum(cnt, 1).astype(dtype)
        m = jnp.sum(jnp.where(valid, ring, 0)) / cnt_f
        m2 = jnp.sum(jnp.where(valid, ring * ring, 0)) / cnt_f
        std = jnp.sqrt(jnp.maximum(m2 - m * m, 0))
        windowed = m + threshold_std_factor * std

        in_fixed = i < fixed_threshold_blocks
        can_update = jnp.logical_and(~in_fixed, i > freeze_until)
        thr = jnp.where(
            in_fixed, fixed_threshold, jnp.where(can_update, windowed, prev_thr)
        ).astype(dtype)

        # pre-stream blocks (absolute index < 0 — reachable only through a
        # time-shard warm-up replay over shard 0's zero-filled halo) must
        # never register detections: the unsharded series has no such
        # blocks, and a fixed threshold below zero would otherwise let the
        # zero-padding fire and freeze real early blocks (no-op when i >= 0)
        above = jnp.logical_and(d > thr, i >= 0)
        new_freeze = jnp.maximum(
            i + freeze_blocks_after, jnp.maximum(0, i - freeze_blocks_before)
        )
        freeze_until = jnp.where(above, new_freeze, freeze_until)

        ring = ring.at[jnp.mod(i, w)].set(d)
        return (ring, i + 1, freeze_until, thr), (thr, above)

    carry, (thresholds, above) = jax.lax.scan(step, init_carry, delta)
    return thresholds, above, carry


def adaptive_thresholds_fast(
    delta: jnp.ndarray,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same semantics as :func:`adaptive_thresholds` (full-series case),
    restructured for an accelerator: the rolling window mean/std of *every* block
    is precomputed in parallel with prefix sums, so the unavoidable
    sequential part — the freeze recurrence — carries only two scalars and
    costs ~10 flops per step instead of an O(window) reduction.

    Returns (thresholds, above).
    """
    dtype = delta.dtype
    n = delta.shape[0]
    w = window_blocks

    g_mean = jnp.mean(delta)
    g_std = jnp.std(delta)
    fixed_thr = (g_mean + threshold_std_factor * g_std).astype(dtype)

    # trailing-window stats over delta[max(0, i-w) : i)  (current excluded)
    zero = jnp.zeros(1, dtype)
    cs = jnp.concatenate([zero, jnp.cumsum(delta)])
    cs2 = jnp.concatenate([zero, jnp.cumsum(delta * delta)])
    i = jnp.arange(n)
    lo = jnp.maximum(i - w, 0)
    cnt = (i - lo).astype(dtype)
    safe = jnp.maximum(cnt, 1)
    m = (cs[i] - cs[lo]) / safe
    m2 = (cs2[i] - cs2[lo]) / safe
    std = jnp.sqrt(jnp.maximum(m2 - m * m, 0))
    # cnt==0 only at block 0: the sequential scan computes 0+k*0 = 0
    # there (empty-window stats), reachable when fixed_threshold_blocks
    # == 0 — NaN would silently suppress detections at that block
    windowed = jnp.where(cnt > 0, m + threshold_std_factor * std, 0.0)

    def step(carry, inp):
        freeze_until, prev_thr = carry
        d, wt, idx = inp
        in_fixed = idx < fixed_threshold_blocks
        can_update = jnp.logical_and(~in_fixed, idx > freeze_until)
        thr = jnp.where(in_fixed, fixed_thr, jnp.where(can_update, wt, prev_thr)).astype(dtype)
        above = d > thr
        new_freeze = jnp.maximum(
            idx + freeze_blocks_after, jnp.maximum(0, idx - freeze_blocks_before)
        )
        freeze_until = jnp.where(above, new_freeze, freeze_until)
        return (freeze_until, thr), (thr, above)

    (_, _), (thresholds, above) = jax.lax.scan(
        step,
        (jnp.asarray(-1, jnp.int32), fixed_thr),
        (delta, windowed, i.astype(jnp.int32)),
    )
    return thresholds, above


def adaptive_thresholds_parallel(
    delta: jnp.ndarray,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sequential-scan-free adaptive detector via fixpoint iteration.

    The freeze recurrence is the only sequential part of the reference
    algorithm, and on an accelerator a 432 000-step scan is latency-bound.  This solver
    removes it: given a *candidate* set of above-threshold blocks, the
    entire threshold series is expressible in closed vector form —

      freeze_until_i = cummax_{j<=i}( above_j ? max(j+fa, max(0, j-fb)) : -1 )
      updatable_i    = (i > freeze_until_{i-1}) & (i >= fixed_blocks)
      thr_i          = windowed[ last updatable index <= i ]   (gather)

    — so we iterate: thresholds from candidate detections → detections from
    thresholds, until the detection set is stationary.

    Correctness: by induction, after round k the solution is exact up to the
    k-th freeze episode (freezes are causal and the pre-first-crossing
    thresholds never depend on any freeze).  A stationary point therefore
    equals the sequential solution — it is not merely *a* consistent
    labeling.  Convergence takes #episodes rounds at worst and 2-4 rounds in
    practice; each round is ~6 elementwise/cummax passes over the block
    series.

    Returns (thresholds, above) identical to :func:`adaptive_thresholds`
    (full-series case).
    """
    dtype = delta.dtype
    n = delta.shape[0]
    w = window_blocks
    if max_rounds is None:
        max_rounds = n

    g_mean = jnp.mean(delta)
    g_std = jnp.std(delta)
    fixed_thr = (g_mean + threshold_std_factor * g_std).astype(dtype)

    # rolling-window stats (current block excluded) via prefix sums
    zero = jnp.zeros(1, dtype)
    cs = jnp.concatenate([zero, jnp.cumsum(delta)])
    cs2 = jnp.concatenate([zero, jnp.cumsum(delta * delta)])
    i = jnp.arange(n)
    lo = jnp.maximum(i - w, 0)
    cnt = (i - lo).astype(dtype)
    safe = jnp.maximum(cnt, 1)
    m = (cs[i] - cs[lo]) / safe
    m2 = (cs2[i] - cs2[lo]) / safe
    std = jnp.sqrt(jnp.maximum(m2 - m * m, 0))
    # cnt==0 only at block 0: the sequential scan computes 0+k*0 = 0
    # there (empty-window stats), reachable when fixed_threshold_blocks
    # == 0 — NaN would silently suppress detections at that block
    windowed = jnp.where(cnt > 0, m + threshold_std_factor * std, 0.0)

    new_freeze = jnp.maximum(i + freeze_blocks_after, jnp.maximum(0, i - freeze_blocks_before))
    in_fixed = i < fixed_threshold_blocks

    def thresholds_from(above):
        f = jnp.where(above, new_freeze, -1)
        freeze_until = jax.lax.cummax(f)  # state after block i
        freeze_prev = jnp.concatenate([jnp.full(1, -1, f.dtype), freeze_until[:-1]])
        updatable = (i > freeze_prev) & ~in_fixed
        last_upd = jax.lax.cummax(jnp.where(updatable, i, -1))
        frozen_thr = jnp.where(last_upd >= 0, windowed[jnp.maximum(last_upd, 0)], fixed_thr)
        return jnp.where(in_fixed, fixed_thr, frozen_thr).astype(dtype)

    def cond(state):
        above, prev, rounds = state
        return jnp.any(above != prev) & (rounds < max_rounds)

    def body(state):
        above, _, rounds = state
        thr = thresholds_from(above)
        return (delta > thr, above, rounds + 1)

    above0 = delta > thresholds_from(jnp.zeros(n, bool))
    # `above0 ^ above0` is all-False but *derived from the data*, which keeps
    # the carry's varying-manual-axes type consistent when this solver runs
    # inside shard_map (a plain zeros constant is unvarying and rejected)
    above, _, _ = jax.lax.while_loop(
        cond, body, (above0, above0 ^ above0, jnp.asarray(1, jnp.int32))
    )
    thr = thresholds_from(above)
    return thr, delta > thr


def detect_adaptive(
    delta: jnp.ndarray,
    threshold_std_factor: float,
    block_duration_sec: float,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_detection_sec: float = 3.0,
    threshold_freeze_after_detection_sec: float = 20.0,
    threshold_fixed_init_duration_sec: float = 10.0,
    cap: int = 4096,
) -> Tuple[Events, jnp.ndarray]:
    """Full-series adaptive detection: (events, per-block thresholds).

    Block→seconds conversion (`main.py:503-505`): t_start = start·bd,
    t_stop = (last+1)·bd, dB mean over [start, last+1).  The solver is
    :func:`adaptive_thresholds_parallel` on every platform, for any series
    length.
    """
    bd = block_duration_sec
    thresholds, above = adaptive_thresholds_parallel(
        delta,
        threshold_std_factor=threshold_std_factor,
        window_blocks=int(threshold_estimation_window_sec / bd),
        freeze_blocks_before=int(threshold_freeze_before_detection_sec / bd),
        freeze_blocks_after=int(threshold_freeze_after_detection_sec / bd),
        fixed_threshold_blocks=int(threshold_fixed_init_duration_sec / bd),
    )
    return events_from_mask(above, delta, cap), thresholds
