"""Quantify the decision-flip risk of the fast streaming path (VERDICT r2
item 3): how close do the streaming machine's decisions come to ties,
relative to the numerical deltas between the formulations?

The fast path (``front="bins"`` + episode-jump solvers) differs from the
reference-formulation welch:scan only in f32 reduction order.  The machine
has exactly three decision families:

1. **Threshold crossings** (enter/leave tracking): compare ``over_noise``
   against the rolling threshold.  The bins front shifts ``over_noise`` by
   a reduction-order delta, so a crossing can move by a block when the
   margin at the boundary block is below that delta — it shifts an event
   boundary, it does not invent or drop an event (the next block's margin
   is the burst's rise/fall slope, orders of magnitude larger).
2. **Duration acceptance**: integer block arithmetic on both paths —
   immune to float noise *given the same boundary blocks*; a one-block
   boundary shift can flip it only for events sitting exactly at
   ``min_duration_blocks``.
3. **dB-mean acceptance**: ``h_mean >= min_mean_db`` where the solvers
   accumulate ``h_mean`` in different orders.

This tool measures, over many random fixtures: (a) the max over_noise
delta between fronts, (b) the distribution of crossing-block margins,
(c) the distribution of |h_mean − min_mean_db| accept margins vs the max
h_mean delta between solvers, (d) duration-at-exact-minimum frequency,
and (e) the end-to-end event-list agreement between welch:scan and
bins:hop.  The recorded numbers live in PARITY.md.

    JAX_PLATFORMS=cpu python tools/tie_margin_study.py [--fixtures 60] [--seconds 300]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def synth(fs: int, seconds: float, seed: int) -> np.ndarray:
    """Noise + a few bursts with randomized strength/duration, including
    marginal ones near the accept bounds."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = rng.standard_normal(n).astype(np.float32) * 0.05
    s = 12.0
    while s < seconds - 5.0:
        dur = float(rng.uniform(0.2, 2.0))  # some below the 0.5 s minimum
        amp = float(rng.uniform(0.012, 0.25))  # spans the 1 dB mean minimum
        m = (t >= s) & (t < s + dur)
        x[m] += amp * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
        s += float(rng.uniform(20.0, 45.0))
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fixtures", type=int, default=60)
    p.add_argument("--seconds", type=float, default=300.0)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import (
        StreamConfig,
        min_duration_blocks,
        stream_front,
        stream_front_headless,
        stream_init,
        stream_scan,
        stream_scan_jump,
        stream_scan_jump_batch,
    )

    fs = 4000
    cfg = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    scfg = StreamConfig.from_config(cfg)
    min_dur_b = min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)

    fronts = jax.jit(
        lambda x: (
            stream_front(cfg, x, fs)[0],
            stream_front_headless(cfg, x, fs)[0],
        )
    )
    run_scan = jax.jit(lambda on, pm: stream_scan(scfg, stream_init(scfg), on, pm))
    run_jump = jax.jit(
        lambda on, pm: stream_scan_jump(scfg, stream_init(scfg), on, pm)
    )
    run_hop = jax.jit(
        lambda on, pm: stream_scan_jump_batch(scfg, stream_init(scfg), on, pm)
    )

    front_deltas = []
    crossing_margins = []  # |over_noise - thr| on boundary blocks
    accept_margins = []  # |h_mean - min| per accepted event
    hmean_deltas = []  # |h_mean_scan - h_mean_{jump,hop}| per event
    durations_at_min = 0
    total_events = 0
    e2e_mismatches = 0
    solver_mismatches = 0

    for f in range(args.fixtures):
        x = jnp.asarray(synth(fs, args.seconds, seed=1000 + f))
        on_w, on_b = fronts(x)
        on_w = np.asarray(on_w)
        on_b = np.asarray(on_b)
        front_deltas.append(np.abs(on_w - on_b).max())

        pm = jnp.zeros_like(jnp.asarray(on_w))
        st_s, ev_s, thr_s = run_scan(jnp.asarray(on_w), pm)
        c = int(ev_s.count)
        total_events += c
        thr = np.asarray(thr_s)
        starts = np.asarray(ev_s.time_start)[:c]
        stops = np.asarray(ev_s.time_stop)[:c]
        means = np.asarray(ev_s.db_mean)[:c]
        durs_blocks = np.rint(
            (stops - starts) / scfg.block_sec
        ).astype(int)
        durations_at_min += int((durs_blocks == min_dur_b).sum())
        accept_margins.extend(np.abs(means - scfg.min_mean_db).tolist())
        # margins at the boundary blocks (entry = first block above thr,
        # leave = first block back below the locked value)
        for ts, tp in zip(starts, stops):
            for tb in (ts, tp):
                i = int(round(tb / scfg.block_sec))
                if 0 <= i < len(on_w) and np.isfinite(thr[i]):
                    crossing_margins.append(abs(on_w[i] - thr[i]))

        # h_mean deltas across solvers on the same series
        for runner in (run_jump, run_hop):
            _, ev_o, _ = runner(jnp.asarray(on_w), pm)
            co = int(ev_o.count)
            if co == c:
                mo = np.asarray(ev_o.db_mean)[:co]
                hmean_deltas.extend(np.abs(mo - means).tolist())
            else:  # a flip happened — record it loudly, as a SOLVER
                # mismatch (same welch series, different solver), not as a
                # front-comparison flip
                solver_mismatches += 1

        # end-to-end: default path vs fast path
        st_f, ev_f, _ = run_hop(jnp.asarray(on_b), pm)
        cf = int(ev_f.count)
        if cf != c or not np.allclose(
            np.asarray(ev_f.time_start)[:cf], starts, atol=scfg.block_sec
        ):
            e2e_mismatches += 1

    front_deltas = np.asarray(front_deltas)
    crossing_margins = np.asarray(crossing_margins)
    accept_margins = np.asarray(accept_margins)
    hmean_deltas = np.asarray(hmean_deltas) if hmean_deltas else np.zeros(1)

    def q(a, p):
        return float(np.percentile(a, p)) if len(a) else float("nan")

    def mn(a):  # min that survives a zero-event run
        return float(a.min()) if len(a) else float("nan")

    print(f"fixtures={args.fixtures} x {args.seconds:.0f}s  "
          f"events={total_events}  backend={jax.default_backend()}")
    print(f"front delta |on_bins - on_welch|: max {front_deltas.max():.3e} dB, "
          f"median {np.median(front_deltas):.3e} dB")
    print(f"crossing-block margin |on - thr|: min {mn(crossing_margins):.3e} dB, "
          f"p5 {q(crossing_margins, 5):.3e}, median {q(crossing_margins, 50):.3e}")
    print(f"accept margin |h_mean - {scfg.min_mean_db}|: "
          f"min {mn(accept_margins):.3e} dB, p5 {q(accept_margins, 5):.3e}, "
          f"median {q(accept_margins, 50):.3e}")
    print(f"solver h_mean delta (jump/hop vs scan): max {hmean_deltas.max():.3e} dB")
    print(f"events at exact minimum duration: {durations_at_min}/{total_events}")
    print(f"solver event-count mismatches (jump/hop vs scan on the SAME "
          f"welch series): {solver_mismatches}")
    print(f"end-to-end event-list mismatches (welch:scan vs bins:hop, "
          f"boundary tol 1 block): {e2e_mismatches}")
    ratio = mn(accept_margins) / max(hmean_deltas.max(), 1e-12)
    print(f"accept-margin floor / h_mean-delta ceiling: {ratio:,.0f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
