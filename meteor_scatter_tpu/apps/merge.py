"""Multi-day event CSV analysis — re-design of `dsp/src/main_analyze.py`.

Merges per-day event CSVs produced by the batch analyzer
(`main.py:640-658` schema: t_start,t_stop,dur_s,dB,utc_start,utc_stop),
coerces UTC timestamps, and renders detections-per-hour, per-day, and a
date×hour heatmap (`main_analyze.py:14-188`).

Usage::

    python -m meteor_scatter_tpu.apps.merge out_*.csv --out-dir plots/
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional

import numpy as np
import pandas as pd


def merge_event_csvs(paths: List[str]) -> pd.DataFrame:
    """Concat + UTC coercion + sort (main_analyze.py:14-45)."""
    frames = []
    for p in paths:
        try:
            frames.append(pd.read_csv(p))
        except Exception as e:  # noqa: BLE001 — skip unreadable files
            print(f"Error loading {p}: {e}")
    if not frames:
        raise ValueError("no event CSVs could be loaded")
    df = pd.concat(frames, ignore_index=True)
    df["utc_start"] = pd.to_datetime(df["utc_start"], errors="coerce")
    df["utc_stop"] = pd.to_datetime(df["utc_stop"], errors="coerce")
    df = df.dropna(subset=["utc_start"]).sort_values("utc_start").reset_index(drop=True)
    return df


def detections_per_hour(df: pd.DataFrame) -> pd.Series:
    return df.groupby(df["utc_start"].dt.floor("h")).size()


def detections_per_day(df: pd.DataFrame) -> pd.Series:
    return df.groupby(df["utc_start"].dt.floor("D")).size()


def hour_day_matrix(df: pd.DataFrame) -> pd.DataFrame:
    """date × hour count matrix for the heatmap (main_analyze.py:153-188)."""
    tmp = pd.DataFrame(
        {"date": df["utc_start"].dt.date, "hour": df["utc_start"].dt.hour}
    )
    mat = tmp.groupby(["date", "hour"]).size().unstack(fill_value=0)
    return mat.reindex(columns=range(24), fill_value=0)


def render_plots(df: pd.DataFrame, out_dir: str) -> List[str]:
    """Bar charts + heatmap; requires matplotlib (present in this image),
    degrades to CSV dumps without it."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    per_hour = detections_per_hour(df)
    per_day = detections_per_day(df)
    mat = hour_day_matrix(df)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        for name, obj in [("per_hour", per_hour), ("per_day", per_day), ("heatmap", mat)]:
            p = os.path.join(out_dir, f"{name}.csv")
            obj.to_csv(p)
            written.append(p)
        return written

    # positional bars + explicit tick labels: pandas' .plot.bar on a
    # DatetimeIndex trips its Period converter ("Must supply freq") on
    # multi-day series
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.bar(range(len(per_hour)), per_hour.values, color="skyblue")
    ax.set_xlabel("UTC (Datum + Stunde)")
    ax.set_ylabel("Anzahl der Detektionen")
    ax.set_title("Detektionen pro Stunde")
    # thin the ticks like _svg_bar_chart: a multi-day merge has 100+ hourly
    # buckets and labeling every bar overlaps unreadably
    tick_step = max(1, len(per_hour) // 24)
    ax.set_xticks(range(0, len(per_hour), tick_step))
    ax.set_xticklabels([d.strftime("%Y-%m-%d %H:%M")
                        for d in per_hour.index[::tick_step]],
                       rotation=45, ha="right")
    fig.tight_layout()
    p = os.path.join(out_dir, "per_hour.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    written.append(p)

    fig, ax = plt.subplots(figsize=(12, 6))
    ax.bar(range(len(per_day)), per_day.values, color="steelblue")
    ax.set_xlabel("Datum")
    ax.set_ylabel("Anzahl der Detektionen")
    ax.set_title("Detektionen pro Tag")
    day_step = max(1, len(per_day) // 31)
    ax.set_xticks(range(0, len(per_day), day_step))
    ax.set_xticklabels([d.strftime("%Y-%m-%d") for d in per_day.index[::day_step]],
                       rotation=45, ha="right")
    fig.tight_layout()
    p = os.path.join(out_dir, "per_day.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    written.append(p)

    fig, ax = plt.subplots(figsize=(14, max(4, 0.4 * len(mat))))
    im = ax.imshow(mat.values, aspect="auto", cmap="viridis")
    ax.set_xticks(range(24))
    ax.set_yticks(range(len(mat)))
    ax.set_yticklabels([d.strftime("%Y-%m-%d") for d in mat.index])
    ax.set_xlabel("Stunde (UTC)")
    ax.set_title("Detektionen: Datum × Stunde")
    fig.colorbar(im, ax=ax, label="Anzahl")
    fig.tight_layout()
    p = os.path.join(out_dir, "heatmap.pdf")
    fig.savefig(p)
    plt.close(fig)
    written.append(p)
    return written


_HTML_HEAD = """<!doctype html>
<html><head><meta charset="utf-8"><title>Meteor detections</title>
<style>
 body{background:#111;color:#ddd;font-family:sans-serif;margin:1.5em}
 h2{color:#C72426}
 .bar{fill:#4ea3d8}.bar:hover{fill:#f5c542}
 .cell:hover{stroke:#fff;stroke-width:1px}
 #tip{position:fixed;pointer-events:none;background:#222;border:1px solid #555;
      padding:4px 8px;border-radius:4px;font-size:12px;display:none;z-index:9}
 svg{background:#181818;border:1px solid #333;max-width:100%}
 .axis{stroke:#666}text{fill:#aaa;font-size:10px}
</style></head><body>
<div id="tip"></div>
<script>
function tip(ev,msg){var t=document.getElementById('tip');
 t.style.display='block';t.innerHTML=msg;
 t.style.left=(ev.clientX+12)+'px';t.style.top=(ev.clientY+12)+'px';}
function untip(){document.getElementById('tip').style.display='none';}
</script>
"""


def _svg_bar_chart(labels: List[str], values: List[int], title: str,
                   width: int = 1100, height: int = 320) -> str:
    """One hoverable SVG bar chart (interactive stand-in for the reference's
    plotly chart, `main_analyze.py:116-150`)."""
    n = max(len(values), 1)
    vmax = max(max(values, default=0), 1)
    pad_l, pad_b, pad_t = 46, 58, 26
    plot_w, plot_h = width - pad_l - 10, height - pad_b - pad_t
    bw = plot_w / n
    parts = [f'<h2>{title}</h2>',
             f'<svg viewBox="0 0 {width} {height}" width="{width}" height="{height}">']
    # y gridlines + labels
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        y = pad_t + plot_h * (1 - frac)
        parts.append(f'<line class="axis" x1="{pad_l}" y1="{y:.1f}" '
                     f'x2="{width - 10}" y2="{y:.1f}" stroke-dasharray="2,4"/>')
        parts.append(f'<text x="{pad_l - 6}" y="{y + 3:.1f}" text-anchor="end">'
                     f'{vmax * frac:.0f}</text>')
    for i, (lab, v) in enumerate(zip(labels, values)):
        h = plot_h * v / vmax
        x = pad_l + i * bw
        y = pad_t + plot_h - h
        parts.append(
            f'<rect class="bar" x="{x:.1f}" y="{y:.1f}" width="{max(bw - 1, 0.5):.1f}" '
            f'height="{h:.1f}" onmousemove="tip(event,\'{lab}: <b>{v}</b>\')" '
            f'onmouseout="untip()"/>'
        )
        step = max(1, n // 24)  # at most ~24 x labels
        if i % step == 0:
            parts.append(
                f'<text x="{x + bw / 2:.1f}" y="{height - pad_b + 12}" '
                f'transform="rotate(45 {x + bw / 2:.1f} {height - pad_b + 12})">{lab}</text>'
            )
    parts.append("</svg>")
    return "\n".join(parts)


def _svg_heatmap(mat: pd.DataFrame, title: str) -> str:
    """date×hour heatmap as hoverable SVG cells (main_analyze.py:153-188)."""
    dates = [d.strftime("%Y-%m-%d") for d in mat.index]
    vmax = max(int(mat.values.max()) if mat.size else 0, 1)
    cw, ch, pad_l, pad_t = 34, 16, 86, 24
    width = pad_l + 24 * cw + 10
    height = pad_t + len(dates) * ch + 24
    parts = [f'<h2>{title}</h2>',
             f'<svg viewBox="0 0 {width} {height}" width="{width}" height="{height}">']
    for h in range(24):
        parts.append(f'<text x="{pad_l + h * cw + cw / 2:.0f}" y="{pad_t - 8}" '
                     f'text-anchor="middle">{h:02d}</text>')
    for r, date in enumerate(dates):
        y = pad_t + r * ch
        parts.append(f'<text x="{pad_l - 6}" y="{y + ch - 4}" text-anchor="end">{date}</text>')
        for h in range(24):
            v = int(mat.iloc[r, h])
            # viridis-ish two-stop ramp, dark→yellow
            f = v / vmax
            rgb = (int(40 + 215 * f), int(40 + 180 * f), int(90 * (1 - f) + 40))
            parts.append(
                f'<rect class="cell" x="{pad_l + h * cw}" y="{y}" width="{cw - 1}" '
                f'height="{ch - 1}" fill="rgb{rgb}" '
                f'onmousemove="tip(event,\'{date} {h:02d}:00 UTC: <b>{v}</b>\')" '
                f'onmouseout="untip()"/>'
            )
    parts.append("</svg>")
    return "\n".join(parts)


def render_html_report(df: pd.DataFrame, out_path: str) -> str:
    """Self-contained interactive HTML report — this framework's replacement for
    the reference's plotly HTML export (`main_analyze.py:116-150`); zero
    external dependencies so it opens offline on any browser."""
    per_hour = detections_per_hour(df)
    per_day = detections_per_day(df)
    mat = hour_day_matrix(df)
    span = (
        f"{df['utc_start'].min():%Y-%m-%d} … {df['utc_start'].max():%Y-%m-%d}"
        if len(df)
        else "no events"
    )
    html = [
        _HTML_HEAD,
        f"<h1>Meteor detections — {len(df)} events, {span}</h1>",
        _svg_bar_chart([d.strftime("%m-%d %Hh") for d in per_hour.index],
                       per_hour.tolist(), "Detektionen pro Stunde"),
        _svg_bar_chart([d.strftime("%Y-%m-%d") for d in per_day.index],
                       per_day.tolist(), "Detektionen pro Tag"),
        _svg_heatmap(mat, "Detektionen: Datum × Stunde"),
        "</body></html>",
    ]
    with open(out_path, "w") as fh:
        fh.write("\n".join(html))
    return out_path


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("csvs", nargs="+", help="event CSV files or globs")
    p.add_argument("--out-dir", default="analysis")
    args = p.parse_args(argv)

    paths: List[str] = []
    for pattern in args.csvs:
        paths.extend(sorted(glob.glob(pattern)))
    df = merge_event_csvs(paths)
    print(f"Merged {len(paths)} files -> {len(df)} detections "
          f"({df['utc_start'].min()} .. {df['utc_start'].max()})")
    written = render_plots(df, args.out_dir)
    written.append(render_html_report(df, os.path.join(args.out_dir, "report.html")))
    for w in written:
        print("wrote", w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
