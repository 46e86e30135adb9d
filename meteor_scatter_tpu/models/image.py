"""Spectrogram-domain burst detector + classifier — the "ML path".

Accelerator re-conception of `meteor_detect_class/` (the deployed 24/7
pipeline).  The reference renders a matplotlib spectrogram JPEG
(`prime_detection.py:61-98`), finds ORB keypoints on the image, clusters
them with DBSCAN (eps=30 px, min_samples=5), and classifies clusters with
bounding-box width ≥ 5 px ≈ 0.5 s as "critical"
(`detector_and_classification.py:7-88`).

Rendering an image to detect on it is a CPU-era artifact.  Here the same
decision process runs directly on the dB spectrogram array on device:

1. the reference's noise-floor cut becomes the detection threshold: pixels
   with dB above the display vmin (`power_density_db_hz/(40/23) +
   C_MS_SPEC_CUT_FACTOR`, prime_detection.py:84-85) inside the 800-1200 Hz
   display band are "keypoints";
2. DBSCAN runs exactly at pixel resolution (round 5): the core rule counts
   L2 eps-neighbors with one elliptical-stencil conv (the rendered-pixel
   metric is anisotropic in grid space), clusters are labeled by
   pointer-jumping min-propagation directly on the core graph whose
   per-round neighborhood is the whole eps ellipse, and border keypoints
   join a core's cluster within exact L2 reach — count-level agreement
   with a clean-room DBSCAN oracle is pinned in tests (VALIDATION.md);
3. the critical rule is evaluated on the cluster's bounding-box *duration
   in seconds*, calibrated to the reference's pixel rule: its rendered
   axes map 496 px ↔ 25 s and 365 px ↔ 400 Hz
   (`detector_and_classification.py:73-78`), so 5 px ≈ 0.5 s and
   eps=30 px ≈ (1.51 s, 32.9 Hz).

Equivalence with the reference is judged at the event/count level
(SURVEY.md §7 "Hard parts") — ORB internals are not reproducible, the
hourly Anzahl/Kritisch counts are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meteor_scatter_tpu.ops.spectrogram import spectrogram_mpl

# Reference rendering scale (detector_and_classification.py:73-78)
_REF_PX_PER_SEC = 496.0 / 25.0
_REF_PX_PER_HZ = 365.0 / 400.0


class SpectrogramImage(NamedTuple):
    """Device-side equivalent of the rendered spectrogram JPEG."""

    db: jnp.ndarray  # (n_bins, n_frames) dB, display band only
    vmin: jnp.ndarray  # noise-floor derived display cut (scalar)
    freqs: np.ndarray  # (n_bins,) Hz
    hop_sec: float  # seconds per time pixel
    hz_per_bin: float


class ImageBursts(NamedTuple):
    """Fixed-capacity cluster buffer (rows < count valid)."""

    t_min: jnp.ndarray  # frame index of bbox left edge
    t_max: jnp.ndarray
    f_min: jnp.ndarray  # bin index of bbox bottom edge
    f_max: jnp.ndarray
    n_points: jnp.ndarray  # member pixels (pre-dilation)
    critical: jnp.ndarray  # bool
    count: jnp.ndarray
    n_critical: jnp.ndarray
    n_non_critical: jnp.ndarray
    # clusters beyond the cap were routed to the drop bucket: counts are
    # lower bounds when set (fixed-capacity buffer convention, CLAUDE.md)
    overflow: jnp.ndarray


def spectrogram_image(
    audio: jnp.ndarray,
    fs: float,
    n_fft: int = 2048,
    spec_cut_factor: float = 8.0,
    noise_floor_band: Tuple[float, float] = (250.0, 800.0),
    display_band: Tuple[float, float] = (800.0, 1200.0),
) -> SpectrogramImage:
    """Reproduce `plot_spectrogram` (prime_detection.py:61-98) as arrays:
    mpl-specgram PSD, noise-floor power density from the quiet band, and
    the display cut vmin = density_db/(40/23) + cut_factor."""
    freqs, times, pxx = spectrogram_mpl(audio, fs, n_fft, noverlap=n_fft // 2)
    delta_f = fs / n_fft

    nb = (freqs >= noise_floor_band[0]) & (freqs <= noise_floor_band[1])
    bandwidth = float(nb.sum()) * delta_f
    band_power = jnp.sum(pxx[np.nonzero(nb)[0], :])  # summed over freq AND time (:76)
    power_density_db_hz = 10.0 * jnp.log10(band_power / bandwidth)
    vmin = power_density_db_hz / (40.0 / 23.0) + spec_cut_factor

    db_mask = np.nonzero((freqs >= display_band[0]) & (freqs <= display_band[1]))[0]
    pxx_db = 10.0 * jnp.log10(pxx[db_mask, :])

    return SpectrogramImage(
        db=pxx_db,
        vmin=vmin,
        freqs=freqs[db_mask],
        hop_sec=(n_fft // 2) / fs,
        hz_per_bin=delta_f,
    )


def _connected_components(mask: jnp.ndarray) -> jnp.ndarray:
    """Label 8-connected components of a 2-D bool mask.

    Pointer-jumping min-propagation: every pixel starts with its own id,
    alternately takes the min over its 3×3 neighborhood (within the mask)
    and jumps through the label table (``l = l[l]``), until stable.
    Converges in O(log d) jumps for diameter d.  Returns int32 labels,
    HW (=out of range) on background pixels.
    """
    h, w = mask.shape
    hw = h * w
    ids = jnp.arange(hw, dtype=jnp.int32).reshape(h, w)
    big = jnp.asarray(hw, jnp.int32)
    labels = jnp.where(mask, ids, big)

    def neighbor_min(lab):
        padded = jnp.pad(lab, 1, constant_values=hw)
        best = lab
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                best = jnp.minimum(best, padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
        return jnp.where(mask, best, big)

    def jump(lab):
        flat = jnp.concatenate([lab.reshape(-1), jnp.asarray([hw], jnp.int32)])
        for _ in range(3):  # 3 jumps per round: path length 8x
            flat = flat[flat]
        return flat[:-1].reshape(h, w)

    def body(state):
        lab, _ = state
        new = jump(neighbor_min(lab))
        return new, jnp.any(new != lab)

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.asarray(True)))
    return labels


def _ellipse_spans(radius_px: float, px_f: float, px_t: float):
    """Row decomposition of :func:`_ellipse_kernel`: for each row offset dy,
    the half-width wx(dy) of the ellipse row (static host-side ints)."""
    ry = int(math.floor(radius_px / px_f))
    spans = []
    for dy in range(-ry, ry + 1):
        # +1e-9 admits offsets at distance exactly eps despite FP rounding
        # (DBSCAN's ≤-eps rule); the kernel inherits it via _ellipse_kernel
        rem = radius_px * radius_px + 1e-9 - (dy * px_f) ** 2
        if rem < 0:
            continue
        spans.append((dy, int(math.floor(math.sqrt(rem) / px_t))))
    return spans


def _ellipse_min(lab: jnp.ndarray, spans, big: int) -> jnp.ndarray:
    """Min over the L2 eps-ellipse neighborhood of every pixel — one exact
    adjacency step of the DBSCAN core graph.  Decomposed by ellipse rows:
    shift by dy, separable 1-D box min of that row's half-width, combine.
    ~2·ry reduce_windows instead of a |ellipse|-tap stencil."""
    h, w = lab.shape
    ry = max(abs(dy) for dy, _ in spans)
    padded = jnp.pad(lab, ((ry, ry), (0, 0)), constant_values=big)
    best = jnp.full_like(lab, big)
    for dy, wx in spans:
        row = jax.lax.dynamic_slice_in_dim(padded, ry + dy, h, axis=0)
        row_min = jax.lax.reduce_window(
            row,
            jnp.asarray(big, lab.dtype),
            jax.lax.min,
            window_dimensions=(1, 2 * wx + 1),
            window_strides=(1, 1),
            padding="SAME",
        )
        best = jnp.minimum(best, row_min)
    return best


def _cluster_core_labels(core: jnp.ndarray, spans) -> jnp.ndarray:
    """Label the connected components of ``core`` pixels under L2
    eps-adjacency (the DBSCAN core graph) — min-propagation like
    :func:`_connected_components` but each round's neighborhood is the
    *whole eps ellipse* (one exact graph step ≈ eps pixels of spatial
    reach, vs 1 px for the 3×3 stencil), so convergence takes a handful
    of rounds instead of O(cluster diameter): the dilate-then-3×3-CC
    formulation walked thin ellipse-dilated masks one pixel per
    while_loop round; this takes a few rounds of ~27 separable
    reduce_windows.  Returns int32 labels, HW on non-core pixels."""
    h, w = core.shape
    hw = h * w
    ids = jnp.arange(hw, dtype=jnp.int32).reshape(h, w)
    big = hw
    labels = jnp.where(core, ids, big)

    def step(lab):
        best = _ellipse_min(lab, spans, big)
        return jnp.where(core, jnp.minimum(lab, best), big)

    def jump(lab):
        flat = jnp.concatenate([lab.reshape(-1), jnp.asarray([hw], jnp.int32)])
        for _ in range(3):
            flat = flat[flat]
        return flat[:-1].reshape(h, w)

    def body(state):
        lab, _ = state
        new = jump(step(lab))
        return new, jnp.any(new != lab)

    labels, _ = jax.lax.while_loop(
        lambda s: s[1], body, (labels, jnp.asarray(True))
    )
    return labels


def render_intensity(img: SpectrogramImage, vmax: float = 40.0) -> jnp.ndarray:
    """The grayscale image the reference detector actually sees: dB clipped
    to [vmin, vmax] (the display window of prime_detection.py:84-85) and
    scaled to 0..255.  Pure array op — no JPEG round trip."""
    x = jnp.clip(img.db, img.vmin, vmax)
    return (x - img.vmin) / jnp.maximum(vmax - img.vmin, 1e-6) * 255.0


def corner_keypoints(
    img: SpectrogramImage,
    nfeatures: int = 500,
    k: float = 0.04,
    rel_floor: float = 1e-5,
) -> jnp.ndarray:
    """Corner-score keypoint mask — the ORB-like mode.

    The reference runs ORB (FAST keypoints ranked by Harris response,
    ``nfeatures=500``, `detector_and_classification.py:12-13`) on the
    rendered JPEG.  This computes the Harris response directly on the
    rendered-intensity array with Sobel gradients + 3×3 structure-tensor
    smoothing (all static convolutions — XLA fuses them), keeps local
    maxima, and caps at the strongest ``nfeatures`` via top-k exactly as
    ORB's retention rule.  Returns a bool mask shaped like ``img.db``;
    feed it to :func:`cluster_bursts` as ``keypoint_mask``.
    """
    gray = render_intensity(img)
    h, w = gray.shape

    def conv2(x, kern):
        # HIGHEST: a default-precision f32 convolution may run in TF32 on
        # the GPU, and the corner scores rank keypoints
        return jax.lax.conv_general_dilated(
            x[None, None, :, :],
            jnp.asarray(kern, jnp.float32)[None, None, :, :],
            window_strides=(1, 1),
            padding="SAME",
            precision=jax.lax.Precision.HIGHEST,
        )[0, 0]

    sobel_x = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
    sobel_y = [[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]]
    ix = conv2(gray, sobel_x)
    iy = conv2(gray, sobel_y)
    box = [[1.0 / 9.0] * 3] * 3
    sxx = conv2(ix * ix, box)
    syy = conv2(iy * iy, box)
    sxy = conv2(ix * iy, box)
    r = (sxx * syy - sxy * sxy) - k * (sxx + syy) ** 2

    # No non-max suppression: the raw spectrogram is ~15x coarser than the
    # reference's interpolated 496x365 render, so NMS would collapse a whole
    # burst blob to <5 peaks and DBSCAN's min_samples would reject it.  Like
    # ORB's low FAST threshold, all positive corner responses above a loose
    # relative floor are admitted; top-k retention + DBSCAN do the filtering.
    # Corners are gated to visible (above-cut) pixels: the reference's JPEG
    # background is uniform black, so ORB cannot fire there either — without
    # this gate every 1-px noise speckle inflates to ~9 px of Sobel support
    # and defeats DBSCAN's min_samples.
    is_peak = (r > rel_floor * jnp.max(r)) & (r > 0) & (gray > 0)

    # ORB retention: strongest nfeatures only (fixed shape via top-k)
    scores = jnp.where(is_peak, r, -jnp.inf).reshape(-1)
    nf = min(nfeatures, h * w)
    top_vals, top_idx = jax.lax.top_k(scores, nf)
    keep = jnp.zeros(h * w, bool).at[top_idx].set(top_vals > -jnp.inf)
    return keep.reshape(h, w)


def _ellipse_kernel(radius_px: float, px_f: float, px_t: float) -> np.ndarray:
    """Bool stencil of grid offsets within ``radius_px`` in the reference's
    rendered-pixel metric (non-square spectrogram pixels → an ellipse in
    grid space): (dy·px_f)² + (dx·px_t)² ≤ r².  Derived from
    :func:`_ellipse_spans` so the core-counting neighborhood (this conv
    stencil) and the adjacency/border neighborhood (the span-decomposed
    reduce_windows) are the *same set of offsets by construction* — two
    independent boundary roundings could otherwise disagree on a pair at
    distance exactly eps, making a point core under one neighborhood but
    unreachable under the other (round-5 review finding)."""
    spans = _ellipse_spans(radius_px, px_f, px_t)
    ry = max(abs(dy) for dy, _ in spans)
    rx = max(wx for _, wx in spans)
    k = np.zeros((2 * ry + 1, 2 * rx + 1), dtype=bool)
    for dy, wx in spans:
        k[dy + ry, rx - wx : rx + wx + 1] = True
    return k


def _conv_count(x: jnp.ndarray, kern: np.ndarray) -> jnp.ndarray:
    """SAME-padded 2-D convolution with a static 0/1 stencil (neighbor
    counting / set dilation).  Exact at any precision, TF32 included: the
    operands are 0 or 1 and the sums are small integers, all exact in
    TF32's 10-bit mantissa with float32 accumulation."""
    return jax.lax.conv_general_dilated(
        x.astype(jnp.float32)[None, None, :, :],
        jnp.asarray(kern, jnp.float32)[None, None, :, :],
        window_strides=(1, 1),
        padding="SAME",
    )[0, 0]


def cluster_bursts(
    img: SpectrogramImage,
    eps_px: float = 30.0,
    min_samples: int = 5,
    critical_min_width_px: float = 5.0,
    cap: int = 64,
    keypoint_mask: jnp.ndarray | None = None,
    core_gate: bool = True,
) -> ImageBursts:
    """DBSCAN-equivalent clustering of above-cut spectrogram pixels with the
    reference's pixel-calibrated eps / width thresholds.

    ``keypoint_mask`` overrides the default threshold keypoints (e.g. the
    corner-score mask from :func:`corner_keypoints` for ORB-like behavior).

    ``core_gate=True`` (default since round 5, VERDICT r4 item 4) applies
    the published DBSCAN semantics exactly at pixel resolution: a keypoint
    is **core** iff ≥ ``min_samples`` keypoints (self included) lie within
    L2 distance ``eps_px`` in the reference's rendered-pixel metric (an
    elliptical stencil in grid space — one static conv); clusters are the
    connected components of core points under exact L2 eps-adjacency
    (:func:`_cluster_core_labels` — min-propagation whose per-round
    neighborhood is the whole eps ellipse); non-core keypoints join a
    core's cluster within exact L2 eps reach or are noise.  This removes
    both divergence classes vs DBSCAN that the pre-round-5 formulation had
    (lone bridge points chaining clusters, and L∞ box-corner linking at up
    to eps·√2) — quantified against the clean-room oracle in
    ``tests/oracles.py::oracle_dbscan`` / ``tests/test_image_path.py``.
    The single remaining deliberate deviation (documented in
    VALIDATION.md): when several clusters reach the same border pixel it
    takes the *lowest* cluster id (DBSCAN: scan order) — affects only
    which bbox a shared border lands in, never cluster counts.

    ``core_gate=False`` keeps the round-1..4 formulation (box dilation +
    post-hoc min_samples), retained for comparison and for callers that
    calibrated against it.
    """
    if keypoint_mask is None:
        mask = img.db > img.vmin  # the "keypoints": pixels visible after the cut
    else:
        mask = keypoint_mask

    # grid pixel sizes in the reference's rendered-pixel metric
    px_t = img.hop_sec * _REF_PX_PER_SEC
    px_f = img.hz_per_bin * _REF_PX_PER_HZ

    if core_gate:
        # DBSCAN core rule, exact at pixel resolution: neighbors within an
        # L2 eps ellipse (reference-px metric), self included
        spans = _ellipse_spans(eps_px, px_f, px_t)
        neigh = _conv_count(mask, _ellipse_kernel(eps_px, px_f, px_t))
        core = mask & (neigh >= min_samples - 0.5)
        labels = _cluster_core_labels(core, spans)
    else:
        # legacy eps/2 box radii (the round-1..4 dilation window)
        eps_t_sec = (eps_px / 2.0) / _REF_PX_PER_SEC
        eps_f_hz = (eps_px / 2.0) / _REF_PX_PER_HZ
        rt = max(int(round(eps_t_sec / img.hop_sec)), 0)
        rf = max(int(round(eps_f_hz / img.hz_per_bin)), 0)
        core = mask
        dilated = jax.lax.reduce_window(
            mask,
            False,
            jax.lax.bitwise_or,
            window_dimensions=(2 * rf + 1, 2 * rt + 1),
            window_strides=(1, 1),
            padding="SAME",
        )
        labels = _connected_components(dilated)
    h, w = mask.shape
    hw = h * w

    # compact cluster ids from root pixels
    flat_lab = labels.reshape(-1)
    own = jnp.arange(hw, dtype=jnp.int32)
    is_root = flat_lab == own
    comp_at_root = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    root_table = jnp.where(is_root, comp_at_root, cap).astype(jnp.int32)
    root_table = jnp.concatenate([root_table, jnp.asarray([cap], jnp.int32)])
    comp = root_table[jnp.minimum(flat_lab, hw)]  # (hw,) compact id or cap
    comp = jnp.minimum(comp, cap)  # clusters beyond capacity land in the drop bucket

    # member pixels = original (pre-dilation) keypoints
    if core_gate:
        # border keypoints (mask & ~core) join the lowest-id cluster with a
        # core inside their exact L2 eps ellipse; keypoints with no core
        # within reach are DBSCAN noise.  (DBSCAN assigns shared borders by
        # scan order instead of lowest id — same count-level result.)
        comp2d = comp.reshape(h, w).astype(jnp.int32)
        core_comp = jnp.where(core, comp2d, cap)
        near = _ellipse_min(core_comp, spans, cap)
        assign = jnp.where(core, comp2d, near).reshape(-1)
        member = mask.reshape(-1) & (assign < cap)
        seg = jnp.where(member, assign, cap)
    else:
        member = mask.reshape(-1)
        seg = jnp.where(member, comp, cap)
    n_points = jax.ops.segment_sum(member.astype(jnp.int32), seg, num_segments=cap + 1)[:cap]

    fi = (own // w).astype(jnp.int32)
    ti = (own % w).astype(jnp.int32)
    t_min = jax.ops.segment_min(jnp.where(member, ti, w), seg, num_segments=cap + 1)[:cap]
    t_max = jax.ops.segment_max(jnp.where(member, ti, -1), seg, num_segments=cap + 1)[:cap]
    f_min = jax.ops.segment_min(jnp.where(member, fi, h), seg, num_segments=cap + 1)[:cap]
    f_max = jax.ops.segment_max(jnp.where(member, fi, -1), seg, num_segments=cap + 1)[:cap]

    # DBSCAN noise rule.  Under core gating the min_samples semantics live
    # entirely in the CORE rule: a cluster is exactly one core component
    # (always ≥ 1 member — its root core), and DBSCAN's cluster count is
    # the number of core components regardless of how shared border points
    # are divided — a post-hoc size filter could wrongly drop a cluster
    # whose borders a lower-id neighbor claimed.  The legacy path keeps
    # the post-hoc filter (its linking has no core rule).
    valid = n_points >= (1 if core_gate else min_samples)
    # critical: bbox duration >= 0.5 s (5 reference px), evaluated in seconds
    min_dur_sec = critical_min_width_px / _REF_PX_PER_SEC
    width_sec = (t_max - t_min).astype(jnp.float32) * img.hop_sec
    critical = valid & (width_sec >= min_dur_sec)

    n_clusters = jnp.sum(valid.astype(jnp.int32))
    n_crit = jnp.sum(critical.astype(jnp.int32))
    # background carries label HW (never a root), so is_root counts exactly
    # the labeled components; any beyond cap landed in the drop bucket
    n_components_total = jnp.sum(is_root.astype(jnp.int32))

    return ImageBursts(
        t_min=t_min,
        t_max=t_max,
        f_min=f_min,
        f_max=f_max,
        n_points=jnp.where(valid, n_points, 0),
        critical=critical,
        count=n_clusters,
        n_critical=n_crit,
        n_non_critical=n_clusters - n_crit,
        overflow=n_components_total > cap,
    )


def detect_and_cluster_bursts(
    audio: jnp.ndarray,
    fs: float,
    n_fft: int = 2048,
    spec_cut_factor: float = 8.0,
    eps_px: float = 30.0,
    min_samples: int = 5,
    cap: int = 64,
    keypoint_mode: str = "threshold",
    core_gate: bool = True,
) -> Tuple[SpectrogramImage, ImageBursts]:
    """Segment-level entry point mirroring the reference call pair
    ``plot_spectrogram`` + ``detect_and_cluster_bursts``
    (prime_detection.py:179-189).

    ``keypoint_mode``: "threshold" (default — above-cut pixels) or
    "corner" (Harris corner keypoints, the ORB-like mode).
    ``core_gate`` passes through to :func:`cluster_bursts`."""
    img = spectrogram_image(audio, fs, n_fft, spec_cut_factor)
    kp = corner_keypoints(img) if keypoint_mode == "corner" else None
    bursts = cluster_bursts(
        img, eps_px=eps_px, min_samples=min_samples, cap=cap, keypoint_mask=kp,
        core_gate=core_gate,
    )
    return img, bursts
