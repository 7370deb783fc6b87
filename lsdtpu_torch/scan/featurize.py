"""Per-frame scan featurization on tensors (counterpart of
lsdtpu/scan/featurize.py).

Reference: LSD/myRDP.cpp.  Three departures from the C structure, all
semantics-preserving (as in the reference package):

1. Level-synchronous RDP: every inter-marker interval evaluates its
   split at once, round after round, until a fixpoint.  Recursion order
   does not change the final split set (each interval's decision depends
   only on its endpoints).  The rounds are a Python loop on a device
   ``.any()`` - one host sync per round (over all lanes of a batch).
2. Rotated index space: only cell 0 can wrap around the scan
   (myRDP.cpp:326-329); rotating indices by that cell's start makes
   every cell a contiguous run.
3. Analytic pixel clouds: a segment's pixel set is a closed-form
   function of its endpoints (major-axis stepping + C rounding), so it
   is evaluated on a fixed (segment, step) grid and compacted.  The
   out-of-bounds (0,0) sentinel and the x==0/y==0 drop quirk are kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.runtime import trace

# range-dependent gap thresholds (reference: getThresholdDeltaDist,
# LSD/myRDP.cpp:347-368)
_GAP_BOUNDS = np.array([0.3, 0.5, 0.8, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
_GAP_VALUES = np.array([0.02, 0.05, 0.11, 0.17, 0.6, 0.7, 0.85, 0.9,
                        1.0, 1.1])


@dataclasses.dataclass
class ScanFeatures:
    """Fixed-shape scan features (the structFeatureScan equivalent); the
    leading axes ``...`` are lanes (none for one scan)."""

    lines: torch.Tensor        # (..., S, 10) linesInfo rows, scan-local px
    lines_mask: torch.Tensor   # (..., S) bool, prefix
    pixels: torch.Tensor       # (..., P, 2) int32 scan-local pixel coords
    pixels_mask: torch.Tensor  # (..., P) bool, prefix
    lidar_pos: torch.Tensor    # (..., 2) scan-local pixel coords (integral)
    n_pixels: torch.Tensor     # (...) int32 raw pixel count
    overflow: torch.Tensor     # (...) bool: a cap truncated lines/pixels


def gap_threshold(ranges):
    """Piecewise-constant gap threshold as a select chain (the exact
    table value for each range)."""
    t = torch.full_like(ranges, float(_GAP_VALUES[0]))
    for b, v in zip(_GAP_BOUNDS, _GAP_VALUES[1:]):
        t = torch.where(ranges > float(b), float(v), t)
    return t


def _prev_set_index(mask):
    """For each i, the largest j < i with mask[..., j], else -1 (dense
    (..., N, N) masked row max; each lane on its own)."""
    N = mask.shape[-1]
    idx = torch.arange(N, device=mask.device)
    cand = torch.where(mask[..., None, :] & (idx[None, :] < idx[:, None]),
                       idx[None, :], -1)
    return cand.amax(dim=-1)


def _next_set_index(mask):
    """For each i, the smallest j >= i with mask[..., j], else N."""
    N = mask.shape[-1]
    idx = torch.arange(N, device=mask.device)
    cand = torch.where(mask[..., None, :] & (idx[None, :] >= idx[:, None]),
                       idx[None, :], N)
    return cand.amin(dim=-1)


def _take(x, i):
    """x[..., i] per lane: the last axis of x gathered at the index
    tensor i, which has x's leading (lane) axes."""
    return torch.gather(x, -1, i)


def _segment_cells(ranges, xs, ys, valid, n, least_point: int):
    """Gap clustering (reference: RegionSegmentation, myRDP.cpp:274-345).

    Each lane (leading axes) on its own: ranges/xs/ys/valid (..., N), n
    (...).  Returns (cell_id, rot): cell_id[i] is the id (end index) of
    the kept cell containing point i, or N; rot is the rotation offset
    that makes every cell contiguous.  Wrap quirk: if the last point
    connects back to the first, the trailing run overwrites the FIRST
    KEPT cell's start (myRDP.cpp:326-329)."""
    N = ranges.shape[-1]
    idx = torch.arange(N, device=ranges.device)
    n = n[..., None]
    # padding slot N-1 points one past the end; the reference package's
    # gather clamps it (its delta is masked by `valid` anyway)
    nxt = torch.where(idx == n - 1, 0, idx + 1).clamp(max=N - 1)
    nxt = nxt.expand(ranges.shape)
    dx = xs - _take(xs, nxt)
    dy = ys - _take(ys, nxt)
    delta = geo.sqrt(dx * dx + dy * dy)
    brk = (delta > gap_threshold(ranges)) & valid

    # cell k ends at break e_k and starts after the previous break;
    # kept iff (e_k - start_k) >= least_point (myRDP.cpp:317-318)
    start = _prev_set_index(brk) + 1
    keep_end = brk & ((idx - start) >= least_point)

    next_brk = _next_set_index(brk)
    nb = next_brk.clamp(0, N - 1)
    cell_id = torch.where(valid & (next_brk < N) & _take(keep_end, nb),
                          next_brk, N)

    last = (n - 1).clamp(0, N - 1)
    last_brk = torch.where(brk, idx, -1).amax(-1, keepdim=True)
    first_kept_end = torch.where(keep_end, idx, N).amin(-1, keepdim=True)
    wraps = (last_brk >= 0) & ~_take(brk, last) & (first_kept_end < N)
    rot = torch.where(wraps, last_brk + 1, 0)
    merged = wraps & valid & ((idx >= rot) | (idx <= first_kept_end))
    cell_id = torch.where(merged, first_kept_end, cell_id)
    return cell_id, rot[..., 0]


def _point_line_distance(px, py, ax, ay, bx, by):
    """|k*x - y + d| / sqrt(k^2+1) with k from A->B (myRDP.cpp:241-259):
    the reference's slope-intercept form, so borderline splits agree."""
    k = (by - ay) / (bx - ax)
    d = by - k * bx
    return torch.abs(k * px - py + d) / geo.sqrt(k * k + 1.0)


def _rdp_rounds(gwx, gwy, ranges_r, marker, interior_ok, thre_line: float,
                max_rounds: int):
    """Level-synchronous RDP to fixpoint (one host sync per round).

    gwx/gwy: world coords in rotated order; ranges_r: ranges in rotated
    order; marker: initial markers (cell starts+ends); interior_ok[i]:
    point may become a split (strictly inside a cell).  Each lane
    (leading axes) on its own; the rounds run until no lane changed, so
    their number is the largest over the lanes.  A lane at its fixpoint
    adds no marker in a later round (a new marker needs a segment over
    its threshold, and its segments no longer change), so its result is
    the one it gets alone.  Counts the rounds it runs (host reads) in
    ``_rdp_rounds.rounds``, the tracer's ``host_reads.featurize.rdp``."""
    N = gwx.shape[-1]
    idx = torch.arange(N, device=gwx.device)
    thre = torch.where(ranges_r > 9.0, ranges_r * thre_line, thre_line)
    neg_inf = torch.tensor(-torch.inf, dtype=gwx.dtype, device=gwx.device)
    for _ in range(max_rounds):
        _rdp_rounds.rounds += 1
        prev = _prev_set_index(marker)             # marker strictly before i
        nxt = _next_set_index(marker)              # marker at/after i
        interior = interior_ok & ~marker & (prev >= 0) & (nxt < N)
        a = prev.clamp(0, N - 1)
        b = nxt.clamp(0, N - 1)
        dist = _point_line_distance(gwx, gwy, _take(gwx, a), _take(gwy, a),
                                    _take(gwx, b), _take(gwy, b))
        dist = torch.where(interior & ~torch.isnan(dist), dist, neg_inf)
        # segmented first-argmax keyed by interval start (the reference
        # keeps the first strict maximum, myRDP.cpp:247-251): interior
        # points of one interval share the same prev marker `a`
        mate = interior[..., :, None] & interior[..., None, :] & \
            (a[..., :, None] == a[..., None, :])
        seg_max = torch.where(mate, dist[..., None, :], neg_inf).amax(dim=-1)
        is_max = interior & (dist == seg_max) & torch.isfinite(dist)
        first_max = torch.where(mate & is_max[..., None, :], idx[None, :],
                                N).amin(dim=-1)
        new_marker = is_max & (idx == first_max) & (seg_max > thre)
        changed = bool((new_marker & ~marker).any())
        marker = marker | new_marker
        if not changed:
            break
    return marker


_rdp_rounds.rounds = 0
trace.register_counter("host_reads.featurize.rdp",
                       lambda: _rdp_rounds.rounds)


def _segment_pixels(x1, y1, x2, y2, x_lim, y_lim, t):
    """Analytic pixel clouds of segments on a fixed step grid (reference
    rasterizer: myRDP.cpp:96-161).  x1..y2: (..., S, 1); x_lim, y_lim:
    (..., 1, 1); t: (T,) step indices.  Returns (xx, yy, valid,
    n_steps); n_steps is each segment's true major-axis length, so
    callers can flag truncation."""
    xr = torch.abs(x2 - x1)
    yr = torch.abs(y2 - y1)
    x_low = torch.floor(torch.minimum(x1, x2))
    x_high = torch.ceil(torch.maximum(x1, x2))
    y_low = torch.floor(torch.minimum(y1, y2))
    y_high = torch.ceil(torch.maximum(y1, y2))
    xx_len = x_high - x_low + 1
    yy_len = y_high - y_low + 1
    k = (y2 - y1) / (x2 - x1)
    x_major = xr > yr
    # x-major: xx = xLow + t, yy = round((xx-x1)*k + y1)
    xxa = x_low + t
    yya = geo.c_round((xxa - x1) * k + y1)
    # y-major: yy = yLow + t, xx = round((yy-y1)/k + x1)
    yyb = y_low + t
    xxb = geo.c_round((yyb - y1) / k + x1)
    xx = torch.where(x_major, xxa, xxb)
    yy = torch.where(x_major, yya, yyb)
    n_steps = torch.where(x_major, xx_len, yy_len)
    in_grid = (xx >= 0) & (xx < x_lim) & (yy >= 0) & (yy < y_lim)
    xx = torch.where(in_grid, xx, 0.0)
    yy = torch.where(in_grid, yy, 0.0)
    valid = (t < n_steps) & (xx != 0) & (yy != 0)   # (0,0)/axis sentinel drop
    return xx, yy, valid, n_steps[..., 0]


def featurize(ranges, angles, valid, n, resol, ori_x, ori_y,
              least_point: int = 3, thre_line: float = 0.08,
              least_dist: float = 0.5, max_lines: int = 64,
              max_pixels: int = 2048, max_steps: int = 512) -> ScanFeatures:
    """Scan featurization: clustering + RDP + segment extraction + pixel
    cloud (reference: FeatureScan, myRDP.cpp:9-185).

    ranges/angles: (..., N) padded polar points (valid points first);
    valid: (..., N) bool; n: (...) integer counts; resol/ori_x/ori_y:
    (...) tensors of the working dtype, or (B,) ones that broadcast
    against the last lane axis.  The leading axes are lanes, any number
    of them (none for one scan, (B,) for a batch, (F,) or (F, B) for
    frames featurized together: runtime/loop.rollout's strategies), each
    featurized on its own and bit for bit as alone; the outputs carry
    the same leading axes.  Runs on the device of its inputs."""
    N = ranges.shape[-1]
    lanes = tuple(ranges.shape[:-1])
    dtype = ranges.dtype
    dev = ranges.device
    idx = torch.arange(N, device=dev)
    n = torch.as_tensor(n, device=dev).to(torch.int64).expand(lanes)
    nN = torch.full(lanes + (1,), N, device=dev)
    resol, ori_x, ori_y = (torch.as_tensor(v, device=dev)[..., None]
                           for v in (resol, ori_x, ori_y))

    xs = ranges * torch.cos(angles)
    ys = ranges * torch.sin(angles)
    cell_id, rot = _segment_cells(ranges, xs, ys, valid, n, least_point)

    # rotate index space so every cell is contiguous (quirk 2 above)
    r_abs = torch.remainder(idx + rot[..., None], n.clamp(min=1)[..., None])
    r_abs = torch.where(idx < n[..., None], r_abs, idx)
    cell_id_r = _take(cell_id, r_abs)
    in_cell_r = cell_id_r < N
    gwx = _take(xs, r_abs)
    gwy = _take(ys, r_abs)
    rng_r = _take(ranges, r_abs)

    # cell starts/ends in rotated space: cell_id run boundaries
    prev_id = torch.cat([nN, cell_id_r[..., :-1]], -1)
    next_id = torch.cat([cell_id_r[..., 1:], nN], -1)
    cell_start_r = in_cell_r & (cell_id_r != prev_id)
    cell_end_r = in_cell_r & (cell_id_r != next_id)
    marker0 = cell_start_r | cell_end_r
    interior_ok = in_cell_r & ~cell_start_r & ~cell_end_r

    marker = _rdp_rounds(gwx, gwy, rng_r, marker0, interior_ok, thre_line,
                         max_rounds=N)

    # --- segment extraction (myRDP.cpp:45-177) ---
    # pixel-space projection (scanPose == 0 in the reference's main loop)
    gx = torch.floor((xs - ori_x) / resol)
    gy = torch.floor((ys - ori_y) / resol)
    min_x = torch.where(valid, gx, torch.inf).amin(-1, keepdim=True)
    max_x = torch.where(valid, gx, -torch.inf).amax(-1, keepdim=True)
    min_y = torch.where(valid, gy, torch.inf).amin(-1, keepdim=True)
    max_y = torch.where(valid, gy, -torch.inf).amax(-1, keepdim=True)
    x_lim = torch.ceil(max_x - min_x)
    y_lim = torch.ceil(max_y - min_y)
    lidar_pos = torch.cat([torch.floor((0.0 - ori_x) / resol - min_x),
                           torch.floor((0.0 - ori_y) / resol - min_y)], -1)

    gx_r = _take(gx, r_abs)
    gy_r = _take(gy, r_abs)
    at_after = _next_set_index(marker)
    nxt_marker = torch.cat([at_after[..., 1:], nN], -1)   # strictly after
    b = nxt_marker.clamp(0, N - 1)
    seg_from = marker & ~cell_end_r & (nxt_marker < N) & in_cell_r
    ax_, ay_ = gx_r, gy_r
    bx_, by_ = _take(gx_r, b), _take(gy_r, b)
    seg_len = geo.sqrt((ax_ - bx_) ** 2 + (ay_ - by_) ** 2)
    seg_keep = seg_from & (seg_len >= least_dist / resol)

    ends = torch.stack([ax_ - min_x, ay_ - min_y, bx_ - min_x, by_ - min_y],
                       dim=-1)
    seg_ends, lines_mask, n_segs = geo.masked_compact(ends, seg_keep,
                                                      max_lines)
    lines = geo.lines_info_from_endpoints(
        seg_ends[..., 0], seg_ends[..., 1], seg_ends[..., 2],
        seg_ends[..., 3])
    # keep padded rows harmless (k would be 0/0 = NaN otherwise)
    lines = torch.where(lines_mask[..., None], lines, 0.0)

    # --- pixel cloud on the (S, T) grid, then compact ---
    t = torch.arange(max_steps, dtype=dtype, device=dev)
    e = seg_ends[..., None]
    px_x, px_y, px_ok, n_steps = _segment_pixels(
        e[..., 0, :], e[..., 1, :], e[..., 2, :], e[..., 3, :],
        x_lim[..., None], y_lim[..., None], t)
    px_ok = px_ok & lines_mask[..., None]
    pix, pixels_mask, n_pix = geo.masked_compact_rows(
        torch.stack([px_x, px_y], dim=-1), px_ok, max_pixels)
    # a live segment longer than the step grid would rasterize only its
    # first max_steps pixels - flag it, never truncate silently
    step_overflow = (lines_mask & (n_steps > max_steps)).any(-1)
    return ScanFeatures(
        lines=lines, lines_mask=lines_mask,
        pixels=pix.to(torch.int32), pixels_mask=pixels_mask,
        lidar_pos=lidar_pos, n_pixels=n_pix.to(torch.int32),
        overflow=(n_segs > max_lines) | (n_pix > max_pixels) | step_overflow)
