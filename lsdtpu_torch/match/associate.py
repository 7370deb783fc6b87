"""Dense scan-to-map feature association on tensors (counterpart of
lsdtpu/match/associate.py).

Reference: LSD/myFA.cpp.  The (scan line, map line, 4 endpoint
alignments) hypothesis space is one dense (S, M, 4) tensor: the gates
(line length ratio, HMM distance; myFA.cpp:29-41, 330) are evaluated
for all hypotheses at once, survivors are compacted in order into a
fixed (K,) buffer, each candidate is scored against the mapCache prior
by the CalcScore kernel (ops/score.py; myFA.cpp:357-396), and fusion is
the reference's inverse-square-score weighted mean (myFA.cpp:159-171).

Scoring is split into additive partials (sum_d, n_valid, sum_far,
n_far) and one elementwise ``finalize_scores``; counts are exact
int32.  The pruned path bounds every live candidate's score from a
coarse min-pooled field and runs the exact kernel over the survivor
index list only - one kernel launch per frame either way.  The field
may be stored compressed (``quantize_cache``: bf16, or u16/u8 codes the
kernel dequantizes), and the plain path may score a window of it
around the last pose (``score_candidates(window=...)``).

Every function takes leading lane axes ``...``: none for one frame,
(B,) for a batch of B robots or sequences.  Each lane's gates,
compactions and reductions run along its own axes, never across lanes;
``rows``/``cols`` are then (B,) tensors (each lane's true map extent on
a common canvas), and a batch scores all its lanes in one launch of the
lane-batched kernel (``ops/score.py:score_partials_batched``).  A batch
takes the pruned path whenever pruning is on and never the window, as
the reference package's vmapped steps do (``runtime/loop.batched_cfg``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.ops.score import TOP_CODE, U8_MAX, U16_MAX, cells, \
    dequant, gather_cells, score_partials, score_partials_batched
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.collectives import Axis


def quantize_cache(map_cache, cache_dtype: str, z_occ_max_dis: float = 1.0,
                   float_dtype=torch.float32):
    """The distance field as the scorer reads it (the reference package's
    quantize_cache, code for code):

      "f32"  - the float field at ``float_dtype`` (exact; also "default")
      "bf16" - bfloat16 (2 B/cell, ~3 decimal digits)
      "u16"  - fixed-point round(d / z * 65535) (2 B/cell, z/65535 steps)
      "u8"   - fixed-point round(d / z * 255) (1 B/cell, z/255 steps)

    Cells at/above the cap keep the at-cap predicate (CalcScore,
    myFA.cpp:381): the top code in the fixed-point modes, and in bf16 the
    smallest bf16 >= z when bf16(z) rounds down (z = 0.7 -> 0.69921875
    would fail v >= z).  The codes are computed in float32 (u16 codes
    are stored through int16: PyTorch converts few types to uint16)."""
    if cache_dtype in ("f32", "default"):
        return map_cache.to(float_dtype)
    c = map_cache.to(torch.float32)
    z32 = torch.tensor(z_occ_max_dis, dtype=torch.float32, device=c.device)
    if cache_dtype == "bf16":
        bz = z32.to(torch.bfloat16)
        if not bool(bz.to(torch.float32) >= z32):
            # the next bf16 up: one more in the bit pattern of a positive
            bz = (bz.view(torch.int16) + 1).view(torch.bfloat16)
        return torch.where(c >= z32, bz, c.to(torch.bfloat16))
    if cache_dtype == "u16":
        q = torch.round(torch.clamp(c / z32, 0.0, 1.0) * float(U16_MAX))
        return q.to(torch.int32).to(torch.int16).view(torch.uint16)
    if cache_dtype == "u8":
        q = torch.round(torch.clamp(c / z32, 0.0, 1.0) * float(U8_MAX))
        return q.to(torch.uint8)
    raise ValueError(f"unknown cache_dtype {cache_dtype!r}")



@dataclasses.dataclass
class Candidates:
    """Fixed-size compacted candidate set (leading lane axes ``...``)."""

    ca: torch.Tensor        # (..., K) cos(angDiff)
    sa: torch.Tensor        # (..., K) sin(angDiff)
    sx: torch.Tensor        # (..., K) scan base point
    sy: torch.Tensor
    mx: torch.Tensor        # (..., K) map base point
    my: torch.Tensor
    pose: torch.Tensor      # (..., K, 3) transformed lidar pose
                            # (x, y, angDiff)
    mask: torch.Tensor      # (..., K) bool, prefix
    count: torch.Tensor     # (...) int64 pre-truncation count (overflow)

    def feats(self):
        """(..., 6, K) contiguous [ca, sa, sx, sy, mx, my], the kernel
        layout."""
        return torch.stack([self.ca, self.sa, self.sx, self.sy, self.mx,
                            self.my], -2).contiguous()


def generate_candidates(scan_lines, scan_mask, map_lines, map_mask,
                        lidar_pose, last_pose, max_candidates: int,
                        ignore_scan_length: float = 40.0,
                        scan_to_map_diff: float = 0.35,
                        max_esti_dist: float = 60.0) -> Candidates:
    """Gate + compact the (S, M, 4) hypothesis tensor of each lane
    (reference: myFA.cpp:29-41 length gates, myFA.cpp:186-235 alignment
    hypotheses, myFA.cpp:330 HMM gate).  scan_lines (..., S, 10),
    scan_mask (..., S), map_lines (..., M, 10), map_mask (..., M),
    lidar_pose (..., 2), last_pose (..., 3)."""
    S = scan_lines.shape[-2]
    M = map_lines.shape[-2]
    lanes = tuple(scan_lines.shape[:-2])
    dev = scan_lines.device

    s_len = scan_lines[..., geo.LEN]
    m_len = map_lines[..., geo.LEN]
    len_diff = s_len * scan_to_map_diff
    gate_len = (scan_mask & (s_len >= ignore_scan_length))[..., :, None] & \
        map_mask[..., None, :] & \
        (m_len[..., None, :] >= (s_len - len_diff)[..., :, None]) & \
        (m_len[..., None, :] <= (s_len + len_diff)[..., :, None])  # (S, M)

    def dirs(lines):
        fwd = geo.normalized_line_direction(
            lines[..., geo.X1], lines[..., geo.Y1],
            lines[..., geo.X2], lines[..., geo.Y2])
        rev = geo.normalized_line_direction(
            lines[..., geo.X2], lines[..., geo.Y2],
            lines[..., geo.X1], lines[..., geo.Y1])
        return fwd, rev

    s_fwd, s_rev = dirs(scan_lines)
    m_fwd, m_rev = dirs(map_lines)

    # hypothesis layout h=0..3 (myFA.cpp:194-235):
    #   h0: map fwd, scan fwd   h1: map fwd, scan rev
    #   h2: map rev, scan fwd   h3: map rev, scan rev
    X1, Y1, X2, Y2 = geo.X1, geo.Y1, geo.X2, geo.Y2
    m_ang = torch.stack([m_fwd, m_fwd, m_rev, m_rev], -1)        # (M, 4)
    m_bx = map_lines[..., [X1, X1, X2, X2]]
    m_by = map_lines[..., [Y1, Y1, Y2, Y2]]
    s_ang = torch.stack([s_fwd, s_rev, s_fwd, s_rev], -1)        # (S, 4)
    s_bx = scan_lines[..., [X1, X2, X1, X2]]
    s_by = scan_lines[..., [Y1, Y2, Y1, Y2]]

    ang_diff = m_ang[..., None, :, :] - s_ang[..., :, None, :]   # (S, M, 4)
    shape = ang_diff.shape
    ca = geo.cosd(ang_diff)
    sa = geo.sind(ang_diff)
    sx = s_bx[..., :, None, :].expand(shape)
    sy = s_by[..., :, None, :].expand(shape)
    mx = m_bx[..., None, :, :].expand(shape)
    my = m_by[..., None, :, :].expand(shape)

    def lane3(v):                   # a per-lane scalar against (S, M, 4)
        return v[..., None, None, None]

    lx, ly = lane3(lidar_pose[..., 0]), lane3(lidar_pose[..., 1])
    rlx = (lx - sx) * ca - (ly - sy) * sa + mx
    rly = (lx - sx) * sa + (ly - sy) * ca + my
    first = lane3(last_pose[..., 0] == -1)
    # the reference gates on sqrt(d2) < maxEstiDist (myFA.cpp:330), in
    # its accept form: a NaN distance fails the gate
    d = geo.sqrt((rlx - lane3(last_pose[..., 0])) ** 2
                 + (rly - lane3(last_pose[..., 1])) ** 2)
    gate = gate_len[..., None] & (first | (d < max_esti_dist))

    # compact survivor INDICES, then gather the features for the K slots;
    # padded slots are zero (degenerate padded lines give NaN directions,
    # and a NaN pose row would poison the weighted-mean sums)
    L = S * M * 4
    comp_idx, mask, count = geo.masked_compact(
        torch.arange(L, device=dev).expand(lanes + (L,)),
        gate.reshape(lanes + (L,)), max_candidates)

    def take(a):
        return torch.where(mask, torch.gather(a.reshape(lanes + (L,)), -1,
                                              comp_idx), 0.0)

    return Candidates(
        ca=take(ca), sa=take(sa), sx=take(sx), sy=take(sy),
        mx=take(mx), my=take(my),
        pose=torch.stack([take(rlx), take(rly),
                          torch.where(mask, geo.wrap_deg(take(ang_diff)),
                                      0.0)], -1),
        mask=mask, count=count)


def head(cand: Candidates, k: int) -> Candidates:
    """The first ``k`` slots of each lane (contiguous; ``count`` stays
    the raw total)."""
    return Candidates(*(t[..., :k].contiguous() for t in (
        cand.ca, cand.sa, cand.sx, cand.sy, cand.mx, cand.my)),
        pose=cand.pose[..., :k, :].contiguous(), mask=cand.mask[..., :k],
        count=cand.count)


def keep_head(cand: Candidates, k: int, whole) -> Candidates:
    """``cand`` with the slots from ``k`` on masked out in every lane but
    those where ``whole`` ((...) bool) is set: those lanes' candidates
    past the head are neither scored nor fused."""
    K = cand.mask.shape[-1]
    keep = whole[..., None] | (torch.arange(K, device=cand.mask.device) < k)
    return dataclasses.replace(cand, mask=cand.mask & keep)


def _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis):
    if obstacle_min_dist is None:
        return z_occ_max_dis
    if not 0.0 < obstacle_min_dist <= z_occ_max_dis:
        raise ValueError(
            f"obstacle_min_dist={obstacle_min_dist} must be in "
            f"(0, z_occ_max_dis={z_occ_max_dis}]")
    return obstacle_min_dist


def pixel_args(pixels, pixels_mask, dt):
    """(px, py, n_pix) of each lane in the kernel layout; the live pixels
    must be a prefix (featurize's compaction produces one)."""
    return (pixels[..., 0].to(dt).contiguous(),
            pixels[..., 1].to(dt).contiguous(),
            pixels_mask.sum(-1).to(torch.int32))


def _lane_partials(feats, idx, n_cand, px, py, n_pix, cache, rows, cols,
                   z_occ_max_dis, max_dist_penalty, omd, row0: int = 0):
    """The partials of every lane of a batch over its whole field (or over
    the row block [row0, row0 + H) of every lane's field): one launch of
    the lane-batched kernel (rows/cols (B,) tensors)."""
    B = feats.shape[0]
    dev = feats.device

    def lane_ints(v):
        return torch.as_tensor(v, device=dev).to(torch.int32).expand(
            B).contiguous()

    return score_partials_batched(
        feats, idx, n_cand.contiguous(), px, py, n_pix.contiguous(),
        cache.contiguous(), lane_ints(rows), lane_ints(cols), z_occ_max_dis,
        max_dist_penalty, omd, row0=row0)


def score_candidates_partial(cand: Candidates, pixels, pixels_mask,
                             cache_block, row0, rows, cols,
                             z_occ_max_dis: float = 1.0,
                             max_dist_penalty: float = 10.0,
                             obstacle_min_dist: float = None, col0: int = 0):
    """Per-candidate additive partials (sum_d, n_valid, sum_far, n_far)
    over the field cells [row0, row0 + block_h) x [col0, col0 + block_w)
    of a rows x cols map (cache_block, a row-major view; the windowed
    scorer passes a window of the field); the counts are exact int32.
    sum_far/n_far aggregate the in-map pixels whose field distance is
    >= obstacle_min_dist (default: the cap, the reference's sumMaxDist
    population, myFA.cpp:381).  With a lane axis (cand (B, K), rows/cols
    (B,)) cache_block is the (B, H, W) canvas, or with ``row0`` every
    lane's rows [row0, row0 + H) (a map-block-sharded rank's block; the
    window's col0 is not taken).

    PRECONDITION: pixels_mask is a prefix mask.  One kernel launch,
    which reads the live candidate and pixel counts on the device."""
    dt = cand.ca.dtype
    omd = _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis)
    K = cand.ca.shape[-1]
    px, py, n_pix = pixel_args(pixels, pixels_mask, dt)
    n_cand = cand.count.clamp(0, K).to(torch.int32)
    if cand.ca.dim() > 1:
        if col0:
            raise ValueError("a batch scores whole rows of each lane's "
                             "field (col0 = 0)")
        return _lane_partials(cand.feats(), None, n_cand, px, py, n_pix,
                              cache_block, rows, cols, z_occ_max_dis,
                              max_dist_penalty, omd, row0=int(row0))
    return score_partials(
        cand.feats(), None, n_cand, px, py, n_pix, cache_block, int(row0),
        int(rows), int(cols), z_occ_max_dis, max_dist_penalty, omd,
        col0=int(col0))


def score_candidates(cand: Candidates, pixels, pixels_mask, map_cache,
                     rows=None, cols=None,
                     z_occ_max_dis: float = 1.0,
                     max_dist_penalty: float = 10.0,
                     valid_ratio: float = 0.7,
                     dynamic_chunks: bool = True,
                     obstacle_tolerance: float = 0.0,
                     obstacle_min_dist: float = None,
                     coarse=None,
                     prune_accept: float = None,
                     prune_block: int = 16,
                     prune_group: int = 16,
                     prune_min_live: int = 0,
                     window: int = 0,
                     window_center=None,
                     scan_radius=None,
                     window_gate: float = 60.0) -> torch.Tensor:
    """Score every candidate against the mapCache prior (reference:
    CalcScore, myFA.cpp:357-396).  Returns (..., K) scores, inf where
    gated or invalid.

    With ``coarse`` (from coarse_field), ``prune_accept`` and
    ``dynamic_chunks`` (the reference package's gate for pruning), the
    pruned scorer runs when the live count reaches ``prune_min_live``
    (0 = always) - one host read of cand.count per frame; the plain
    path otherwise.  Both give the same score to every candidate that
    can be accepted.  PRECONDITION: pixels_mask is a prefix mask.

    window > 0 (config match.score_window) with window_center
    (last_pose[:2]) and scan_radius (the largest live-pixel distance
    from the rounded lidar pose): the plain path gathers from a
    (window, window) view of the field around the centre instead of the
    whole map, with identical outputs: every candidate passed the HMM
    gate (its transformed lidar pose is within window_gate of the
    centre, myFA.cpp:330) and rigidity keeps each pixel within
    scan_radius of that pose, so the window is taken only when
    window_gate + scan_radius + 2 fits in half the window less 2 px
    (``fits``); relock frames fall back through the centre's -1
    sentinel.  The decision and the window's origin cost one host read
    per frame.

    With a lane axis (cand (B, K), map_cache the (B, H, W) canvas,
    rows/cols (B,)) neither host read is taken: prune_min_live must be 0
    and window 0 (``runtime/loop.batched_cfg``), and one launch scores
    every lane."""
    pruning = coarse is not None and prune_accept is not None and \
        dynamic_chunks
    if cand.ca.dim() > 1 and ((pruning and prune_min_live) or window):
        raise ValueError("a batch takes neither the pruning gate's nor the "
                         "window's host read: use runtime/loop.batched_cfg "
                         "(prune_min_live = 0, score_window = 0)")
    if pruning:
        if not prune_min_live or int(trace.host_read(
                "match.prune_gate", cand.count)) >= prune_min_live:
            return score_candidates_pruned(
                cand, pixels, pixels_mask, map_cache, coarse,
                rows=rows, cols=cols, z_occ_max_dis=z_occ_max_dis,
                max_dist_penalty=max_dist_penalty, valid_ratio=valid_ratio,
                obstacle_tolerance=obstacle_tolerance,
                obstacle_min_dist=obstacle_min_dist,
                prune_accept=prune_accept, prune_block=prune_block,
                prune_group=prune_group)
    pad_rows, pad_cols = map_cache.shape[-2:]
    rows = pad_rows if rows is None else rows
    cols = pad_cols if cols is None else cols
    dt = cand.ca.dtype
    block, row0, col0 = map_cache, 0, 0
    if (window and dynamic_chunks and window_center is not None
            and scan_radius is not None and pad_rows >= window
            and pad_cols >= window):
        fits, row0, col0 = window_origin(window, window_center, scan_radius,
                                         window_gate, pad_rows, pad_cols)
        if fits:
            block = map_cache[row0:row0 + window, col0:col0 + window]
        else:
            row0 = col0 = 0
    sum_d, n_valid, sum_far, n_far = score_candidates_partial(
        cand, pixels, pixels_mask, block, row0, rows, cols,
        z_occ_max_dis=z_occ_max_dis, max_dist_penalty=max_dist_penalty,
        obstacle_min_dist=obstacle_min_dist, col0=col0)
    return finalize_scores(cand, sum_d, n_valid, pixels_mask.sum(-1).to(dt),
                           sum_far=sum_far, n_far=n_far,
                           max_dist_penalty=max_dist_penalty,
                           valid_ratio=valid_ratio,
                           obstacle_tolerance=obstacle_tolerance)


def window_origin(window: int, window_center, scan_radius,
                  window_gate: float, pad_rows: int, pad_cols: int):
    """(fits, row0, col0) of the windowed scorer, one host read: fits is
    ``center_x != -1 and window_gate + scan_radius + 2 <= window // 2 - 2``
    (the coverage margin: |pixel - centre| < window_gate + scan_radius +
    0.5, with 2 px of slack), and the window's origin is the C-rounded
    centre less half the window, clipped to the field."""
    half = window // 2
    need = window_gate + scan_radius + 2.0
    fits = (window_center[0] != -1) & (need <= half - 2)
    wy0 = (geo.c_round(window_center[1]).to(torch.int64) - half).clamp(
        0, pad_rows - window)
    wx0 = (geo.c_round(window_center[0]).to(torch.int64) - half).clamp(
        0, pad_cols - window)
    f, r0, c0 = trace.host_read(
        "match.window", torch.stack([fits.to(torch.int64), wy0, wx0])).tolist()
    return bool(f), r0, c0


def _same_pads(n: int, window: int, stride: int):
    """XLA "SAME" padding (lo, hi) of one dimension."""
    out = -(-n // stride)
    total = max(0, (out - 1) * stride + window - n)
    return total // 2, total - total // 2


def coarse_field(map_cache, block: int = 16):
    """Min-pooled + 3x3-eroded coarse distance field for the pruning
    bound; loop-invariant, computed once per rollout (or per map of a
    lane: map_cache (..., H, W) -> (..., Hc, Wc)).

    Dlow[u, v] = min of the field over blocks (u+-1, v+-1) (block
    windows with XLA "SAME" padding, as the reference package's
    reduce_window), so Dlow[u, v] <= cache[y, x] for every cell within
    `block` px of any point of block (u, v).  Out-of-grid neighbours are
    the identity: +inf, or the top code of a fixed-point field (no cells
    live there).  On codes the min runs on the codes (min over codes is
    min over values for the nonnegative fixed-point encoding), widened
    to int32 for the pooling, which is exact, and stored back."""
    lanes = tuple(map_cache.shape[:-2])
    H, W = map_cache.shape[-2:]
    if map_cache.dtype in TOP_CODE:
        field, init = cells(map_cache, ...).to(torch.int32), \
            TOP_CODE[map_cache.dtype]
    else:
        field, init = map_cache, torch.inf
    (t, b), (l, r) = _same_pads(H, block, block), _same_pads(W, block, block)
    p = F.pad(field.reshape(-1, 1, H, W), (l, r, t, b), value=init)[:, 0]
    Hc, Wc = p.shape[-2] // block, p.shape[-1] // block
    p = p.reshape(-1, Hc, block, Wc, block).amin(dim=(2, 4))
    q = F.pad(p[:, None], (1, 1, 1, 1), value=init)[:, 0]
    low = torch.stack([q[:, i:i + Hc, j:j + Wc] for i in range(3)
                       for j in range(3)]).amin(dim=0)
    low = low.reshape(lanes + (Hc, Wc))
    if map_cache.dtype == torch.uint16:
        return low.to(torch.int16).view(torch.uint16)
    return low.to(map_cache.dtype)


def _group_stats(pixels, pixels_mask, group: int, dt):
    """Per-group centroid / radius / live count of the compacted scan
    pixel cloud of each lane, groups of `group` consecutive slots
    (consecutive pixels rasterize adjacent cells, so groups are
    spatially tight).  Rigid transforms preserve centroid distances, so
    the stats are computed once per frame and reused by every
    candidate."""
    P = pixels.shape[-2]
    lanes = tuple(pixels.shape[:-2])
    pad = (-P) % group
    px = F.pad(pixels[..., 0].to(dt), (0, pad))
    py = F.pad(pixels[..., 1].to(dt), (0, pad))
    m = F.pad(pixels_mask, (0, pad))
    G = px.shape[-1] // group
    px, py, m = (v.reshape(lanes + (G, group)) for v in (px, py, m))
    n = m.sum(-1).to(dt)
    den = n.clamp(min=1.0)
    cx = torch.where(m, px, 0.0).sum(-1) / den
    cy = torch.where(m, py, 0.0).sum(-1) / den
    r = torch.where(m, geo.sqrt((px - cx[..., None]) ** 2
                                + (py - cy[..., None]) ** 2), 0.0).amax(-1)
    return cx, cy, r, n


def _chunk_bound(args, gs, coarse_flat, coarse_w, coarse_h, block,
                 rows, cols, z_occ_max_dis, max_dist_penalty,
                 obstacle_tolerance, valid_ratio, n_all, dt):
    """Provable per-candidate lower bound on CalcScore from the (..., G)
    group stats (the soundness argument is the reference package's
    associate._chunk_bound docstring): a group proven fully in-map adds
    n_g * (at-cap ? pen : Dlow) to a lower bound of sum_d; a group proven
    fully out-of-map adds pen*n_g/n_all; unproven groups add 0.  rows,
    cols and n_all are per lane ((B,) with a lane axis)."""
    ca, sa, sx, sy, mx, my = (a[..., :, None] for a in args)
    cx, cy, r, n = (g[..., None, :] for g in gs)
    rows, cols = geo.per_lane(rows, 2), geo.per_lane(cols, 2)
    tx = (cx - sx) * ca - (cy - sy) * sa + mx
    ty = (cx - sx) * sa + (cy - sy) * ca + my
    rr = r
    live = n > 0
    in_ok = live & (rr + 0.5 <= block) & \
        (tx - rr >= 0) & (tx + rr <= cols - 1) & \
        (ty - rr >= 0) & (ty + rr <= rows - 1)
    out_ok = live & ((tx + rr <= -1) | (tx - rr >= cols) |
                     (ty + rr <= -1) | (ty - rr >= rows))
    ub = (ty / block).to(torch.int32).clamp(0, coarse_h - 1)
    vb = (tx / block).to(torch.int32).clamp(0, coarse_w - 1)
    vals, at_cap = dequant(gather_cells(coarse_flat,
                                        (ub * coarse_w + vb).long()),
                           dt, z_occ_max_dis, coarse_flat.dtype)
    clow = torch.where(at_cap, max_dist_penalty, vals)
    s_low = torch.where(in_ok, n * clow, 0.0).sum(-1)
    o = torch.where(out_ok, n, 0.0).sum(-1)
    n_all = geo.per_lane(n_all, 1)
    bound = (s_low / n_all - max_dist_penalty * obstacle_tolerance
             ).clamp(min=0.0) + max_dist_penalty * o / n_all
    return torch.where(o > (1.0 - valid_ratio) * n_all, torch.inf, bound)


def prune_survivors(cand: Candidates, pixels, pixels_mask, coarse, rows,
                    cols, z_occ_max_dis: float = 1.0,
                    max_dist_penalty: float = 10.0,
                    valid_ratio: float = 0.7,
                    obstacle_tolerance: float = 0.0,
                    prune_accept: float = 3.0, prune_block: int = 16,
                    prune_group: int = 16):
    """The live candidates of each lane whose _chunk_bound lower bound
    passes prune_accept, compacted in order: (surv_idx (..., K) int32,
    n_surv (...) int32), both on the device (no host sync)."""
    dt = cand.ca.dtype
    gs = _group_stats(pixels, pixels_mask, prune_group, dt)
    coarse_h, coarse_w = coarse.shape[-2:]
    feats = cand.feats()
    K = feats.shape[-1]
    lanes = tuple(feats.shape[:-2])
    bounds = _chunk_bound(feats.unbind(-2), gs,
                          coarse.reshape(lanes + (-1,)), coarse_w,
                          coarse_h, prune_block, rows, cols, z_occ_max_dis,
                          max_dist_penalty, obstacle_tolerance, valid_ratio,
                          pixels_mask.sum(-1).to(dt), dt)
    maybe = (bounds < prune_accept) & cand.mask
    surv_idx, _m, n_surv = geo.masked_compact(
        torch.arange(K, dtype=torch.int32, device=feats.device).expand(
            lanes + (K,)), maybe, K)
    return surv_idx, n_surv.to(torch.int32)


def score_candidates_pruned(cand: Candidates, pixels, pixels_mask,
                            map_cache, coarse, rows=None, cols=None,
                            z_occ_max_dis: float = 1.0,
                            max_dist_penalty: float = 10.0,
                            valid_ratio: float = 0.7,
                            obstacle_tolerance: float = 0.0,
                            obstacle_min_dist: float = None,
                            prune_accept: float = 3.0,
                            prune_block: int = 16,
                            prune_group: int = 16) -> torch.Tensor:
    """score_candidates with exact bound-based pruning.

    Every live candidate gets the _chunk_bound lower bound; candidates
    whose bound already fails prune_accept can never be accepted (the
    reference stores only score < 3, myFA.cpp:261-265), so they skip
    the exact pass.  The survivor indices are compacted on the device
    and the kernel scores that list (its count read on the device, no
    host sync); the partials scatter back to their slots, so every
    survivor's partials are those of the unpruned path.  Pruned
    candidates finalize to inf.  With a lane axis one launch scores
    every lane's survivors.

    PRECONDITIONS: pixels_mask is a prefix mask; ``coarse`` comes from
    coarse_field(map_cache, prune_block)."""
    pad_rows, pad_cols = map_cache.shape[-2:]
    rows = pad_rows if rows is None else rows
    cols = pad_cols if cols is None else cols
    dt = cand.ca.dtype
    omd = _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis)
    n_all = pixels_mask.sum(-1).to(dt)
    surv_idx, n_surv = prune_survivors(
        cand, pixels, pixels_mask, coarse, rows, cols, z_occ_max_dis,
        max_dist_penalty, valid_ratio, obstacle_tolerance, prune_accept,
        prune_block, prune_group)
    # exact partials for the compacted survivors only
    feats = cand.feats()
    K = feats.shape[-1]
    px, py, n_pix = pixel_args(pixels, pixels_mask, dt)
    if feats.dim() > 2:
        parts = _lane_partials(feats, surv_idx.contiguous(), n_surv, px, py,
                               n_pix, map_cache, rows, cols, z_occ_max_dis,
                               max_dist_penalty, omd)
    else:
        parts = score_partials(feats, surv_idx, n_surv, px, py, n_pix,
                               map_cache, 0, int(rows), int(cols),
                               z_occ_max_dis, max_dist_penalty, omd)
    ar = torch.arange(K, device=feats.device)
    slot = torch.where(ar < n_surv[..., None], surv_idx.long(), K)

    def scatter(p):
        out = torch.zeros(p.shape[:-1] + (K + 1,), dtype=p.dtype,
                          device=p.device)
        out.scatter_(-1, slot, p)
        return out[..., :K]

    sum_d, n_valid, sum_far, n_far = (scatter(p) for p in parts)
    return finalize_scores(cand, sum_d, n_valid, n_all,
                           sum_far=sum_far, n_far=n_far,
                           max_dist_penalty=max_dist_penalty,
                           valid_ratio=valid_ratio,
                           obstacle_tolerance=obstacle_tolerance)


def finalize_scores(cand: Candidates, sum_d, n_valid, n_all,
                    sum_far=None, n_far=None,
                    max_dist_penalty: float = 10.0,
                    valid_ratio: float = 0.7,
                    obstacle_tolerance: float = 0.0):
    """Apply the CalcScore formula + gates to the partials (counts may
    be integer tensors; n_all is per lane).  obstacle_tolerance (opt-in,
    no reference equivalent) forgives up to that fraction of the scan's
    pixels whose field distance is >= obstacle_min_dist; 0.0 is bitwise
    the reference formula, and the cap of 0.5 keeps the 0.7 validity
    gate's denominator positive."""
    if not 0.0 <= obstacle_tolerance <= 0.5:
        raise ValueError("obstacle_tolerance must be in [0, 0.5], got "
                         f"{obstacle_tolerance}")
    dt = sum_d.dtype
    n_valid = n_valid.to(dt)
    n_all = geo.per_lane(n_all, 1)
    if obstacle_tolerance > 0.0:
        if sum_far is None or n_far is None:
            raise ValueError(
                "obstacle_tolerance > 0 requires the sum_far/n_far "
                "partials from score_candidates_partial")
        n_far = n_far.to(dt)
        forgiven = torch.minimum(n_far, obstacle_tolerance * n_all)
        frac = forgiven / n_far.clamp(min=1.0)
        denom = n_valid - forgiven
        # a fully-forgiven candidate (possible only with a lowered
        # valid_ratio) carries no information: inf, not 0/0
        score = torch.where(
            denom > 0,
            (sum_d - frac * sum_far) / denom.clamp(min=1e-9) +
            max_dist_penalty * (n_all - n_valid) / n_all,
            torch.inf)
    else:
        score = sum_d / n_valid + \
            max_dist_penalty * (n_all - n_valid) / n_all
    score = torch.where(n_valid < valid_ratio * n_all, torch.inf, score)
    return torch.where(cand.mask, score, torch.inf)


def fuse(cand: Candidates, scores, score_accept: float = 3.0,
         axis_name: Axis = Axis.none(), score_floor: float = 0.0
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]:
    """Accept (score < 3) and fuse candidates, each lane on its own.

    Returns (pose_weighted (..., 3), fused_score, pose_argmin (..., 3),
    min_score, n_accepted): the weighted mean for tracking frames
    (myFA.cpp:159-171) and the argmin for HMM-chain first frames
    (myFA.cpp:96-108).  score_floor 0.0 (faithful) keeps the reference's
    IEEE behaviour: a perfect candidate gets weight 1/(0*0) = inf and the
    fused pose inf/inf = NaN; cfg.faithful=False floors the weight
    scores at 1e-6.  The argmin along the slot axis returns the first
    minimum on both devices.

    ``axis_name`` (a runtime/collectives.Axis): the candidates are
    sharded over that axis (map-line tensor parallelism).  The weighted
    mean is a sum, so a psum of (sum_w, sum_pose, n) gives every rank
    the whole set's; the argmin is a pmin of the minimum, owned by the
    lowest rank that holds it (its pose psummed from that rank)."""
    acc = scores < score_accept
    w_scores = scores.clamp(min=score_floor) if score_floor > 0.0 else scores
    w = torch.where(acc, 1.0 / (w_scores * w_scores), 0.0)
    sum_w = w.sum(-1)
    sum_pose = (cand.pose * w[..., None]).sum(-2)
    n_acc = acc.sum(-1)
    masked = torch.where(acc, scores, torch.inf)
    best = torch.argmin(masked, dim=-1, keepdim=True)
    min_score = torch.gather(masked, -1, best)[..., 0]
    pose_min = torch.gather(cand.pose, -2, best[..., None].expand(
        best.shape + (3,)))[..., 0, :]
    if axis_name.size > 1:
        # (at one rank these collectives are the identity, but the
        # operations around them would be launches a frame for nothing)
        ax = axis_name
        # one collective for the three sums: [sum_w, sum_pose] rides
        # with the count (exact in the working type: n < 2^24)
        sums = ax.psum(torch.cat([sum_w[..., None], sum_pose,
                                  n_acc[..., None].to(sum_w.dtype)], -1))
        sum_w, sum_pose = sums[..., 0], sums[..., 1:4]
        n_acc = sums[..., 4].to(n_acc.dtype)
        g_min = ax.pmin(min_score)
        rank = torch.full_like(n_acc, ax.index)
        owner = ax.pmin(torch.where(min_score == g_min, rank, ax.size))
        pose_min = ax.psum(torch.where((rank == owner)[..., None], pose_min,
                                       torch.zeros_like(pose_min)))
        min_score = g_min
    pose_w = sum_pose / sum_w[..., None]
    fused_score = 1.0 / geo.sqrt(sum_w / n_acc)
    return pose_w, fused_score, pose_min, min_score, n_acc


def relock_ambiguity(cand: Candidates, scores, pose_min, min_score,
                     min_dist: float = 60.0, margin: float = 0.2,
                     min_ang: float = 45.0, score_accept: float = 3.0,
                     axis_name: Axis = Axis.none()):
    """Second-mode detection for the global relocalization path (opt-in,
    match.relock_margin; no reference equivalent): True when an accepted
    candidate separated from the winner by more than min_dist px OR
    min_ang degrees scores within (1+margin) of it.  Under tp sharding
    (``axis_name``, an Axis) pose_min/min_score are the fused winners
    and the far mode's minimum is a pmin."""
    d2 = ((cand.pose[..., :2] - pose_min[..., None, :2]) ** 2).sum(-1)
    dang = geo.wrap_deg(cand.pose[..., 2] - pose_min[..., None, 2])
    apart = (d2 > min_dist * min_dist) | (dang.abs() > min_ang)
    far = (scores < score_accept) & apart
    second = torch.where(far, scores, torch.inf).amin(-1)
    second = axis_name.pmin(second)
    return second <= min_score * (1.0 + margin)
