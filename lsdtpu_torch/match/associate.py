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
index list only - one kernel launch per frame either way.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.ops.score import score_partials


def quantize_cache(map_cache, cache_dtype: str, z_occ_max_dis: float = 1.0,
                   float_dtype=torch.float32):
    """The distance field as the scorer reads it.  "f32" (and "default")
    is the float field at ``float_dtype`` (exact).  The compressed
    fields of the reference package ("bf16", "u16", "u8") are not
    ported yet."""
    if cache_dtype in ("f32", "default"):
        return map_cache.to(float_dtype)
    if cache_dtype in ("bf16", "u16", "u8"):
        raise NotImplementedError(
            f"cache_dtype={cache_dtype!r} is not ported yet; use 'f32'")
    raise ValueError(f"unknown cache_dtype {cache_dtype!r}")


def _dequant(vals, dt, z_occ_max_dis):
    """Gathered field values -> (float values, at-cap predicate)."""
    if not vals.dtype.is_floating_point:
        raise NotImplementedError("fixed-point fields are not ported yet")
    v = vals.to(dt)
    return v, v >= z_occ_max_dis


@dataclasses.dataclass
class Candidates:
    """Fixed-size compacted candidate set."""

    ca: torch.Tensor        # (K,) cos(angDiff)
    sa: torch.Tensor        # (K,) sin(angDiff)
    sx: torch.Tensor        # (K,) scan base point
    sy: torch.Tensor
    mx: torch.Tensor        # (K,) map base point
    my: torch.Tensor
    pose: torch.Tensor      # (K, 3) transformed lidar pose (x, y, angDiff)
    mask: torch.Tensor      # (K,) bool, prefix
    count: torch.Tensor     # () int64 pre-truncation count (overflow checks)

    def feats(self):
        """(6, K) contiguous [ca, sa, sx, sy, mx, my], the kernel layout."""
        return torch.stack([self.ca, self.sa, self.sx, self.sy, self.mx,
                            self.my]).contiguous()


def generate_candidates(scan_lines, scan_mask, map_lines, map_mask,
                        lidar_pose, last_pose, max_candidates: int,
                        ignore_scan_length: float = 40.0,
                        scan_to_map_diff: float = 0.35,
                        max_esti_dist: float = 60.0) -> Candidates:
    """Gate + compact the (S, M, 4) hypothesis tensor (reference:
    myFA.cpp:29-41 length gates, myFA.cpp:186-235 alignment hypotheses,
    myFA.cpp:330 HMM gate)."""
    S = scan_lines.shape[0]
    M = map_lines.shape[0]
    dev = scan_lines.device

    s_len = scan_lines[:, geo.LEN]
    m_len = map_lines[:, geo.LEN]
    len_diff = s_len * scan_to_map_diff
    gate_len = (scan_mask & (s_len >= ignore_scan_length))[:, None] & \
        map_mask[None, :] & \
        (m_len[None, :] >= (s_len - len_diff)[:, None]) & \
        (m_len[None, :] <= (s_len + len_diff)[:, None])          # (S, M)

    def dirs(lines):
        fwd = geo.normalized_line_direction(
            lines[:, geo.X1], lines[:, geo.Y1],
            lines[:, geo.X2], lines[:, geo.Y2])
        rev = geo.normalized_line_direction(
            lines[:, geo.X2], lines[:, geo.Y2],
            lines[:, geo.X1], lines[:, geo.Y1])
        return fwd, rev

    s_fwd, s_rev = dirs(scan_lines)
    m_fwd, m_rev = dirs(map_lines)

    # hypothesis layout h=0..3 (myFA.cpp:194-235):
    #   h0: map fwd, scan fwd   h1: map fwd, scan rev
    #   h2: map rev, scan fwd   h3: map rev, scan rev
    X1, Y1, X2, Y2 = geo.X1, geo.Y1, geo.X2, geo.Y2
    m_ang = torch.stack([m_fwd, m_fwd, m_rev, m_rev], -1)        # (M, 4)
    m_bx = map_lines[:, [X1, X1, X2, X2]]
    m_by = map_lines[:, [Y1, Y1, Y2, Y2]]
    s_ang = torch.stack([s_fwd, s_rev, s_fwd, s_rev], -1)        # (S, 4)
    s_bx = scan_lines[:, [X1, X2, X1, X2]]
    s_by = scan_lines[:, [Y1, Y2, Y1, Y2]]

    ang_diff = m_ang[None, :, :] - s_ang[:, None, :]             # (S, M, 4)
    ca = geo.cosd(ang_diff)
    sa = geo.sind(ang_diff)
    sx = s_bx[:, None, :].expand(S, M, 4)
    sy = s_by[:, None, :].expand(S, M, 4)
    mx = m_bx[None, :, :].expand(S, M, 4)
    my = m_by[None, :, :].expand(S, M, 4)

    lx, ly = lidar_pose[0], lidar_pose[1]
    rlx = (lx - sx) * ca - (ly - sy) * sa + mx
    rly = (lx - sx) * sa + (ly - sy) * ca + my
    first = last_pose[0] == -1
    # the reference gates on sqrt(d2) < maxEstiDist (myFA.cpp:330), in
    # its accept form: a NaN distance fails the gate
    d = geo.sqrt((rlx - last_pose[0]) ** 2 + (rly - last_pose[1]) ** 2)
    gate = gate_len[:, :, None] & (first | (d < max_esti_dist))

    # compact survivor INDICES, then gather the features for the K slots;
    # padded slots are zero (degenerate padded lines give NaN directions,
    # and a NaN pose row would poison the weighted-mean sums)
    comp_idx, mask, count = geo.masked_compact(
        torch.arange(S * M * 4, device=dev), gate.reshape(-1),
        max_candidates)

    def take(a):
        return torch.where(mask, a.reshape(-1)[comp_idx], 0.0)

    return Candidates(
        ca=take(ca), sa=take(sa), sx=take(sx), sy=take(sy),
        mx=take(mx), my=take(my),
        pose=torch.stack([take(rlx), take(rly),
                          torch.where(mask, geo.wrap_deg(take(ang_diff)),
                                      0.0)], -1),
        mask=mask, count=count)


def _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis):
    if obstacle_min_dist is None:
        return z_occ_max_dis
    if not 0.0 < obstacle_min_dist <= z_occ_max_dis:
        raise ValueError(
            f"obstacle_min_dist={obstacle_min_dist} must be in "
            f"(0, z_occ_max_dis={z_occ_max_dis}]")
    return obstacle_min_dist


def pixel_args(pixels, pixels_mask, dt):
    """(px, py, n_pix) in the kernel layout; the live pixels must be a
    prefix (featurize's compaction produces one)."""
    return (pixels[:, 0].to(dt).contiguous(),
            pixels[:, 1].to(dt).contiguous(),
            pixels_mask.sum().to(torch.int32))


def score_candidates_partial(cand: Candidates, pixels, pixels_mask,
                             cache_block, row0, rows, cols,
                             z_occ_max_dis: float = 1.0,
                             max_dist_penalty: float = 10.0,
                             obstacle_min_dist: float = None):
    """Per-candidate additive partials (sum_d, n_valid, sum_far, n_far)
    over the field rows [row0, row0 + block_h) of a rows x cols map; the
    counts are exact int32.  sum_far/n_far aggregate the in-map pixels
    whose field distance is >= obstacle_min_dist (default: the cap, the
    reference's sumMaxDist population, myFA.cpp:381).

    PRECONDITION: pixels_mask is a prefix mask.  One kernel launch,
    which reads the live candidate and pixel counts on the device."""
    dt = cand.ca.dtype
    omd = _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis)
    K = cand.ca.shape[0]
    px, py, n_pix = pixel_args(pixels, pixels_mask, dt)
    return score_partials(
        cand.feats(), None, cand.count.clamp(0, K).to(torch.int32), px, py,
        n_pix, cache_block.contiguous(), int(row0), int(rows), int(cols),
        z_occ_max_dis, max_dist_penalty, omd)


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
                     window: int = 0) -> torch.Tensor:
    """Score every candidate against the mapCache prior (reference:
    CalcScore, myFA.cpp:357-396).  Returns (K,) scores, inf where gated
    or invalid.

    With ``coarse`` (from coarse_field), ``prune_accept`` and
    ``dynamic_chunks`` (the reference package's gate for pruning), the
    pruned scorer runs when the live count reaches ``prune_min_live``
    (0 = always) - one host read of cand.count per frame; the plain
    path otherwise.  Both give the same score to every candidate that
    can be accepted.  PRECONDITION: pixels_mask is a prefix mask.
    ``window`` > 0 (windowed scoring) is not ported yet."""
    if window:
        raise NotImplementedError("match.score_window > 0 is not ported yet")
    if coarse is not None and prune_accept is not None and dynamic_chunks:
        if not prune_min_live or int(cand.count) >= prune_min_live:
            return score_candidates_pruned(
                cand, pixels, pixels_mask, map_cache, coarse,
                rows=rows, cols=cols, z_occ_max_dis=z_occ_max_dis,
                max_dist_penalty=max_dist_penalty, valid_ratio=valid_ratio,
                obstacle_tolerance=obstacle_tolerance,
                obstacle_min_dist=obstacle_min_dist,
                prune_accept=prune_accept, prune_block=prune_block,
                prune_group=prune_group)
    pad_rows, pad_cols = map_cache.shape
    rows = pad_rows if rows is None else rows
    cols = pad_cols if cols is None else cols
    dt = cand.ca.dtype
    sum_d, n_valid, sum_far, n_far = score_candidates_partial(
        cand, pixels, pixels_mask, map_cache, 0, rows, cols,
        z_occ_max_dis=z_occ_max_dis, max_dist_penalty=max_dist_penalty,
        obstacle_min_dist=obstacle_min_dist)
    return finalize_scores(cand, sum_d, n_valid, pixels_mask.sum().to(dt),
                           sum_far=sum_far, n_far=n_far,
                           max_dist_penalty=max_dist_penalty,
                           valid_ratio=valid_ratio,
                           obstacle_tolerance=obstacle_tolerance)


def _same_pads(n: int, window: int, stride: int):
    """XLA "SAME" padding (lo, hi) of one dimension."""
    out = -(-n // stride)
    total = max(0, (out - 1) * stride + window - n)
    return total // 2, total - total // 2


def coarse_field(map_cache, block: int = 16):
    """Min-pooled + 3x3-eroded coarse distance field for the pruning
    bound; loop-invariant, computed once per rollout.

    Dlow[u, v] = min of the field over blocks (u+-1, v+-1) (block
    windows with XLA "SAME" padding, as the reference package's
    reduce_window), so Dlow[u, v] <= cache[y, x] for every cell within
    `block` px of any point of block (u, v).  Out-of-grid neighbours are
    +inf (no cells live there)."""
    H, W = map_cache.shape
    if not map_cache.dtype.is_floating_point:
        raise NotImplementedError("fixed-point fields are not ported yet")
    (t, b), (l, r) = _same_pads(H, block, block), _same_pads(W, block, block)
    p = F.pad(map_cache[None, None], (l, r, t, b), value=torch.inf)[0, 0]
    Hc, Wc = p.shape[0] // block, p.shape[1] // block
    p = p.reshape(Hc, block, Wc, block).amin(dim=(1, 3))
    q = F.pad(p[None, None], (1, 1, 1, 1), value=torch.inf)[0, 0]
    return torch.stack([q[i:i + Hc, j:j + Wc] for i in range(3)
                        for j in range(3)]).amin(dim=0)


def _group_stats(pixels, pixels_mask, group: int, dt):
    """Per-group centroid / radius / live count of the compacted scan
    pixel cloud, groups of `group` consecutive slots (consecutive pixels
    rasterize adjacent cells, so groups are spatially tight).  Rigid
    transforms preserve centroid distances, so the stats are computed
    once per frame and reused by every candidate."""
    P = pixels.shape[0]
    pad = (-P) % group
    px = F.pad(pixels[:, 0].to(dt), (0, pad))
    py = F.pad(pixels[:, 1].to(dt), (0, pad))
    m = F.pad(pixels_mask, (0, pad))
    G = px.shape[0] // group
    px, py, m = px.reshape(G, group), py.reshape(G, group), m.reshape(G, group)
    n = m.sum(1).to(dt)
    den = n.clamp(min=1.0)
    cx = torch.where(m, px, 0.0).sum(1) / den
    cy = torch.where(m, py, 0.0).sum(1) / den
    r = torch.where(m, geo.sqrt((px - cx[:, None]) ** 2
                                + (py - cy[:, None]) ** 2), 0.0).amax(1)
    return cx, cy, r, n


def _chunk_bound(args, gs, coarse_flat, coarse_w, coarse_h, block,
                 rows, cols, z_occ_max_dis, max_dist_penalty,
                 obstacle_tolerance, valid_ratio, n_all, dt):
    """Provable per-candidate lower bound on CalcScore from the (G,)
    group stats (the soundness argument is the reference package's
    associate._chunk_bound docstring): a group proven fully in-map adds
    n_g * (at-cap ? pen : Dlow) to a lower bound of sum_d; a group proven
    fully out-of-map adds pen*n_g/n_all; unproven groups add 0."""
    ca, sa, sx, sy, mx, my = args
    cx, cy, r, n = gs
    tx = (cx[None, :] - sx[:, None]) * ca[:, None] - \
        (cy[None, :] - sy[:, None]) * sa[:, None] + mx[:, None]
    ty = (cx[None, :] - sx[:, None]) * sa[:, None] + \
        (cy[None, :] - sy[:, None]) * ca[:, None] + my[:, None]
    rr = r[None, :]
    live = n[None, :] > 0
    in_ok = live & (rr + 0.5 <= block) & \
        (tx - rr >= 0) & (tx + rr <= cols - 1) & \
        (ty - rr >= 0) & (ty + rr <= rows - 1)
    out_ok = live & ((tx + rr <= -1) | (tx - rr >= cols) |
                     (ty + rr <= -1) | (ty - rr >= rows))
    ub = (ty / block).to(torch.int32).clamp(0, coarse_h - 1)
    vb = (tx / block).to(torch.int32).clamp(0, coarse_w - 1)
    vals, at_cap = _dequant(coarse_flat[(ub * coarse_w + vb).long()], dt,
                            z_occ_max_dis)
    clow = torch.where(at_cap, max_dist_penalty, vals)
    s_low = torch.where(in_ok, n[None, :] * clow, 0.0).sum(1)
    o = torch.where(out_ok, n[None, :], 0.0).sum(1)
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
    """The live candidates whose _chunk_bound lower bound passes
    prune_accept, compacted in order: (surv_idx (K,) int32, n_surv ()
    int32), both on the device (no host sync)."""
    dt = cand.ca.dtype
    gs = _group_stats(pixels, pixels_mask, prune_group, dt)
    coarse_h, coarse_w = coarse.shape
    feats = cand.feats()
    K = feats.shape[1]
    bounds = _chunk_bound(tuple(feats), gs, coarse.reshape(-1), coarse_w,
                          coarse_h, prune_block, rows, cols, z_occ_max_dis,
                          max_dist_penalty, obstacle_tolerance, valid_ratio,
                          pixels_mask.sum().to(dt), dt)
    maybe = (bounds < prune_accept) & cand.mask
    surv_idx, _m, n_surv = geo.masked_compact(
        torch.arange(K, dtype=torch.int32, device=feats.device), maybe, K)
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
    candidates finalize to inf.

    PRECONDITIONS: pixels_mask is a prefix mask; ``coarse`` comes from
    coarse_field(map_cache, prune_block)."""
    pad_rows, pad_cols = map_cache.shape
    rows = pad_rows if rows is None else rows
    cols = pad_cols if cols is None else cols
    dt = cand.ca.dtype
    omd = _check_obstacle_min_dist(obstacle_min_dist, z_occ_max_dis)
    n_all = pixels_mask.sum().to(dt)
    surv_idx, n_surv = prune_survivors(
        cand, pixels, pixels_mask, coarse, rows, cols, z_occ_max_dis,
        max_dist_penalty, valid_ratio, obstacle_tolerance, prune_accept,
        prune_block, prune_group)
    # exact partials for the compacted survivors only
    feats = cand.feats()
    K = feats.shape[1]
    px, py, n_pix = pixel_args(pixels, pixels_mask, dt)
    parts = score_partials(feats, surv_idx, n_surv, px, py, n_pix,
                           map_cache.contiguous(), 0, int(rows), int(cols),
                           z_occ_max_dis, max_dist_penalty, omd)
    ar = torch.arange(K, device=feats.device)
    slot = torch.where(ar < n_surv, surv_idx.long(), K)

    def scatter(p):
        out = torch.zeros(K + 1, dtype=p.dtype, device=p.device)
        out[slot] = p
        return out[:K]

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
    be integer tensors).  obstacle_tolerance (opt-in, no reference
    equivalent) forgives up to that fraction of the scan's pixels whose
    field distance is >= obstacle_min_dist; 0.0 is bitwise the reference
    formula, and the cap of 0.5 keeps the 0.7 validity gate's
    denominator positive."""
    if not 0.0 <= obstacle_tolerance <= 0.5:
        raise ValueError("obstacle_tolerance must be in [0, 0.5], got "
                         f"{obstacle_tolerance}")
    dt = sum_d.dtype
    n_valid = n_valid.to(dt)
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
         axis_name=None, score_floor: float = 0.0
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]:
    """Accept (score < 3) and fuse candidates.

    Returns (pose_weighted (3,), fused_score, pose_argmin (3,),
    min_score, n_accepted): the weighted mean for tracking frames
    (myFA.cpp:159-171) and the argmin for HMM-chain first frames
    (myFA.cpp:96-108).  score_floor 0.0 (faithful) keeps the reference's
    IEEE behaviour: a perfect candidate gets weight 1/(0*0) = inf and the
    fused pose inf/inf = NaN; cfg.faithful=False floors the weight
    scores at 1e-6.  ``axis_name`` (sharded candidates) is not ported."""
    if axis_name is not None:
        raise NotImplementedError("tp sharding is not ported yet")
    acc = scores < score_accept
    w_scores = scores.clamp(min=score_floor) if score_floor > 0.0 else scores
    w = torch.where(acc, 1.0 / (w_scores * w_scores), 0.0)
    sum_w = w.sum()
    sum_pose = (cand.pose * w[:, None]).sum(0)
    n_acc = acc.sum()
    masked = torch.where(acc, scores, torch.inf)
    best = torch.argmin(masked)
    min_score = masked[best]
    pose_min = cand.pose[best]
    pose_w = sum_pose / sum_w
    fused_score = 1.0 / geo.sqrt(sum_w / n_acc)
    return pose_w, fused_score, pose_min, min_score, n_acc


def relock_ambiguity(cand: Candidates, scores, pose_min, min_score,
                     min_dist: float = 60.0, margin: float = 0.2,
                     min_ang: float = 45.0, score_accept: float = 3.0,
                     axis_name=None):
    """Second-mode detection for the global relocalization path (opt-in,
    match.relock_margin; no reference equivalent): True when an accepted
    candidate separated from the winner by more than min_dist px OR
    min_ang degrees scores within (1+margin) of it."""
    if axis_name is not None:
        raise NotImplementedError("tp sharding is not ported yet")
    d2 = ((cand.pose[:, :2] - pose_min[None, :2]) ** 2).sum(1)
    dang = geo.wrap_deg(cand.pose[:, 2] - pose_min[2])
    apart = (d2 > min_dist * min_dist) | (dang.abs() > min_ang)
    far = (scores < score_accept) & apart
    second = torch.where(far, scores, torch.inf).amin()
    return second <= min_score * (1.0 + margin)
