"""Legacy (ROS V2.2) feature association on tensors (counterpart of
lsdtpu/match/legacy.py).

Reference: ROS/lsd/src/FeatureAssociation.cpp, the first-generation
matcher the ROS node runs.  Same dense (S, M, 4) hypothesis tensor as
the current-generation matcher (associate.py), with the legacy
semantics:

  * absolute length gate |mapLen - scanLen| <= 0.3 m / resol
    (FeatureAssociation.cpp:64-73); no minimum-length or HMM gate;
  * candidate pose = floor((LidarPos - scan_base) R + map_base), with
    the lidar position NOT C-rounded, heading = map-line direction
    (RotateScanIm, :254-299);
  * scoring reprojects the RAW polar ranges at the candidate pose with
    the 7x cap-count weighting and the 0.75 in-bounds validity gate
    (ScanToMapMatchScore, :202-252; cache cap z = 2 m in the ROS node,
    main_on_linux.cpp:129);
  * the global FIRST minimum wins (:119-124) - no fusion, no filter.

The reference package has no Pallas kernel for this matcher: it is
plain tensor code there and plain PyTorch here, on the card or the CPU.
The distance sums add in one fixed order (geometry.tree_sum), so a
candidate's score, and with it the first minimum, does not depend on
the device's reduction order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.match.associate import Candidates

PI = math.pi


def generate_candidates_legacy(scan_lines, scan_mask, map_lines, map_mask,
                               lidar_pos, resol, max_candidates: int,
                               len_diff_m: float = 0.3) -> Candidates:
    """Gate + compact the (S, M, 4) legacy hypothesis tensor, in order
    (scan line, map line, hypothesis)."""
    S = scan_lines.shape[0]
    M = map_lines.shape[0]

    s_len = scan_lines[:, geo.LEN]
    m_len = map_lines[:, geo.LEN]
    len_diff = len_diff_m / resol
    gate_len = scan_mask[:, None] & map_mask[None, :] & \
        (m_len[None, :] >= (s_len - len_diff)[:, None]) & \
        (m_len[None, :] <= (s_len + len_diff)[:, None])

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

    # hypothesis layout (FeatureAssociation.cpp:159-179):
    #   h0: map fwd + scan fwd   h1: map fwd + scan rev
    #   h2: map rev + scan fwd   h3: map rev + scan rev
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

    lx, ly = lidar_pos[0], lidar_pos[1]
    px = torch.floor((lx - sx) * ca - (ly - sy) * sa + mx)
    py = torch.floor((lx - sx) * sa + (ly - sy) * ca + my)
    ang = s_ang[:, None, :].expand(S, M, 4) + ang_diff

    feat = torch.stack([ca, sa, sx, sy, mx, my, px, py, ang],
                       -1).reshape(S * M * 4, 9)
    gate = gate_len[:, :, None].expand(S, M, 4)
    comp, mask, count = geo.masked_compact(feat, gate.reshape(-1),
                                           max_candidates)
    return Candidates(
        ca=comp[:, 0], sa=comp[:, 1], sx=comp[:, 2], sy=comp[:, 3],
        mx=comp[:, 4], my=comp[:, 5], pose=comp[:, 6:9], mask=mask,
        count=count)


def score_candidates_legacy(cand: Candidates, ranges, angles, valid, n,
                            map_cache, resol, rows=None, cols=None,
                            z_occ_max_dis: float = 2.0) -> torch.Tensor:
    """(K,) legacy scores, all K slots in one pass: raw polar
    reprojection at each candidate pose (reference: ScanToMapMatchScore,
    FeatureAssociation.cpp:202-252).  Dead slots (pose 0) fail the pose
    test and score inf."""
    pad_rows, pad_cols = map_cache.shape
    rows = pad_rows if rows is None else rows
    cols = pad_cols if cols is None else cols
    dt = ranges.dtype
    nf = n.to(dt)
    cache_flat = map_cache.reshape(-1)

    px, py, ang = cand.pose[:, 0], cand.pose[:, 1], cand.pose[:, 2]
    th = ang * (PI / 180.0)
    gx = torch.floor(ranges[None, :] * torch.cos(angles[None, :] + th[:, None])
                     / resol) + px[:, None] - 1.0
    gy = torch.floor(ranges[None, :] * torch.sin(angles[None, :] + th[:, None])
                     / resol) + py[:, None] - 1.0
    inb = (gx > 1) & (gx < cols) & (gy > 1) & (gy < rows) & valid[None, :]
    ix = gx.clamp(0, pad_cols - 1).long()
    iy = gy.clamp(0, pad_rows - 1).long()
    vals = cache_flat[iy * pad_cols + ix]
    # exact equality is the reference semantic (the cap INIT value,
    # FeatureAssociation.cpp:238-242; above-cap stored distances stay in
    # the dist sum); quantized fields are rejected upstream
    # (runtime/online.py set_map_artifacts)
    at_cap = inb & (vals == z_occ_max_dis)
    scanlen = inb.sum(1).to(dt)
    max_count = at_cap.sum(1).to(dt)
    dist = geo.tree_sum(torch.where(inb & ~at_cap, vals, 0.0))
    dist_count = scanlen - max_count
    score = (dist + 7.0 * max_count) / (dist_count + max_count) + \
        10.0 * (nf - scanlen) / nf
    pose_ok = (px <= cols) & (px >= 1) & (py <= rows) & (py >= 1)
    ok = pose_ok & (scanlen >= nf * 0.75) & cand.mask
    return torch.where(ok, score, torch.inf)


def first_min_pose(cand: Candidates, scores
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global first-minimum pose [x, y, ang_rad] and its score
    (FeatureAssociation.cpp:119-127).  torch.argmin returns the first
    minimal index on every device: h0..h3 of one line pair often floor
    onto one pose, and the earliest in compaction order wins, as in the
    reference's strict-less scan."""
    best = torch.argmin(torch.where(cand.mask, scores, torch.inf))
    p = cand.pose[best]
    return torch.stack([p[0], p[1], p[2] * (PI / 180.0)]), scores[best]


def pixel_to_world(pose, resol, ori_x, ori_y):
    """estimatePose_realworld (FeatureAssociation.cpp:126-129)."""
    return torch.stack([pose[0] * resol + ori_x, pose[1] * resol + ori_y,
                        pose[2]])
