"""Numpy oracle for feature association + UKF.

Exact-semantics re-implementation of the reference matcher (reference:
LSD/myFA.cpp).  The reference fans candidate scoring out on a pthread
threadpool with a mutex-guarded result vector, so its result order (and
tie behavior of the subsequent qsort) is timing-dependent; this oracle
enumerates candidates deterministically in (scanLine, mapLine,
hypothesis) order.  All candidates surviving the score<3 gate are fused
by an inverse-square-score weighted mean, which is order-free, so the
fused pose is identical to the reference's up to fp addition order.

Quirks kept:
  * the HMM gate uses the *rounded* lidar pose from trans2FA
    (main_on_windows.cpp:229-230);
  * the first frame (lastPose.x == -1) takes the min-score candidate and
    leaves kalman_P untouched (myFA.cpp:99-108);
  * empty candidate set resets the filter state to the sentinel
    (myFA.cpp:69-89).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from reference.lsd import cosd, sind, _atand

PI = math.pi

KALMAN_RESET_X = np.array([-1, -1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64)
KALMAN_RESET_P = np.diag([100, 100, 100, 1, 1, 1, 0.1, 0.1, 0.1]
                         ).astype(np.float64)


def normalized_line_direction(sx: float, sy: float, ex: float, ey: float
                              ) -> float:
    """Line direction in degrees, [-180, 180] (myFA.cpp:274-305)."""
    if sx == ex and sy != ey:
        ang = 90.0 if sy < ey else -90.0
    elif sx != ex and sy == ey:
        ang = 0.0 if sx < ex else 180.0
    else:
        # degenerate zero-length lines reach this branch with a 0/0
        # slope; the reference computes atan(NaN)=NaN the same way
        # (myFA.cpp:274-305) - keep the value, silence the warning
        with np.errstate(invalid='ignore', divide='ignore'):
            ang = _atand((ey - sy) / (ex - sx))
    if ang < 0 and sx > ex:
        return ang + 180
    if ang > 0 and sx > ex:
        return ang - 180
    return ang


def calc_score(map_cache: np.ndarray, pts_x: np.ndarray, pts_y: np.ndarray,
               z_occ_max_dis: float = 1.0) -> float:
    """Mean mapCache distance over transformed scan pixels (myFA.cpp:357-396)."""
    rows, cols = map_cache.shape
    x = np.where(pts_x >= 0, np.floor(pts_x + 0.5),
                 np.ceil(pts_x - 0.5)).astype(np.int64)
    y = np.where(pts_y >= 0, np.floor(pts_y + 0.5),
                 np.ceil(pts_y - 0.5)).astype(np.int64)
    inside = (y >= 0) & (y < rows) & (x >= 0) & (x < cols)
    num_all = float(len(pts_x))
    num_valid = float(inside.sum())
    if num_valid < 0.7 * num_all:
        return float('inf')
    vals = map_cache[y[inside], x[inside]]
    at_cap = vals >= z_occ_max_dis
    sum_valid = float(vals[~at_cap].sum())
    sum_max = 10.0 * float(at_cap.sum())
    return (sum_valid + sum_max) / num_valid + \
        10.0 * (num_all - num_valid) / num_all


@dataclasses.dataclass
class Candidate:
    x: float
    y: float
    ang: float
    score: float


def scan_to_map_candidates(scan_lines: np.ndarray, map_lines: np.ndarray,
                           scan_pts: np.ndarray, lidar_pose: Tuple[float, float],
                           last_pose: Tuple[float, float, float],
                           map_cache: np.ndarray,
                           z_occ_max_dis: float = 1.0,
                           ignore_scan_length: float = 40.0,
                           scan_to_map_diff: float = 0.35,
                           max_esti_dist: float = 60.0,
                           score_accept: float = 3.0) -> List[Candidate]:
    """Enumerate and score (scanLine, mapLine, 4 alignments) hypotheses
    (myFA.cpp:13-272)."""
    out: List[Candidate] = []
    p_x = scan_pts[:, 0].astype(np.float64)
    p_y = scan_pts[:, 1].astype(np.float64)
    lx, ly = float(lidar_pose[0]), float(lidar_pose[1])
    first_frame = last_pose[0] == -1

    for si in range(scan_lines.shape[0]):
        s = scan_lines[si]
        len_scan = s[8]
        if len_scan < ignore_scan_length:
            continue
        len_diff = len_scan * scan_to_map_diff
        for mi in range(map_lines.shape[0]):
            m = map_lines[mi]
            len_map = m[8]
            if len_map < len_scan - len_diff or len_map > len_scan + len_diff:
                continue
            # 4 endpoint alignments (myFA.cpp:194-235): (map fwd, scan fwd),
            # (map fwd, scan rev), (map rev, scan fwd), (map rev, scan rev)
            for hyp in range(4):
                if hyp in (0, 1):
                    mp = (m[4], m[5], m[6], m[7])
                else:
                    mp = (m[6], m[7], m[4], m[5])
                if hyp in (0, 2):
                    sp = (s[4], s[5], s[6], s[7])
                else:
                    sp = (s[6], s[7], s[4], s[5])
                map_ang = normalized_line_direction(*mp)
                scan_ang = normalized_line_direction(*sp)
                ang_diff = map_ang - scan_ang
                ca, sa = cosd(ang_diff), sind(ang_diff)
                sx, sy = sp[0], sp[1]
                mx, my = mp[0], mp[1]
                rlx = (lx - sx) * ca - (ly - sy) * sa + mx
                rly = (lx - sx) * sa + (ly - sy) * ca + my
                if not first_frame:
                    d = math.sqrt((rlx - last_pose[0]) ** 2 +
                                  (rly - last_pose[1]) ** 2)
                    # accept-form comparison, NOT `d >= max: continue`:
                    # the reference gates with `if (dis < maxEstiDist)`
                    # (myFA.cpp:330), so a NaN distance (possible after
                    # a perfect-score frame NaN-poisons last_pose, see
                    # fuse_candidates) REJECTS the candidate - the
                    # inverted form accepted it (fuzz campaign r5)
                    if not (d < max_esti_dist):
                        continue
                tx = (p_x - sx) * ca - (p_y - sy) * sa + mx
                ty = (p_x - sx) * sa + (p_y - sy) * ca + my
                score = calc_score(map_cache, tx, ty, z_occ_max_dis)
                if score < score_accept:
                    while ang_diff <= -180:
                        ang_diff += 360
                    while ang_diff > 180:
                        ang_diff -= 360
                    out.append(Candidate(rlx, rly, ang_diff, score))
    return out


@dataclasses.dataclass
class FAResult:
    kalman_x: np.ndarray
    kalman_P: np.ndarray
    score: float            # fused match score (inf if lost)
    n_candidates: int


def fuse_candidates(cands: List[Candidate]) -> Optional[Candidate]:
    """Inverse-square-score weighted mean (myFA.cpp:159-171).

    A PERFECT candidate (score == 0.0, every pixel on a zero-distance
    cell - reachable on noise-free synthetic scenes) gets weight
    1/0 = +inf in the reference's IEEE doubles (myFA.cpp:161), so the
    fused pose becomes inf/inf = NaN and the fused score
    1/sqrt(inf) = 0.  Python float division would raise instead -
    mirror the C++ semantics explicitly (found by
    scripts/fuzz_campaign.py r5).  The test is on the square, as the
    C++ divides by it: a positive score below ~1.5e-162 squares to 0.0
    and gets the same infinite weight."""
    if not cands:
        return None
    sum_x = sum_y = sum_ang = sum_s = 0.0
    for c in cands:
        sq = c.score * c.score
        w = math.inf if sq == 0.0 else 1.0 / sq
        sum_x += c.x * w
        sum_y += c.y * w
        sum_ang += c.ang * w
        sum_s += w
    # sum_s is inf or positive-finite (never 0.0: every term > 0), so
    # plain division already matches the C++ IEEE results (inf/inf =
    # nan, finite/inf = 0.0); errstate silences numpy's scalar
    # inf/inf warning like the other mirrored-NaN oracle paths
    with np.errstate(invalid='ignore'):
        return Candidate(sum_x / sum_s, sum_y / sum_s, sum_ang / sum_s,
                         1.0 / math.sqrt(sum_s / len(cands)))


def ukf(kalman_x: np.ndarray, kalman_P: np.ndarray,
        scan_pose: Tuple[float, float, float],
        measurement: Tuple[float, float, float]
        ) -> Tuple[np.ndarray, np.ndarray]:
    """9-state constant-acceleration UKF step (myFA.cpp:404-536).

    Odometry (scan_pose) is injected additively into the state before the
    unscented transform (myFA.cpp:425-427).
    """
    L = 9
    Q = np.diag([1, 1, 1, .01, .01, .01, 1e-4, 1e-4, 1e-4]).astype(np.float64)
    R = np.eye(3, dtype=np.float64)
    t = 1.0
    x = kalman_x.astype(np.float64).copy()
    P = kalman_P.astype(np.float64).copy()
    x[0] += scan_pose[0]
    x[1] += scan_pose[1]
    x[2] += scan_pose[2]

    alpha, ki, beta = 1e-2, 0.0, 2.0
    lam = alpha * alpha * (L + ki) - L
    c = L + lam
    Wm = np.full(2 * L + 1, 0.5 / c)
    Wc = Wm.copy()
    Wm[0] = lam / c
    Wc[0] = lam / c + 1 - alpha * alpha + beta
    c = math.sqrt(c)

    A = c * np.linalg.cholesky(P).T       # c * chol(P).L^T (myFA.cpp:456-460)
    Y = np.tile(x[:, None], (1, L))
    Xset = np.concatenate([x[:, None], Y + A, Y - A], axis=1)  # (9, 19)

    # constant-acceleration prediction
    F = np.eye(L)
    F[0, 3] = F[1, 4] = F[2, 5] = t
    F[3, 6] = F[4, 7] = F[5, 8] = t
    F[0, 6] = F[1, 7] = F[2, 8] = 0.5 * t * t
    Xsig = F @ Xset
    Xmeans = Xsig @ Wm
    Xdiv = Xsig - Xmeans[:, None]
    P1 = Xdiv @ np.diag(Wc) @ Xdiv.T + Q

    Zmeans = Xmeans[:3]
    Zdiv = Xdiv[:3]           # measurement model is identity on states 0-2
    Pzz = Zdiv @ np.diag(Wc) @ Zdiv.T + R
    Pxz = Xdiv @ np.diag(Wc) @ Zdiv.T
    K = Pxz @ np.linalg.inv(Pzz)
    Zdiff = np.array(measurement, dtype=np.float64) - Zmeans
    new_x = Xmeans + K @ Zdiff
    new_P = P1 - K @ Pxz.T
    return new_x, new_P


def feature_association(scan_lines: np.ndarray, map_lines: np.ndarray,
                        scan_pts: np.ndarray,
                        lidar_pose: Tuple[float, float],
                        last_pose: Tuple[float, float, float],
                        kalman_x: np.ndarray, kalman_P: np.ndarray,
                        scan_pose: Tuple[float, float, float],
                        map_cache: np.ndarray,
                        z_occ_max_dis: float = 1.0) -> FAResult:
    """Full matching + fusion step (myFA.cpp:13-184)."""
    cands = scan_to_map_candidates(
        scan_lines, map_lines, scan_pts, lidar_pose, last_pose, map_cache,
        z_occ_max_dis)
    if not cands:
        return FAResult(KALMAN_RESET_X.copy(), KALMAN_RESET_P.copy(),
                        float('inf'), 0)
    # the reference tolerates |x+1| < 1e-4 here (myFA.cpp:99) though the
    # per-candidate gate escape is an exact == -1 (myFA.cpp:330)
    if abs(last_pose[0] + 1) < 1e-4:
        best = min(cands, key=lambda cd: cd.score)
        new_x = kalman_x.copy()
        new_x[0], new_x[1], new_x[2] = best.x, best.y, best.ang
        return FAResult(new_x, kalman_P.copy(), best.score, len(cands))
    est = fuse_candidates(cands)
    new_x, new_P = ukf(kalman_x, kalman_P, scan_pose,
                       (est.x, est.y, est.ang))
    return FAResult(new_x, new_P, est.score, len(cands))
