"""The reference of a fleet whose robots change floor: which map each
robot's scans are matched on, and the global relock over every gated
hypothesis, float64 on the host.

A building's fleet server holds one session per robot.  A robot that
rides the lift to another floor leaves its session on one floor's map
and opens one on the other's, and its next scan relocks there: every
(scan line, map line, 4 alignments) hypothesis that passes the length
gate (myFA.cpp:29-41; a relock has no HMM gate, :330) is scored on the
field (CalcScore, :357-396) and the minimum-score pose wins (:96-108).
``relock`` scores all of them, however many there are, in plain
PyTorch.  Tracking scans between floor changes go through the oracle's
matcher (fa.feature_association).  ``FloorTable`` says which floor each
scan of a robot's stream is matched on; the state returns to the
(-1, -1) sentinel at each floor change and after a lost scan, and
``follow`` answers a robot's stream by those rules.

It imports no module of the port outside the oracle: torch for the
relock's arithmetic on the CPU, the oracle's numpy modules for the
rest."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from lsdtpu_torch.oracle import fa as ofa
from lsdtpu_torch.oracle import rdp as ordp
from lsdtpu_torch.oracle.lsd import _atand, c_round, cosd, sind

F64 = torch.float64
SENTINEL = (-1.0, -1.0, 0.0)


class Relock(NamedTuple):
    pose: np.ndarray     # (3,) x, y in map pixels, heading in degrees
    score: float         # the winner's CalcScore; inf when none passes
    n_accepted: int      # hypotheses scoring under score_accept
    n_gated: int         # hypotheses past the length gate, all scored


def _direction(sx, sy, ex, ey):
    """normalizedLineDirection (myFA.cpp:274-305) of tensors of
    endpoints, branch for branch as fa.normalized_line_direction."""
    vert = (sx == ex) & (sy != ey)
    horiz = (sx != ex) & (sy == ey)
    ang = torch.where(vert, torch.where(sy < ey, 90.0, -90.0),
                      torch.where(horiz, torch.where(sx < ex, 0.0, 180.0),
                                  torch.atan((ey - sy) / (ex - sx))
                                  * 180.0 / math.pi))
    return torch.where((ang < 0) & (sx > ex), ang + 180.0,
                       torch.where((ang > 0) & (sx > ex), ang - 180.0, ang))


def _c_round(v):
    return torch.where(v >= 0, torch.floor(v + 0.5),
                       torch.ceil(v - 0.5)).to(torch.int64)


def _scores(field, px, py, ca, sa, sx, sy, mx, my, z):
    """CalcScore (fa.calc_score) of C hypotheses at once: (C,)."""
    rows, cols = field.shape
    tx = (px[None] - sx[:, None]) * ca[:, None] - \
        (py[None] - sy[:, None]) * sa[:, None] + mx[:, None]
    ty = (px[None] - sx[:, None]) * sa[:, None] + \
        (py[None] - sy[:, None]) * ca[:, None] + my[:, None]
    x, y = _c_round(tx), _c_round(ty)
    inside = (y >= 0) & (y < rows) & (x >= 0) & (x < cols)
    vals = field[y.clamp(0, rows - 1), x.clamp(0, cols - 1)]
    at_cap = vals >= z
    n_all = float(px.shape[0])
    n_valid = inside.sum(1).to(F64)
    s_valid = torch.where(inside & ~at_cap, vals, 0.0).sum(1)
    s_max = 10.0 * (inside & at_cap).sum(1).to(F64)
    score = (s_valid + s_max) / n_valid + 10.0 * (n_all - n_valid) / n_all
    return torch.where(n_valid < 0.7 * n_all, torch.inf, score)


def relock(scan_lines, map_lines, scan_pts, lidar_pose, field,
           z_occ_max_dis: float = 1.0, ignore_scan_length: float = 40.0,
           scan_to_map_diff: float = 0.35, score_accept: float = 3.0,
           chunk: int = 2048) -> Relock:
    """The global relock of one scan: every hypothesis past the length
    gate scored on ``field``, the first of the lowest scores among those
    under ``score_accept`` winning (fa.scan_to_map_candidates, then the
    first frame's min, in its enumeration order).  scan_lines (S, 10) and
    map_lines (M, 10) linesInfo rows, scan_pts (P, 2) scan pixels,
    lidar_pose the rounded lidar pixel."""
    s = torch.as_tensor(np.asarray(scan_lines, np.float64)).reshape(-1, 10)
    m = torch.as_tensor(np.asarray(map_lines, np.float64)).reshape(-1, 10)
    fld = torch.as_tensor(np.asarray(field, np.float64))
    pts = torch.as_tensor(np.asarray(scan_pts, np.float64)).reshape(-1, 2)
    lx, ly = float(lidar_pose[0]), float(lidar_pose[1])
    s_len, m_len = s[:, 8], m[:, 8]
    diff = s_len * scan_to_map_diff
    gate = (s_len >= ignore_scan_length)[:, None] & \
        ~(m_len[None] < (s_len - diff)[:, None]) & \
        ~(m_len[None] > (s_len + diff)[:, None])               # (S, M)
    # hypothesis h (myFA.cpp:194-235): map forwards for h < 2, scan
    # forwards for even h
    mfwd = torch.tensor([True, True, False, False])
    sfwd = torch.tensor([True, False, True, False])
    mp = torch.where(mfwd[None, :, None], m[:, None, 4:8],
                     m[:, None, [6, 7, 4, 5]])                # (M, 4, 4)
    sp = torch.where(sfwd[None, :, None], s[:, None, 4:8],
                     s[:, None, [6, 7, 4, 5]])                # (S, 4, 4)
    m_ang = _direction(*mp.unbind(-1))                        # (M, 4)
    s_ang = _direction(*sp.unbind(-1))                        # (S, 4)
    si, mi, hi = (gate[:, :, None].expand(-1, -1, 4)).nonzero(
        as_tuple=True)
    n = int(si.shape[0])
    if n == 0:
        return Relock(np.asarray(SENTINEL), math.inf, 0, 0)
    ang = m_ang[mi, hi] - s_ang[si, hi]
    rad = ang / 180.0 * math.pi
    ca, sa = torch.cos(rad), torch.sin(rad)
    sx, sy = sp[si, hi, 0], sp[si, hi, 1]
    mx, my = mp[mi, hi, 0], mp[mi, hi, 1]
    score = torch.cat([
        _scores(fld, pts[:, 0], pts[:, 1], *(v[c:c + chunk] for v in
                                             (ca, sa, sx, sy, mx, my)),
                z_occ_max_dis) for c in range(0, n, chunk)])
    acc = score < score_accept
    n_acc = int(acc.sum())
    if n_acc == 0:
        return Relock(np.asarray(SENTINEL), math.inf, 0, n)
    best = int(torch.argmin(torch.where(acc, score, torch.inf)))
    x = (lx - sx[best]) * ca[best] - (ly - sy[best]) * sa[best] + mx[best]
    y = (lx - sx[best]) * sa[best] + (ly - sy[best]) * ca[best] + my[best]
    a = float(ang[best])
    while a <= -180:
        a += 360
    while a > 180:
        a -= 360
    return Relock(np.asarray([float(x), float(y), a]), float(score[best]),
                  n_acc, n)


@dataclasses.dataclass
class FloorTable:
    """Which floor each robot's scans are matched on: ``board`` puts a
    robot on a floor from a step of its stream (its scans counted from
    0 over the whole stream) on, starting from the sentinel."""
    rides: Dict[str, List[Tuple[int, object]]] = dataclasses.field(
        default_factory=dict)

    def board(self, robot: str, floor, step: int = 0) -> None:
        ride = self.rides.setdefault(robot, [])
        if ride and step <= ride[-1][0]:
            raise ValueError(f"{robot}: step {step} is not after the "
                             f"last ride's {ride[-1][0]}")
        ride.append((step, floor))

    def floor_at(self, robot: str, step: int):
        floor = None
        for start, f in self.rides[robot]:
            if start > step:
                break
            floor = f
        if floor is None:
            raise KeyError(f"{robot} is on no floor at step {step}")
        return floor

    def segments(self, robot: str, n: int) -> List[Tuple[object, int, int]]:
        """(floor, first step, end step) of each stay of ``robot`` within
        its first ``n`` steps, in order."""
        ride = self.rides[robot]
        out = []
        for k, (start, floor) in enumerate(ride):
            end = min(ride[k + 1][0], n) if k + 1 < len(ride) else n
            if start < end:
                out.append((floor, start, end))
        return out


def _scan_pose(last_x, ang_rotate, odom_prev, odom_cur, resol, faithful):
    """ScanPose from odometry (main_on_windows.cpp:132-153)."""
    if abs(last_x + 1) < 1e-4:
        return (0.0, 0.0, 0.0)
    theta = sum(ang_rotate) / len(ang_rotate)
    tx = (odom_cur[0] - odom_prev[0]) / resol
    ty = (odom_cur[1] - odom_prev[1]) / resol
    sp_x = tx * cosd(theta) - ty * sind(theta)
    if faithful:
        sp_y = ty * sind(theta) + ty * cosd(theta)   # the reference's bug
    else:
        sp_y = tx * sind(theta) + ty * cosd(theta)
    return (sp_x, sp_y, _atand(odom_cur[2] - odom_prev[2]))


def follow_stay(scans, lines, field, resol: float, ori_x: float,
                ori_y: float, z_occ_max_dis: float = 1.0,
                faithful: bool = True) -> List[dict]:
    """The answers of one stay on a floor, from a fresh state: ``scans``
    are (ranges, angles, odom) of the stay's scans in order (the first
    scan's odometry is its own previous reading, as a session's first
    is).  Each answer: pose, score, n_candidates, and for a relock
    n_gated."""
    kx, kp = ofa.KALMAN_RESET_X.copy(), ofa.KALMAN_RESET_P.copy()
    last = SENTINEL
    ang_rotate: List[float] = []
    is_offset = False
    prev = None
    out = []
    for k, (ranges, angles, odom) in enumerate(scans):
        odom = np.asarray(odom, np.float64)
        odom_prev = odom if prev is None else prev
        prev = odom
        fs = ordp.feature_scan(np.asarray(ranges, np.float64),
                               np.asarray(angles, np.float64), resol,
                               ori_x, ori_y)
        lidar = (float(c_round(np.float64(fs.lidar_pos[0]))),
                 float(c_round(np.float64(fs.lidar_pos[1]))))
        if last[0] == -1:
            r = relock(fs.lines_info, lines, fs.scan_im_point, lidar, field,
                       z_occ_max_dis)
            if r.n_accepted == 0:
                kx, kp = ofa.KALMAN_RESET_X.copy(), ofa.KALMAN_RESET_P.copy()
            else:
                kx = kx.copy()
                kx[:3] = r.pose
            ans = {"score": r.score, "n_candidates": r.n_accepted,
                   "n_gated": r.n_gated}
        else:
            scan_pose = _scan_pose(kx[0], ang_rotate, odom_prev, odom, resol,
                                   faithful)
            res = ofa.feature_association(fs.lines_info, lines,
                                          fs.scan_im_point, lidar, last, kx,
                                          kp, scan_pose, field,
                                          z_occ_max_dis)
            kx, kp = res.kalman_x, res.kalman_P
            ans = {"score": res.score, "n_candidates": res.n_candidates}
        last = (kx[0], kx[1], kx[2])
        ang_diff = kx[2] - _atand(odom[2])
        if abs(ang_diff) > 90 and k == 0:
            is_offset = True
        if is_offset and ang_diff < 0:
            ang_diff += 360
        ang_rotate.append(ang_diff)
        ans["pose"] = kx[:3].copy()
        out.append(ans)
    return out


def follow(table: FloorTable, robot: str, scans, maps, resol: float,
           ori_x: float, ori_y: float, **kw) -> List[dict]:
    """The answers of a robot's whole stream: ``scans`` (ranges, angles,
    odom) of every step in order, ``maps`` {floor: (lines, field)};
    each stay of the table answered on its floor from a fresh state."""
    out = []
    for floor, lo, hi in table.segments(robot, len(scans)):
        lines, field = maps[floor]
        out += follow_stay(scans[lo:hi], lines, field, resol, ori_x, ori_y,
                           **kw)
    return out
