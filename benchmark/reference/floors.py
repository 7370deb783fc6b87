"""The floor reference of a building's fleet, float64 on the host: which
floor each robot's scans are matched on, and the global relock over
every gated hypothesis of a floor change's first scan.

A copy of the port's lsdtpu_torch/oracle/floors.py (the relock and the
floor table), made self-contained over this directory's frozen oracle:
the relock scores every (scan line, map line, 4 alignments) hypothesis
that passes the length gate (myFA.cpp:29-41; no HMM gate on a relock,
:330) on the field (CalcScore, :357-396), with no cap on their number,
and the first of the lowest scores under 3 wins (:96-108), in numpy
(the port's copy computes in torch; this directory imports numpy
alone).  A robot's stay on a floor is a session of its own,
followed by follow.py from the sentinel.

``judge_floors`` follows each stay (``stream_gaps``: judge.stream_gaps
with a relock's ties, below) and holds a floor change's first answer to
the relock of the same scan on the program's lines and the reference's
field, as judge.relock_gap does for a map switch.

A relock's ties.  Two hypotheses whose transformed pixels land on the
same field values score the same in float64 (on the lift's floors, two
poses 3.8 px apart), and the reference takes the first of them in its
loops' order.  A float32 program sums those values in another order
and may end an ulp lower on either, so its relock may answer with any
of the tied hypotheses.  ``stream_gaps`` holds a
relock's answer to the nearest of the hypotheses whose scores equal the
minimum (to TIE_REL, float64 summation order), and follows that one; a
pose with a higher score than the minimum still reads its full gap."""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from reference import rdp
from reference.lsd import c_round

SENTINEL = (-1.0, -1.0, 0.0)
# two scores tie when they differ by no more than this share: equal but
# for the order of a float64 sum
TIE_REL = 1e-12


class Relock(NamedTuple):
    pose: np.ndarray     # (3,) x, y in map pixels, heading in degrees
    score: float         # the winner's CalcScore; inf when none passes
    n_accepted: int      # hypotheses scoring under score_accept
    n_gated: int         # hypotheses past the length gate, all scored
    ties: np.ndarray = np.zeros((0, 3))   # (T, 3) every pose scoring the
    #                      minimum (to TIE_REL), ``pose`` first


def _direction(sx, sy, ex, ey):
    """normalizedLineDirection (myFA.cpp:274-305) of arrays of
    endpoints, branch for branch as fa.normalized_line_direction."""
    vert = (sx == ex) & (sy != ey)
    horiz = (sx != ex) & (sy == ey)
    with np.errstate(invalid="ignore", divide="ignore"):
        slope = np.arctan((ey - sy) / (ex - sx)) * 180.0 / math.pi
    ang = np.where(vert, np.where(sy < ey, 90.0, -90.0),
                   np.where(horiz, np.where(sx < ex, 0.0, 180.0), slope))
    return np.where((ang < 0) & (sx > ex), ang + 180.0,
                    np.where((ang > 0) & (sx > ex), ang - 180.0, ang))


def _c_round(v):
    return np.where(v >= 0, np.floor(v + 0.5),
                    np.ceil(v - 0.5)).astype(np.int64)


def _scores(field, px, py, ca, sa, sx, sy, mx, my, z):
    """CalcScore (fa.calc_score) of C hypotheses at once: (C,)."""
    rows, cols = field.shape
    tx = (px[None] - sx[:, None]) * ca[:, None] - \
        (py[None] - sy[:, None]) * sa[:, None] + mx[:, None]
    ty = (px[None] - sx[:, None]) * sa[:, None] + \
        (py[None] - sy[:, None]) * ca[:, None] + my[:, None]
    x, y = _c_round(tx), _c_round(ty)
    inside = (y >= 0) & (y < rows) & (x >= 0) & (x < cols)
    vals = field[np.clip(y, 0, rows - 1), np.clip(x, 0, cols - 1)]
    at_cap = vals >= z
    n_all = float(px.shape[0])
    n_valid = inside.sum(1).astype(np.float64)
    s_valid = np.where(inside & ~at_cap, vals, 0.0).sum(1)
    s_max = 10.0 * (inside & at_cap).sum(1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        score = (s_valid + s_max) / n_valid + \
            10.0 * (n_all - n_valid) / n_all
    return np.where(n_valid < 0.7 * n_all, np.inf, score)


def relock(scan_lines, map_lines, scan_pts, lidar_pose, field,
           z_occ_max_dis: float = 1.0, ignore_scan_length: float = 40.0,
           scan_to_map_diff: float = 0.35, score_accept: float = 3.0,
           chunk: int = 2048) -> Relock:
    """The global relock of one scan: every hypothesis past the length
    gate scored on ``field``, the first of the lowest scores among those
    under ``score_accept`` winning.  scan_lines (S, 10) and map_lines
    (M, 10) linesInfo rows, scan_pts (P, 2) scan pixels, lidar_pose the
    rounded lidar pixel."""
    s = np.asarray(scan_lines, np.float64).reshape(-1, 10)
    m = np.asarray(map_lines, np.float64).reshape(-1, 10)
    fld = np.asarray(field, np.float64)
    pts = np.asarray(scan_pts, np.float64).reshape(-1, 2)
    lx, ly = float(lidar_pose[0]), float(lidar_pose[1])
    s_len, m_len = s[:, 8], m[:, 8]
    diff = s_len * scan_to_map_diff
    gate = (s_len >= ignore_scan_length)[:, None] & \
        ~(m_len[None] < (s_len - diff)[:, None]) & \
        ~(m_len[None] > (s_len + diff)[:, None])               # (S, M)
    # hypothesis h (myFA.cpp:194-235): map forwards for h < 2, scan
    # forwards for even h
    mfwd = np.array([True, True, False, False])
    sfwd = np.array([True, False, True, False])
    mp = np.where(mfwd[None, :, None], m[:, None, 4:8],
                  m[:, None, [6, 7, 4, 5]])                   # (M, 4, 4)
    sp = np.where(sfwd[None, :, None], s[:, None, 4:8],
                  s[:, None, [6, 7, 4, 5]])                   # (S, 4, 4)
    m_ang = _direction(*np.moveaxis(mp, -1, 0))               # (M, 4)
    s_ang = _direction(*np.moveaxis(sp, -1, 0))               # (S, 4)
    # (scan line, map line, hypothesis) order, the oracle's loops'
    si, mi, hi = np.nonzero(np.broadcast_to(gate[:, :, None],
                                            gate.shape + (4,)))
    n = int(si.shape[0])
    if n == 0:
        return Relock(np.asarray(SENTINEL), math.inf, 0, 0)
    ang = m_ang[mi, hi] - s_ang[si, hi]
    rad = ang / 180.0 * math.pi
    ca, sa = np.cos(rad), np.sin(rad)
    sx, sy = sp[si, hi, 0], sp[si, hi, 1]
    mx, my = mp[mi, hi, 0], mp[mi, hi, 1]
    score = np.concatenate([
        _scores(fld, pts[:, 0], pts[:, 1], *(v[c:c + chunk] for v in
                                             (ca, sa, sx, sy, mx, my)),
                z_occ_max_dis) for c in range(0, n, chunk)])
    acc = score < score_accept
    n_acc = int(acc.sum())
    if n_acc == 0:
        return Relock(np.asarray(SENTINEL), math.inf, 0, n)
    best = int(np.argmin(np.where(acc, score, np.inf)))
    low = float(score[best])
    tied = [best] + [int(t) for t in np.nonzero(
        acc & (score <= low + TIE_REL * low))[0] if t != best]
    poses = []
    for t in tied:
        x = (lx - sx[t]) * ca[t] - (ly - sy[t]) * sa[t] + mx[t]
        y = (lx - sx[t]) * sa[t] + (ly - sy[t]) * ca[t] + my[t]
        a = float(ang[t])
        while a <= -180:
            a += 360
        while a > 180:
            a -= 360
        poses.append([float(x), float(y), a])
    return Relock(np.asarray(poses[0]), low, n_acc, n, np.asarray(poses))


def relock_scan(ranges, angles, lines, field, resol: float, ori_x: float,
                ori_y: float) -> Relock:
    """``relock`` of a scan's valid points (meters, radians)."""
    fs = rdp.feature_scan(np.asarray(ranges, np.float64),
                          np.asarray(angles, np.float64), resol, ori_x,
                          ori_y)
    lidar = [float(c_round(np.float64(v))) for v in fs.lidar_pos[:2]]
    return relock(fs.lines_info, lines, fs.scan_im_point, lidar, field)


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


_MAPS: dict = {}


def _share(maps, geom):
    _MAPS.update(maps=maps, geom=geom)


def first_pose_gap(task) -> dict:
    """One floor change's first answer against the reference's relock of
    the same scan on that floor.  ``task``: the floor, the scan's valid
    ranges and angles, and the program's answer."""
    from reference.judge import pose_gap
    floor, ranges, angles, answer = task
    lines, field = _MAPS["maps"][floor]
    want = relock_scan(ranges, angles, lines, field, *_MAPS["geom"])
    return {"gap": pose_gap(answer["pose"], want.pose),
            "n_gated": want.n_gated, "n_accepted": want.n_accepted}


def nearest_tie(ties: np.ndarray, pose) -> np.ndarray:
    """Of a relock's tied minimum poses, the one nearest ``pose`` (the
    first where the gaps are equal)."""
    from reference.judge import pose_gap
    gaps = [pose_gap(pose, t) for t in ties]
    return np.asarray(ties[int(np.argmin(gaps))], np.float64)


def stream_gaps(steps: List[dict], answers: List[dict], lines, field,
                geom) -> Dict[str, list]:
    """judge.stream_gaps of one session, a relock's answer held to the
    nearest of its tied minimum poses (module docstring): on a scan the
    reference relocks (its last pose the sentinel) where the program's
    pose is not the reference's, the reference's answer and its filter
    take the tie nearest the program's pose."""
    from reference.follow import Follower
    from reference.judge import pose_gap
    fol = Follower(lines, field, *geom)
    pg, sg, flips = [], [], 0
    for st, ans in zip(steps, answers):
        relocking = fol.prev_pose[0] == -1
        ref = fol.step(st["ranges"], st["angles"], st["odom_prev"],
                       st["odom_cur"], ans["pose"])
        if relocking and math.isfinite(ref["score"]) and \
                pose_gap(ans["pose"], ref["pose"]) > 0:
            ties = relock_scan(st["ranges"], st["angles"], lines, field,
                               *geom).ties
            if len(ties) > 1:
                ref["pose"] = nearest_tie(ties, ans["pose"])
                fol.x = fol.x.copy()
                fol.x[:3] = ref["pose"]
        # as judge.stream_gaps: a perfect candidate (score 0) fuses to a
        # NaN pose, a decision and not a gap
        perfect = (bool(np.isnan(np.asarray(ans["pose"][:2], float)).any()),
                   bool(np.isnan(ref["pose"][:2]).any()))
        if perfect[0] == perfect[1]:
            pg.append(pose_gap(ans["pose"], ref["pose"]))
        s, r = float(ans["score"]), ref["score"]
        if math.isfinite(s) and math.isfinite(r) and r > 0:
            sg.append(abs(s - r) / r)
        if perfect[0] != perfect[1] or math.isfinite(s) != math.isfinite(r) \
                or int(ans["n_candidates"]) != ref["n_candidates"]:
            flips += 1
    return {"pose": pg, "score": sg, "flips": flips, "scans": len(steps)}


def stay_gaps(task) -> dict:
    """``stream_gaps`` of one stay on a floor: ``task`` the floor, the
    stay's steps and the program's answers."""
    floor, steps, answers = task
    return stream_gaps(steps, answers, *_MAPS["maps"][floor],
                       _MAPS["geom"])


def _one(task):
    what, t = task
    return (stay_gaps if what == "stay" else first_pose_gap)(t)


WORKERS = 6


def judge_floors(stays, changes, maps, geom):
    """``stay_gaps`` of each stay task and ``first_pose_gap`` of each
    change task, ``maps`` {floor: (lines, field)}, on up to WORKERS host
    processes (as judge.follow_sessions; one pool for both); every
    process it starts has ended when it returns."""
    tasks = [("stay", t) for t in stays] + [("change", t) for t in changes]
    n = min(len(tasks), WORKERS, max(1, (os.cpu_count() or 1) - 1))
    if n <= 1:
        _share(maps, geom)
        out = [_one(t) for t in tasks]
    else:
        import multiprocessing
        pool = multiprocessing.get_context("spawn").Pool(
            n, initializer=_share, initargs=(maps, geom))
        try:
            out = pool.map(_one, tasks, chunksize=1)
        finally:
            pool.close()
            pool.join()
    return out[:len(stays)], out[len(stays):]
