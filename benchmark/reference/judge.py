"""The comparisons that decide ``correct``, and the control.

Every number compared has a limit of its own in the cell's traffic file
(``limits``: ``{"name": {"max": x}}`` or ``{"min": x}``); PERF.md gives
the readings each limit was set from.

Streams (the fleet, the replay): for each sampled session, the
reference follows the program's answers (follow.py) and each answer is
held to the reference's for the same scan:
  * ``pose_gap_max_px``: the widest gap of an answered position, in map
    pixels, over every compared scan (a lost scan's sentinel pose
    against a tracked one reads as that gap);
  * ``score_gap_median``: the median over the compared scans tracked on
    both sides of |score - reference| / reference.  A float32 program
    reads ~1e-7 on most scans and 1e-4 to 7e-2 on the scans where a
    transformed pixel sits on a rounding edge; a field or state kept in
    bfloat16 moves every scan's score by ~5e-4;
  * ``decision_flip_share``: the share of compared scans whose candidate
    count, or whose being tracked, lost or perfect (a candidate of score
    0 fuses to a NaN pose), differs from the reference's; a pose perfect
    on one side only is counted here and not in ``pose_gap_max_px``.
Every session of the window, sampled or not, is also held to the walk
it replays (``truth_gap_px``: the largest over the sessions of the
median gap of a session's tracked positions to the walk's true ones),
so that a fault in lanes the sample missed still shows.
Map switches: the field and the line set against the reference's own
map prep (the oracle's FIFO growth), on a sample of the switches; and on
every switch the first pose against the reference's relock on the
program's own lines and its own field (``relock_gaps``):
  * ``first_pose_gap_median_px``: the median over the switches of the
    gap of the program's first pose to the reference's.  A relock is an
    argmin over hypotheses whose poses rest on floored scan pixels: in
    float32 a scan point on a floor edge moves one hypothesis by a
    pixel and its score by up to a third, so a few relocks in a hundred
    pick another hypothesis, 0.4 to 3.1 px away.  The widest gap swings
    with those; the median does not, and every switch answered a
    pixel off moves it.

A number with a limit in the cell's traffic file is compared; the others
are printed as readings.

The control (``control_follow``) is the reference computed in
bfloat16, put in the program's place: the field, the map lines, the
scan's points and every stage's result (candidate poses and scores, the
fused pose, the filter's state, the answer) are stored in bfloat16 and
computed from there in float64, as a program keeping its tensors in
bfloat16 computes in float32.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from reference import fa
from reference import lsd
from reference.follow import Follower


def bf16(x):
    """Round to the nearest bfloat16 (ties to even), as float64."""
    a = np.asarray(x, np.float64).astype(np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    keep = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    out = keep.astype(np.uint32).view(np.float32).astype(np.float64)
    out = np.where(np.isfinite(a), out, a.astype(np.float64))
    return out if out.ndim else float(out)


def check(name: str, value: float, limit: dict) -> dict:
    """One compared number against its limit."""
    if "max" in limit:
        ok = bool(value <= limit["max"])
        return {"name": name, "value": value, "limit": limit["max"],
                "op": "<=", "ok": ok}
    ok = bool(value >= limit["min"])
    return {"name": name, "value": value, "limit": limit["min"], "op": ">=",
            "ok": ok}


def pose_gap(p, q) -> float:
    """The larger axis gap of two (x, y) positions; NaN equals NaN."""
    p = np.asarray(p[:2], np.float64)
    q = np.asarray(q[:2], np.float64)
    both = np.isnan(p) & np.isnan(q)
    d = np.where(both, 0.0, np.abs(p - q))
    return float(np.nan_to_num(d, nan=np.inf).max())


def stream_gaps(steps: List[dict], answers: List[dict], lines, field,
                geom) -> Dict[str, list]:
    """Follow one session: ``steps`` are the scans in the order the
    program took them (``ranges``, ``angles``, ``odom_prev``,
    ``odom_cur``), ``answers`` the program's answers.  Returns the
    per-scan gaps."""
    fol = Follower(lines, field, *geom)
    pg, sg, flips = [], [], 0
    for st, ans in zip(steps, answers):
        ref = fol.step(st["ranges"], st["angles"], st["odom_prev"],
                       st["odom_cur"], ans["pose"])
        # a perfect candidate (score 0: every pixel on a wall cell) fuses
        # to a NaN pose; where one pixel sits on a rounding edge, one
        # side reads it and the other does not: a decision, not a gap
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


_SHARED = {}


def _share(lines, field, geom):
    _SHARED.update(lines=lines, field=field, geom=geom)


def _follow(session):
    steps, answers = session
    return stream_gaps(steps, answers, _SHARED["lines"], _SHARED["field"],
                       _SHARED["geom"])


WORKERS = 6     # host processes that follow sessions (a card's host has 8 cores)


def follow_sessions(sessions, lines, field, geom):
    """``stream_gaps`` of each (steps, answers) session, on up to WORKERS
    host processes, one core left to the rest: the reference runs after
    the window, and each session is a chain of its own.  Every process
    it starts has ended when it returns."""
    n = min(len(sessions), WORKERS, max(1, (os.cpu_count() or 1) - 1))
    if n <= 1:
        return [stream_gaps(st, ans, lines, field, geom)
                for st, ans in sessions]
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        n, initializer=_share, initargs=(lines, field, geom))
    try:
        out = pool.map(_follow, sessions, chunksize=1)
    finally:
        pool.close()
        pool.join()
    return out


def score_shortfall(got: float, want: float) -> float:
    """How far the reference's score of the program's pose lies above
    the reference's best, as a share of the best."""
    if got == want:
        return 0.0
    if math.isfinite(got) and math.isfinite(want) and want > 0:
        return (got - want) / want
    return math.inf


def relock_gap(task) -> dict:
    """One relock (the first scan on a new map) against the reference's.
    ``task``: the map's grid, its (resol, ori_x, ori_y), the scan's valid
    ranges and angles, the lines the program built (None: the control,
    which builds the reference's lines and answers in bfloat16) and the
    program's answer.  The reference relocks on the program's own lines
    and its own field, so both sides pick among the same hypotheses."""
    grid, geom, ranges, angles, lines, answer = task
    field = lsd.create_map_cache(grid.copy(), geom[0])
    if lines is None:
        own = lsd.line_segment_detector(grid.copy()).lines_info
        lines = bf16(own)
        answer = Bf16Follower(own, field, *geom).step(
            ranges, angles, np.zeros(3), np.zeros(3))
    fol = Follower(lines, field, *geom)
    want = fol.step(ranges, angles, np.zeros(3), np.zeros(3))
    return {"gap": pose_gap(answer["pose"], want["pose"]),
            "shortfall": score_shortfall(fol.score_pose(answer["pose"]),
                                         fol.score_pose(want["pose"]))}


def relock_gaps(tasks) -> List[dict]:
    """``relock_gap`` of each task, on up to WORKERS host processes (as
    ``follow_sessions``)."""
    n = min(len(tasks), WORKERS, max(1, (os.cpu_count() or 1) - 1))
    if n <= 1:
        return [relock_gap(t) for t in tasks]
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(n)
    try:
        return pool.map(relock_gap, tasks, chunksize=1)
    finally:
        pool.close()
        pool.join()


def truth_gaps(poses, truth) -> float:
    """The median over one session's tracked answers (a finite position,
    not the lost sentinel) of the larger axis gap of the answered
    position to the walk's true one (``truth``, (n, 2)), in pixels; inf
    where no answer was tracked."""
    p = np.asarray(poses, np.float64).reshape(-1, 3)[:, :2]
    lost = np.all(np.abs(p + 1.0) < 1e-4, axis=1)
    keep = np.isfinite(p).all(1) & ~lost
    d = np.abs(p - np.asarray(truth, np.float64)).max(1)[keep]
    return float(np.median(d)) if len(d) else math.inf


def compare(numbers: dict, limits: dict):
    """The numbers with a limit are compared; the rest are readings."""
    checks = [check(k, v, limits[k]) for k, v in numbers.items()
              if k in limits]
    readings = {k: v for k, v in numbers.items() if k not in limits}
    return checks, readings


def stream_numbers(gaps: List[Dict[str, list]], truth: List[float]) -> dict:
    """Every number of a stream cell: the sampled sessions' gaps to the
    reference and every session's median gap to its walk."""
    pose = [g for s in gaps for g in s["pose"]]
    score = np.asarray([g for s in gaps for g in s["score"]])
    q = (lambda p: float(np.quantile(score, p)) if len(score) else math.inf)
    return {
        "pose_gap_max_px": max(pose) if pose else math.inf,
        "score_gap_median": q(0.5),
        "decision_flip_share": sum(s["flips"] for s in gaps) /
        max(sum(s["scans"] for s in gaps), 1) if gaps else math.inf,
        "truth_gap_px": max(truth) if truth else math.inf,
        "score_gap_p90": q(0.9),
        "score_gap_p99": q(0.99),
        "score_gap_max": q(1.0),
        "decision_flips": sum(s["flips"] for s in gaps),
        "compared_scans": sum(s["scans"] for s in gaps),
        "truth_sessions": len(truth),
    }


class Bf16Follower(Follower):
    """The control: the reference with every stored value in bfloat16,
    answering in the program's place (it follows its own answers)."""

    def __init__(self, lines, field, resol, ori_x, ori_y, **kw):
        super().__init__(bf16(lines), bf16(field), resol, ori_x, ori_y,
                         **kw)
        self._score = fa.calc_score

    def step(self, ranges, angles, odom_prev, odom_cur,
             program_pose: Optional[np.ndarray] = None) -> dict:
        real_cands = fa.scan_to_map_candidates
        real_fuse, real_ukf = fa.fuse_candidates, fa.ukf

        def cands(*a, **k):
            return [fa.Candidate(bf16(c.x), bf16(c.y), bf16(c.ang),
                                 bf16(c.score)) for c in real_cands(*a, **k)]

        def fuse(cs):
            e = real_fuse(cs)
            return fa.Candidate(bf16(e.x), bf16(e.y), bf16(e.ang),
                                bf16(e.score))

        def ukf(*a):
            x, P = real_ukf(*a)
            return bf16(x), bf16(P)

        fa.scan_to_map_candidates, fa.fuse_candidates, fa.ukf = \
            cands, fuse, ukf
        try:
            out = super().step(bf16(ranges), bf16(angles), odom_prev,
                               odom_cur, None)
        finally:
            fa.scan_to_map_candidates, fa.fuse_candidates, fa.ukf = \
                real_cands, real_fuse, real_ukf
        out["pose"] = bf16(out["pose"])
        out["score"] = bf16(out["score"])
        return out


def control_answers(steps: List[dict], lines, field, geom) -> List[dict]:
    """The control's answers for one session's scans."""
    fol = Bf16Follower(lines, field, *geom)
    return [fol.step(st["ranges"], st["angles"], st["odom_prev"],
                     st["odom_cur"]) for st in steps]
