"""mapswitch: a robot entering new floors, closed loop.

Each switch hands OnlineLocalizer.set_map a new occupancy grid of the
configuration's extent and wall count (map i drawn from seed + i, so no
cache can help) and then pushes the robot's first scan on it, taken at
the map's centre; the switches run back to back, since the robot waits
for its map.  A switch under way when the window closes finishes and
counts.

Every switch's first pose is judged; the field and the line set of a
sample of them (``judge_maps``).  The traffic file's ``engine`` sizes
the candidate buffer for a relock over the whole map: a first scan on
these maps enumerates up to ~3,700 hypotheses, and the default 2,048
keeps the first 2,048 (flagged as ``candidate_overflow``), which loses
the reference's best on some maps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import kind
from reference import judge as rj
from traffic import scene


@dataclasses.dataclass
class Switch:
    building: scene.Building
    scan: np.ndarray          # float32 ROS ranges at the map's centre


class Run(kind.Base):
    serving = ("mapswitch.set_map", "mapswitch.first_push")

    def _switch(self, seed, i):
        c = self.config
        b = scene.building(c, seed)
        r = scene.cast_scans(b, np.asarray([b.centre]), c["range_m"],
                             self.device if self.mode != "control" else "cpu")
        rng = np.random.default_rng([self.seed, 3, i])
        hit = np.isfinite(r)
        r[hit] = r[hit] + rng.normal(0, 0.003, int(hit.sum()))
        return Switch(b, r[0].astype(np.float32))

    def setup(self):
        n = self.wl["maps"]
        self.maps = [self._switch(self.seed + i, i) for i in range(n)]
        self.done = []            # (map index, n_lines, ctx, answer)
        if self.mode == "control":
            return
        from lsdtpu_torch.runtime.online import OnlineLocalizer
        self.loc = OnlineLocalizer(self.cfg, mode="tracking",
                                   dtype=np.float32, device=self.device)
        warm = self._switch(self.seed + n, n)     # a map of its own
        self._run(warm)

    def _run(self, m: Switch):
        sp = self.spans
        b = m.building
        with sp.span("mapswitch.set_map"):
            n_lines = self.loc.set_map(b.grid, b.resol, b.ori_x, b.ori_y)
        with sp.span("mapswitch.first_push"):
            out = self.loc.push_laser_scan(m.scan, 0.0, scene.SCAN_INC,
                                           np.zeros(3))
        return n_lines, out

    def window(self, seconds, trace=None):
        t0 = self.t0 = kind.now()
        i = 0
        while kind.now() - t0 < seconds:
            k = i % len(self.maps)
            if trace is not None and i == 0:
                trace.start()
            n_lines, out = self._run(self.maps[k])
            if trace is not None and i == 0:
                trace.stop()
            self.done.append((k, n_lines, self.loc.ctx, out))
            i += 1
        self.t_end = kind.now()
        self.attempted = i
        self.spans.counters.update(switches=i)

    def end_to_end(self):
        return {"map_to_pose_ms":
                (self.t_end - self.t0) / len(self.done) * 1e3}

    def slice_counts(self):
        return {"switches": 1}

    def notes(self):
        times = [(b - a) / 1e6 for n, a, b in self.spans.spans
                 if n == "mapswitch.set_map"][1:]
        return [f"requests attempted={self.attempted} answered="
                f"{len(self.done)} (closed loop: no schedule, no lateness)",
                f"switches={len(self.done)} maps={len(self.maps)} "
                f"(reused: {max(0, len(self.done) - len(self.maps))}) "
                f"set_map_ms={[round(t, 1) for t in times]}"]

    def release(self):
        self.loc = None
        # every switch keeps its lines, on the host; the judged ones
        # keep their map context, the others' goes
        keep = set(self.judged())
        self.done = [(k, n, ctx.lines[:n].double().cpu().numpy(),
                      ctx if j in keep else None, out)
                     for j, (k, n, ctx, out) in enumerate(self.done)]
        self.free_device()

    def judged(self):
        n = len(self.done) if self.mode != "control" else \
            self.wl["judge_maps"]
        rng = np.random.default_rng([self.seed, 2])
        k = min(self.wl["judge_maps"], n)
        return [int(j) for j in sorted(rng.choice(n, k, replace=False))]

    def judge(self):
        from reference import lsd as rlsd
        field_gap, rec2, rec25, ratio = 0.0, 1.0, 1.0, []
        for j in self.judged():
            m = self.maps[j % len(self.maps)] if self.mode == "control" \
                else self.maps[self.done[j][0]]
            b = m.building
            field = rlsd.create_map_cache(b.grid.copy(), b.resol)
            lines = rlsd.line_segment_detector(b.grid.copy()).lines_info
            if self.mode == "control":
                got_field, got_lines = rj.bf16(field), rj.bf16(lines)
            else:
                _k, _n, got_lines, ctx, _out = self.done[j]
                got_field = ctx.cache.double().cpu().numpy()
            field_gap = max(field_gap, float(np.abs(got_field - field).max()))
            rec2 = min(rec2, line_recall(got_lines, lines, 2.0))
            rec25 = min(rec25, line_recall(got_lines, lines, 25.0))
            ratio.append(len(got_lines) / max(len(lines), 1))
        # the first pose of every switch (the control: as many maps as
        # the fewest switches a run makes)
        if self.mode == "control":
            firsts = [(self.maps[i], None, None)
                      for i in range(self.wl["control_switches"])]
        else:
            firsts = [(self.maps[k], lines, out)
                      for k, _n, lines, _ctx, out in self.done]
        tasks = [(m.building.grid, (m.building.resol, m.building.ori_x,
                                    m.building.ori_y),
                  *scene.ros_to_polar(m.scan), lines, out)
                 for m, lines, out in firsts]
        gaps = rj.relock_gaps(tasks)
        pose = [g["gap"] for g in gaps]
        overflows = sum(bool(out.get("candidate_overflow", False))
                        for _m, _l, out in firsts if out is not None)
        numbers = {"field_gap_max_m": field_gap,
                   "line_recall_2px": rec2, "line_recall_25px": rec25,
                   "line_count_ratio_min": min(ratio),
                   "line_count_ratio_max": max(ratio),
                   "first_pose_gap_median_px": float(np.median(pose)),
                   "first_pose_gap_max_px": max(pose),
                   "first_poses_off_1e-3px": sum(g > 1e-3 for g in pose),
                   "first_poses": len(pose),
                   "first_score_shortfall_max":
                   max(g["shortfall"] for g in gaps),
                   "candidate_overflows": overflows}
        checks, self.readings = rj.compare(numbers, self.wl["limits"])
        return checks


def line_recall(got, want, tol: float) -> float:
    """The share of the reference's lines with a line of ``got`` whose
    endpoints lie within ``tol`` px of theirs, in either order."""
    if len(want) == 0:
        return 1.0
    if len(got) == 0:
        return 0.0
    g = np.asarray(got)[:, 4:8]
    n = 0
    for w in np.asarray(want):
        fwd = np.abs(g - w[4:8]).max(1)
        rev = np.abs(g - w[[6, 7, 4, 5]]).max(1)
        n += bool(np.minimum(fwd, rev).min() <= tol)
    return n / len(want)
