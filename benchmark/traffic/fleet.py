"""fleet: one SessionPool serving N robots on one map, open loop.

Each robot sends a ROS-shaped 360-ray scan every ``period_s`` from a
phase drawn from the seed, replaying one of ``walks`` seeded walks
forwards and then backwards from its own start.  A robot's scans queue
on the client side; a tick starts as soon as the previous one returned
and any scan is due, and takes each robot's oldest due scan.  A scan's
latency runs from the moment it was due to its answer on the host.
"""

from __future__ import annotations

import collections
import heapq
import math

import numpy as np

from harness import kind
from reference import judge as rj
from traffic import scene


class Run(kind.Base):
    serving = ("pool.submit", "pool.step")

    def setup(self):
        wl, c = self.wl, self.config
        rng = np.random.default_rng([self.seed, 1])
        self.building = scene.building(c, c["scene_seed"])
        self.lines = scene.wall_lines(self.building.walls)
        self.walks = scene.walks(self.building, self.seed, wl["walks"],
                                 c["frames"], c["range_m"], wl["step_m"],
                                 wl["walk_radius_m"], self.device
                                 if self.mode != "control" else "cpu")
        self.period = 1.0 / c["lidar_hz"]
        self.robots = kind.draw_robots(rng, self.walks, wl["robots"],
                                       self.period)
        self.next_t = {r.sid: 0 for r in self.robots}
        # every robot's stream steps and answered poses (each held to its
        # walk), and the judged robots' whole answers
        self.taken = {r.sid: [] for r in self.robots}
        self.poses = {r.sid: [] for r in self.robots}
        self.answers = {r.sid: [] for r in self.judged()}
        if self.mode == "control":
            return
        import torch
        from lsdtpu_torch.mapprep.distance import create_map_cache
        from lsdtpu_torch.runtime.serving import SessionPool
        H, W = self.building.grid.shape
        self.field = create_map_cache(self.building.grid, c["resol"],
                                      dtype=torch.float32,
                                      device=self.device)
        self.pool = SessionPool(wl["robots"], (H, W), self.cfg,
                                dtype=np.float32, device=self.device)
        for r in self.robots:
            self.pool.open_session(r.sid, self.lines, self.field,
                                   *self.geometry())
        # warm-up: each robot's first scans (the relock, then tracking)
        for _ in range(wl["warmup_scans"]):
            for r in self.robots:
                self._submit(r)
            self._record(self.pool.step())

    def _submit(self, r):
        from lsdtpu_torch.runtime.online import laser_scan_to_polar
        t = self.next_t[r.sid]
        self.next_t[r.sid] += 1
        ranges, angles = laser_scan_to_polar(r.scan(t), 0.0, scene.SCAN_INC)
        self.pool.submit_scan(r.sid, ranges, angles, r.odom(t))
        self.taken[r.sid].append(t)

    def _record(self, res):
        for sid, ans in res.items():
            self.poses[sid].append(ans["pose"])
        for sid, ans in self.answers.items():
            if sid in res:
                ans.append(res[sid])

    def schedule(self, seconds):
        """(due, robot index) of every scan due in the window, by time."""
        ev = []
        for i, r in enumerate(self.robots):
            k = 0
            while r.phase + k * self.period < seconds:
                ev.append((r.phase + k * self.period, i))
                k += 1
        heapq.heapify(ev)
        return ev

    def window(self, seconds, trace=None):
        sp = self.spans
        rounds0 = self.rdp_rounds()
        ev = self.schedule(seconds)
        self.attempted = len(ev)
        queues = collections.defaultdict(collections.deque)
        lat, late = [], []
        ticks = carried = 0
        # the traced slice is the window's last trace_seconds: stopping
        # the profiler stalls the host for seconds, so it stops after
        # the window has closed
        tr_on, tr_from = False, seconds - self.wl["trace_seconds"]
        self.trace_scans = self.trace_ticks = 0
        t0 = self.t0 = kind.now()
        while ev or any(queues.values()):
            tn = kind.now()
            while ev and t0 + ev[0][0] <= tn:
                due, i = heapq.heappop(ev)
                queues[i].append(t0 + due)
            pending = [i for i, q in queues.items() if q]
            if not pending:
                kind.wait_until(t0 + ev[0][0])
                continue
            if trace is not None and not tr_on and tn - t0 >= tr_from:
                trace.start()
                tr_on = True
            dues = {}
            with sp.span("pool.submit"):
                for i in pending:
                    due = queues[i].popleft()
                    late.append((kind.now() - due) * 1e3)
                    dues[self.robots[i].sid] = due
                    self._submit(self.robots[i])
            with sp.span("pool.step"):
                res = self.pool.step()
            t_ret = kind.now()
            self._record(res)
            for sid, due in dues.items():
                lat.append((t_ret - due) * 1e3 if sid in res else math.inf)
            ticks += 1
            carried += len(res)
            if tr_on:
                self.trace_ticks += 1
                self.trace_scans += len(res)
        if tr_on:
            trace.stop()
        self.lat, self.late = lat, late
        sp.counters.update(ticks=ticks, scans_carried=carried,
                           slots_stepped=ticks * self.pool.capacity,
                           featurize_calls=ticks,
                           rdp_rounds=self.rdp_rounds() - rounds0)

    def end_to_end(self):
        return self.latency_metrics()

    def slice_counts(self):
        return {"scans": self.trace_scans, "ticks": self.trace_ticks}

    def notes(self):
        return kind.latency_lines(self.lat, self.late) + [
            f"pool capacity={self.pool.capacity} ticks="
            f"{self.spans.counters['ticks']} scans carried="
            f"{self.spans.counters['scans_carried']}"]

    def release(self):
        self.pool = self.field = None
        self.free_device()

    # -- correctness ---------------------------------------------------------
    def judged(self):
        rng = np.random.default_rng([self.seed, 2])
        n = min(self.wl["judge_robots"], len(self.robots))
        return [self.robots[i] for i in
                sorted(rng.choice(len(self.robots), n, replace=False))]

    def judge(self):
        field = self.reference_field(self.building.grid)
        sessions, truth = [], []
        for r in self.judged():
            if self.mode == "control":
                n = self.wl["warmup_scans"] + int(math.ceil(
                    (self.seconds - r.phase) / self.period))
                ts = list(range(n))
                steps = kind.reference_steps(r, ts)
                answers = rj.control_answers(steps, self.lines, field,
                                             self.geometry())
                truth.append(rj.truth_gaps(
                    [a["pose"] for a in answers],
                    self.truth_px(r.walk, [r.frame(t) for t in ts])))
            else:
                ts = self.taken[r.sid][:len(self.answers[r.sid])]
                steps = kind.reference_steps(r, ts)
                answers = self.answers[r.sid]
            sessions.append((steps, answers))
        gaps = rj.follow_sessions(sessions, self.lines, field,
                                  self.geometry())
        if self.mode != "control":
            for r in self.robots:
                ts = self.taken[r.sid][:len(self.poses[r.sid])]
                truth.append(rj.truth_gaps(
                    self.poses[r.sid],
                    self.truth_px(r.walk, [r.frame(t) for t in ts])))
        checks, self.readings = rj.compare(
            rj.stream_numbers(gaps, truth), self.wl["limits"])
        return checks
