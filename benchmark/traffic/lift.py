"""lift: one SessionPool serving a building's fleet on two floors, the
robots changing floor by lift, open loop.

The configuration's ``floors`` each hold a map of their own (drawn as
the cell's other maps are, from the floor's scene seed); set-up builds
every floor's lines and field with the program's map prep, and the
pool's canvas holds the largest floor.  Half the robots start on each
floor.  Each robot sends a ROS-shaped 360-ray scan every lidar period
from a phase drawn from the seed, replaying a seeded walk of the floor
it is on (``walks`` a floor) from a start and a direction of its own,
as the fleet does; its scans queue on the client side, and a tick takes
each robot's oldest due scan.

The lift: a car arrives every ``car_period_s`` (the first at a seeded
offset), at each floor in turn, carrying ``riders`` robots from the
other floor, drawn by seed among the robots there that have not ridden
for ``rest_s``.  At the arrival each rider's session is closed and a
session opened on the new floor's map (between two ticks, once the
scans it sent on the old floor are answered), and it goes on from a
seeded walk of the new floor at a start the server does not know: its
first scan there, due at the arrival, relocks.  The ride itself is not
modelled.  Every car of the window is drawn in set-up, so a seed gives
the same rides whatever the program's speed.

``map_to_pose_ms`` is the mean over the window's floor changes of the
time from the car's arrival to the rider's first pose on the new floor
(a finite score); a change that never gets one counts as a failed
request.  ``scan_p95_ms`` and ``scan_p50_ms`` cover every scan, riders'
scans included.

``correct``: the fleet's stream checks at its limits on ``judge_robots``
robots, each stay on a floor followed as a session of its own on that
floor's lines and field; every stay of every robot held to its walk;
the first answer of a sample of ``judge_changes`` floor changes against
the relock over every gated hypothesis of the same scan
(reference/floors.py), as the map switch's first poses; and the share
of floor changes whose first answer flagged ``candidate_overflow``.
The reference follows the program's own lines (map prep is the map
switch's to judge) on its own float64 field.
"""

import collections
import dataclasses
import heapq
import math
from typing import List, Optional

import numpy as np

from harness import kind
from reference import floors as rfl
from reference import judge as rj
from traffic import scene

PROGRAM_COUNTERS = ("pool.relock_ticks", "pool.relock_lanes",
                    "pool.relock_overflow")


@dataclasses.dataclass
class Stay:
    """A robot's time on one floor, replaying a walk of that floor from
    a start in a direction, and what it sent and was answered there."""
    floor: int
    walk: scene.Walk
    start: int
    direction: int
    taken: list = dataclasses.field(default_factory=list)   # stream steps
    answers: list = dataclasses.field(default_factory=list)
    arrival: Optional[float] = None   # the car's arrival, host clock
    first_pose_ms: Optional[float] = None   # to the first finite answer

    def frame(self, t: int) -> int:
        return scene.cycle_index(len(self.walk.pos), self.start, t,
                                 self.direction)


@dataclasses.dataclass
class Car:
    at: float            # window seconds
    floor: int           # where it arrives
    riders: list         # robot indices
    stays: list          # each rider's stay on the new floor


class Run(kind.Base):
    serving = ("pool.submit", "pool.step", "lift.ride")

    # -- set-up ------------------------------------------------------------
    def setup(self):
        wl, c = self.wl, self.config
        dev = self.device if self.mode != "control" else "cpu"
        shared = {k: v for k, v in c.items() if k != "floors"}
        self.buildings = [scene.building(fc, fc["scene_seed"]) for fc in
                          (dict(shared, **f) for f in c["floors"])]
        self.walks = [scene.walks(b, self.seed + 1_000_003 * f, wl["walks"],
                                  c["frames"], c["range_m"], wl["step_m"],
                                  wl["walk_radius_m"], dev)
                      for f, b in enumerate(self.buildings)]
        self.period = 1.0 / c["lidar_hz"]
        n = wl["robots"]
        rng = np.random.default_rng([self.seed, 1])
        on = rng.permutation(n) % 2          # half the robots a floor
        self.phase = rng.uniform(0.0, self.period, n)
        self.stays = [[self._stay(rng, int(on[i]))] for i in range(n)]
        self.cars = self._cars(self.seconds, [int(f) for f in on])
        self.sid = [f"r{i}" for i in range(n)]
        if self.mode == "control":
            return
        import torch
        from lsdtpu_torch.mapprep.pipeline import prepare_map
        from lsdtpu_torch.runtime.serving import SessionPool
        self.maps = []
        for b in self.buildings:
            art = prepare_map(b.grid, b.resol, dtype=torch.float32,
                              device=self.device)
            self.maps.append((art.lines_info, art.map_cache, b.resol,
                              b.ori_x, b.ori_y))
        H = max(b.grid.shape[0] for b in self.buildings)
        W = max(b.grid.shape[1] for b in self.buildings)
        self.pool = SessionPool(n, (H, W), self.cfg, dtype=np.float32,
                                device=self.device)
        for i in range(n):
            self.pool.open_session(self.sid[i],
                                   *self.maps[self.stays[i][0].floor])
        # warm-up: every robot's first scans (the relock, then tracking)
        self.next_t = [0] * n
        for _ in range(wl["warmup_scans"]):
            for i in range(n):
                self._submit(i)
            self._record(self.pool.step())

    def _stay(self, rng, floor) -> Stay:
        F = self.config["frames"]
        return Stay(floor, self.walks[floor][int(rng.integers(len(
            self.walks[floor])))], int(rng.integers(2 * F - 2)),
            1 if rng.random() < 0.5 else -1)

    def _cars(self, seconds, where) -> List[Car]:
        """Every car arriving in the window, its riders and their stays
        on the new floor, from the seed."""
        wl = self.wl
        rng = np.random.default_rng([self.seed, 4])
        t = float(rng.uniform(0.0, wl["car_period_s"]))
        floor = int(rng.integers(2))
        rode = {}
        cars = []
        while t < seconds:
            ready = [i for i, f in enumerate(where) if f != floor and
                     t - rode.get(i, -math.inf) >= wl["rest_s"]]
            k = min(wl["riders"], len(ready))
            riders = sorted(int(i) for i in rng.choice(ready, k,
                                                       replace=False))
            stays = [self._stay(rng, floor) for _ in riders]
            for i in riders:
                where[i] = floor
                rode[i] = t
            cars.append(Car(t, floor, riders, stays))
            t += wl["car_period_s"]
            floor = 1 - floor
        return cars

    def _submit(self, i):
        from lsdtpu_torch.runtime.online import laser_scan_to_polar
        stay = self.stays[i][-1]
        t = self.next_t[i]
        self.next_t[i] += 1
        ranges, angles = laser_scan_to_polar(stay.walk.scans[stay.frame(t)],
                                             0.0, scene.SCAN_INC)
        self.pool.submit_scan(self.sid[i], ranges, angles,
                              stay.walk.odom[stay.frame(t)])
        stay.taken.append(t)

    def _record(self, res):
        for i, sid in enumerate(self.sid):
            if sid in res:
                self.stays[i][-1].answers.append(res[sid])

    # -- the window --------------------------------------------------------
    def schedule(self, seconds):
        """(due, order, robot, stay) of every scan due in the window and
        (arrival, order, car) of every car, by time: a car comes before
        the scans due at its arrival."""
        ev = []
        for i in range(len(self.sid)):
            cuts = [car.at for car in self.cars if i in car.riders]
            for stay, (first, end) in enumerate(zip([self.phase[i]] + cuts,
                                                    cuts + [seconds])):
                k = 0
                while first + k * self.period < end:
                    ev.append((first + k * self.period, 1, i, stay))
                    k += 1
        ev += [(car.at, 0, -1, c) for c, car in enumerate(self.cars)]
        heapq.heapify(ev)
        return ev

    def _ride(self, i, c, t_arrival):
        """Robot ``i``, a rider of car ``c``, leaves its session and
        opens one on the car's floor."""
        car = self.cars[c]
        stay = car.stays[car.riders.index(i)]
        self.pool.close_session(self.sid[i])
        self.pool.open_session(self.sid[i], *self.maps[car.floor])
        stay.arrival = t_arrival
        self.stays[i].append(stay)
        self.next_t[i] = 0

    def window(self, seconds, trace=None):
        sp = self.spans
        rounds0 = self.rdp_rounds()
        c0 = self.program_counters()
        ev = self.schedule(seconds)
        self.attempted = sum(1 for e in ev if e[1] == 1)
        queues = collections.defaultdict(collections.deque)
        boarding = {}                 # robot -> the car it rides
        lat, late = [], []
        ticks = carried = rides = 0
        tr_on, tr_from = False, seconds - self.wl["trace_seconds"]
        self.trace_scans = self.trace_ticks = 0
        t0 = self.t0 = kind.now()
        while ev or any(queues.values()) or boarding:
            tn = kind.now()
            while ev and t0 + ev[0][0] <= tn:
                at, order, i, k = heapq.heappop(ev)
                if order == 0:
                    for j in self.cars[k].riders:
                        boarding[j] = k
                else:
                    queues[i].append((t0 + at, k))
            # a rider boards once its scans on the old floor are answered
            ready = [i for i, c in boarding.items()
                     if not queues[i] or queues[i][0][1] == len(
                         self.stays[i])]
            if ready:
                with sp.span("lift.ride"):
                    for i in ready:
                        c = boarding.pop(i)
                        self._ride(i, c, t0 + self.cars[c].at)
                rides += len(ready)
            pending = [i for i, q in queues.items()
                       if q and q[0][1] == len(self.stays[i]) - 1]
            if not pending:
                if ev:
                    kind.wait_until(t0 + ev[0][0])
                continue
            if trace is not None and not tr_on and tn - t0 >= tr_from:
                trace.start()
                tr_on = True
            dues = {}
            with sp.span("pool.submit"):
                for i in pending:
                    due, _k = queues[i].popleft()
                    late.append((kind.now() - due) * 1e3)
                    dues[i] = due
                    self._submit(i)
            with sp.span("pool.step"):
                res = self.pool.step()
            t_ret = kind.now()
            self._record(res)
            for i, due in dues.items():
                sid = self.sid[i]
                lat.append((t_ret - due) * 1e3 if sid in res else math.inf)
                stay = self.stays[i][-1]
                if sid in res and stay.arrival is not None and \
                        stay.first_pose_ms is None and \
                        np.isfinite(res[sid]["score"]):
                    stay.first_pose_ms = (t_ret - stay.arrival) * 1e3
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
                           featurize_calls=ticks, floor_changes=rides,
                           rdp_rounds=self.rdp_rounds() - rounds0)
        c1 = self.program_counters()
        sp.counters.update({k: c1[k] - c0.get(k, 0) for k in c1})

    @staticmethod
    def program_counters() -> dict:
        """The program's relock counters, where it keeps them."""
        from lsdtpu_torch.runtime import trace as ptrace
        now = ptrace.counters()
        return {k: now[k] for k in PROGRAM_COUNTERS if k in now}

    def changes(self) -> List[Stay]:
        """The window's floor changes: every stay a car began."""
        return [s for stays in self.stays for s in stays[1:]]

    def failed(self) -> int:
        """Scans never answered, and floor changes with no pose."""
        return super().failed() + sum(
            1 for s in self.changes() if s.first_pose_ms is None)

    def end_to_end(self):
        ms = [s.first_pose_ms for s in self.changes()
              if s.first_pose_ms is not None]
        return dict(self.latency_metrics(),
                    map_to_pose_ms=float(np.mean(ms)) if ms else math.inf)

    def slice_counts(self):
        return {"scans": self.trace_scans, "ticks": self.trace_ticks}

    def notes(self):
        ch = self.changes()
        ms = [s.first_pose_ms for s in ch if s.first_pose_ms is not None]
        cnt = self.spans.counters
        return kind.latency_lines(self.lat, self.late) + [
            f"pool capacity={self.pool.capacity} ticks={cnt['ticks']} "
            f"scans carried={cnt['scans_carried']}",
            f"floor changes={len(ch)} with a pose={len(ms)} cars="
            f"{len(self.cars)} map_to_pose_ms p50="
            f"{kind.percentile(ms, 50):.4f} max="
            f"{max(ms) if ms else math.inf:.4f}",
            "program counters in the window: " + " ".join(
                f"{k}={cnt[k]}" for k in PROGRAM_COUNTERS if k in cnt)]

    def release(self):
        if self.mode != "control":
            self.lines = [art[0].double().cpu().numpy() for art in self.maps]
        self.pool = self.maps = None
        self.free_device()

    # -- correctness ---------------------------------------------------------
    def judged(self):
        rng = np.random.default_rng([self.seed, 2])
        n = min(self.wl["judge_robots"], len(self.sid))
        return sorted(int(i) for i in
                      rng.choice(len(self.sid), n, replace=False))

    def _control_stays(self, i):
        """The control's stays of robot ``i``: every scan due in the
        window taken, each answered by the reference in bfloat16."""
        ev = [(d, k) for d, o, j, k in sorted(self.schedule(self.seconds))
              if o == 1 and j == i]
        stays = [self.stays[i][0]] + [car.stays[car.riders.index(i)]
                                      for car in self.cars
                                      if i in car.riders]
        for k, stay in enumerate(stays):
            n = sum(1 for _d, kk in ev if kk == k)
            stay.taken = list(range(self.wl["warmup_scans"] + n
                                    if k == 0 else n))
        return stays

    def _steps(self, stay, taken):
        robot = kind.Robot("", stay.walk, stay.start, stay.direction, 0.0)
        return kind.reference_steps(robot, taken)

    def judge(self):
        if self.mode == "control":
            self.lines = [reference_lines(b) for b in self.buildings]
        fields = [self.reference_field(b.grid) for b in self.buildings]
        maps = {f: (self.lines[f], fields[f]) for f in range(len(fields))}
        geom = self.geometry()
        table = rfl.FloorTable()
        judged = set(self.judged())
        judged_stays = []
        truth = []
        for i in range(len(self.sid)):
            stays = self._control_stays(i) if self.mode == "control" and \
                i in judged else self.stays[i]
            if self.mode == "control" and i not in judged:
                continue
            step = 0
            for stay in stays:
                table.board(self.sid[i], stay.floor, step)
                floor = table.floor_at(self.sid[i], step)
                n = len(stay.answers) if self.mode != "control" else \
                    len(stay.taken)
                step += max(n, 1)
                taken = stay.taken[:n]
                answers = rj.control_answers(
                    self._steps(stay, taken), *maps[floor], geom) \
                    if self.mode == "control" else stay.answers
                truth.append(rj.truth_gaps(
                    [a["pose"] for a in answers],
                    self.truth_px(stay.walk, [stay.frame(t) for t in taken])))
                if i in judged and n:
                    judged_stays.append(
                        (floor, self._steps(stay, taken), answers))
        ch, tasks = self._first_pose_tasks(maps, geom)
        gaps, got = rfl.judge_floors(judged_stays, tasks, maps, geom)
        numbers = rj.stream_numbers(gaps, truth)
        numbers.update(self._first_poses(ch, got))
        numbers["floor_stays_judged"] = len(judged_stays)
        checks, self.readings = rj.compare(numbers, self.wl["limits"])
        return checks

    def _first_pose_tasks(self, maps, geom):
        """Every floor change, and a sample of them as first_pose_gap's
        tasks."""
        if self.mode == "control":
            ch = [s for i in self.judged() for s in self._control_stays(i)[1:]]
        else:
            ch = [s for s in self.changes() if s.answers]
        rng = np.random.default_rng([self.seed, 5])
        k = min(self.wl["judge_changes"], len(ch))
        pick = sorted(rng.choice(len(ch), k, replace=False)) if k else []
        tasks = []
        for j in pick:
            s = ch[j]
            r, a = scene.ros_to_polar(s.walk.scans[s.frame(0)])
            if self.mode == "control":
                steps = self._steps(s, [0])
                answer = rj.Bf16Follower(*maps[s.floor], *geom).step(
                    steps[0]["ranges"], steps[0]["angles"],
                    steps[0]["odom_prev"], steps[0]["odom_cur"])
            else:
                answer = s.answers[0]
            tasks.append((s.floor, r, a, answer))
        return ch, tasks

    def _first_poses(self, ch, got) -> dict:
        """The sampled first answers' gaps to the relock over every gated
        hypothesis; the overflow share over every change."""
        gap = [g["gap"] for g in got]
        gated = [g["n_gated"] for g in got]
        over = [bool(s.answers[0].get("candidate_overflow", False))
                for s in ch if s.answers] if self.mode != "control" else []
        return {"first_pose_gap_median_px":
                float(np.median(gap)) if gap else math.inf,
                "first_pose_gap_max_px": max(gap) if gap else math.inf,
                "first_poses_off_1e-3px": sum(g > 1e-3 for g in gap),
                "first_poses": len(gap),
                "relock_gated_min": min(gated) if gated else 0,
                "relock_gated_median": float(np.median(gated))
                if gated else 0.0,
                "relock_gated_max": max(gated) if gated else 0,
                "relock_overflow_share":
                sum(over) / len(over) if over else 0.0,
                "floor_changes": len(ch)}


def reference_lines(b) -> np.ndarray:
    """The reference's own line set of a floor (the control has no
    program to take them from)."""
    from reference import lsd as rlsd
    return rlsd.line_segment_detector(b.grid.copy()).lines_info
