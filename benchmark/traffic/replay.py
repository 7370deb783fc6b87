"""replay: a mapping team replaying a fleet's logs, closed loop.

Each call is one run_batch over ``lanes`` logs of the configuration's
sequence length on one map, under the default execution strategy: the
frames go from host numpy and the outputs come back to the host (time to
value).  A log is one of ``walks`` seeded walks replayed forwards and
then backwards from a start and in a direction drawn from the seed for
each call and lane.  Calls run back to back; one under way when the
window closes finishes and counts.
"""

from __future__ import annotations

import numpy as np

from harness import kind
from reference import judge as rj
from traffic import scene


class Run(kind.Base):
    serving = ("replay.call",)

    def setup(self):
        wl, c = self.wl, self.config
        self.building = scene.building(c, c["scene_seed"])
        self.lines = scene.wall_lines(self.building.walls)
        self.walks = scene.walks(self.building, self.seed, wl["walks"],
                                 c["frames"], c["range_m"], wl["step_m"],
                                 wl["walk_radius_m"],
                                 self.device if self.mode != "control"
                                 else "cpu")
        # each walk frame's scan as the batch takes it: valid points first
        F, N = c["frames"], c["scan_points"]
        W = len(self.walks)
        self.R = np.zeros((W, F, N), np.float32)
        self.A = np.zeros((W, F, N), np.float32)
        self.n = np.zeros((W, F), np.int32)
        for w, wk in enumerate(self.walks):
            for f in range(F):
                r, a = scene.ros_to_polar(wk.scans[f])
                self.R[w, f, :len(r)] = r
                self.A[w, f, :len(a)] = a
                self.n[w, f] = len(r)
        self.calls = []           # (lane walks, lane frame indices) a call
        self.outs = []
        if self.mode == "control":
            return
        import torch
        from lsdtpu_torch.mapprep.distance import create_map_cache
        from lsdtpu_torch.runtime.batch import batch_context
        field = create_map_cache(self.building.grid, c["resol"],
                                 dtype=torch.float32, device=self.device)
        B = wl["lanes"]
        self.ctxs = batch_context([(self.lines, field)] * B,
                                  [self.geometry()] * B, self.cfg,
                                  dtype=np.float32,
                                  cache_dtype=self.cfg.match.cache_dtype,
                                  device=self.device)
        del field
        # warm-up: every shape of a call, over its first frames
        self._call(self.lanes(-1), frames=wl["warmup_frames"])

    def lanes(self, call: int):
        """The walk and the frame indices of each lane of ``call``."""
        rng = np.random.default_rng([self.seed, 4, call + 1])
        F = self.config["frames"]
        B = self.wl["lanes"]
        w = rng.integers(len(self.walks), size=B)
        start = rng.integers(2 * F - 2, size=B)
        d = np.where(rng.random(B) < 0.5, 1, -1)
        idx = np.array([[scene.cycle_index(F, int(start[b]), t, int(d[b]))
                         for t in range(F)] for b in range(B)])
        return w, idx

    def frames(self, lanes, frames=None):
        w, idx = lanes
        if frames is not None:
            idx = idx[:, :frames]
        n = self.n[w[:, None], idx]
        N = self.R.shape[-1]
        odom = np.stack([self.walks[int(wb)].odom[ib]
                         for wb, ib in zip(w, idx)]).astype(np.float32)
        prev = np.concatenate([odom[:, :1], odom[:, :-1]], axis=1)
        return {"ranges": self.R[w[:, None], idx],
                "angles": self.A[w[:, None], idx],
                "valid": np.arange(N) < n[..., None], "n": n,
                "odom_prev": prev, "odom_cur": odom}

    def _call(self, lanes, frames=None):
        from lsdtpu_torch.runtime.batch import run_batch
        with self.spans.span("replay.call"):
            out = run_batch(self.frames(lanes, frames), self.ctxs, self.cfg,
                            device=self.device)
            out = {k: out[k].cpu().numpy()
                   for k in ("pose", "score", "n_candidates")}
        return out

    def window(self, seconds, trace=None):
        rounds0 = self.rdp_rounds()
        t0 = self.t0 = kind.now()
        i = 0
        while kind.now() - t0 < seconds:
            lanes = self.lanes(i)
            if trace is not None and i == 0:
                trace.start()
            out = self._call(lanes)
            if trace is not None and i == 0:
                trace.stop()
            self.calls.append(lanes)
            self.outs.append(out)
            i += 1
        self.t_end = kind.now()
        F = self.config["frames"]
        self.attempted = i * self.wl["lanes"] * F
        self.spans.counters.update(calls=i, frames=i * F,
                                   featurize_calls=i * F,
                                   rdp_rounds=self.rdp_rounds() - rounds0)

    def end_to_end(self):
        return {"replay_scans_per_s": self.attempted / (self.t_end - self.t0)}

    def slice_counts(self):
        return {"frames": self.config["frames"], "calls": 1}

    def notes(self):
        calls = [(b - a) / 1e9 for n, a, b in self.spans.spans
                 if n == "replay.call"][1:]
        answered = sum(o["pose"].shape[0] * o["pose"].shape[1]
                       for o in self.outs)
        return [f"requests attempted={self.attempted} answered={answered}"
                " (closed loop: no schedule, no lateness)",
                f"calls={len(self.outs)} lanes={self.wl['lanes']} "
                f"frames={self.config['frames']} call_s="
                f"{[round(c, 3) for c in calls]}"]

    def release(self):
        self.ctxs = None
        self.free_device()

    def judged(self):
        """(call, lane) pairs drawn from the seed, lanes all distinct."""
        n_calls = len(self.outs) if self.mode != "control" else 1
        rng = np.random.default_rng([self.seed, 2])
        B = self.wl["lanes"]
        k = min(self.wl["judge_lanes"], B)
        lanes = rng.choice(B, k, replace=False)
        return [(int(rng.integers(n_calls)), int(b)) for b in lanes]

    def judge(self):
        field = self.reference_field(self.building.grid)
        sessions, truth = [], []
        for c, b in self.judged():
            lanes = self.calls[c] if self.mode != "control" else self.lanes(c)
            wk = self.walks[int(lanes[0][b])]
            steps, prev = [], None
            for f in lanes[1][b]:
                r, a = scene.ros_to_polar(wk.scans[f])
                cur = wk.odom[f]
                steps.append({"ranges": r, "angles": a,
                              "odom_prev": cur if prev is None else prev,
                              "odom_cur": cur})
                prev = cur
            if self.mode == "control":
                answers = rj.control_answers(steps, self.lines, field,
                                             self.geometry())
                truth.append(rj.truth_gaps([a["pose"] for a in answers],
                                           self.truth_px(wk, lanes[1][b])))
            else:
                o = self.outs[c]
                answers = [{"pose": o["pose"][b, t], "score": o["score"][b, t],
                            "n_candidates": o["n_candidates"][b, t]}
                           for t in range(len(steps))]
            sessions.append((steps, answers))
        gaps = rj.follow_sessions(sessions, self.lines, field,
                                  self.geometry())
        # every lane of every call against its walk
        for (w, idx), o in zip(self.calls, self.outs):
            for b in range(len(w)):
                truth.append(rj.truth_gaps(
                    o["pose"][b], self.truth_px(self.walks[int(w[b])],
                                                idx[b])))
        checks, self.readings = rj.compare(
            rj.stream_numbers(gaps, truth), self.wl["limits"])
        return checks
