"""What the traffic kinds share: the program's configuration, the
building and its artifacts, streams of scans from walks, and latency
statistics.

A traffic kind (``traffic/<kind>.py``) defines ``Run(cell, seed, device,
mode)`` with ``setup()``, ``window(seconds, trace)``, ``end_to_end()``,
``slice_counts()``, ``notes()``, ``release()`` and ``judge()``, and the
names of its entry spans (``serving``).  ``mode`` is ``"program"`` (the
benchmark), ``"control"`` (the reference in bfloat16 in the program's
place: no window) or ``"cache-bf16"`` (the program with its bfloat16
field).

A cell whose ``chips`` N is above 1 runs over N ranks, one card each,
and only with a kind that declares ``ranks = True`` (the harness exits
2 before set-up otherwise).  The harness's process is rank 0; it starts
ranks 1..N-1 during set-up (harness/ranks.py).  Every rank has
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE) and card LOCAL_RANK current, builds its
own ``Run`` with ``rank`` and ``world`` set, and runs ``setup()``,
``window()`` and ``release()``; the program starts its own process
group (``lsdtpu_torch.runtime.distributed.initialize()``), as under
torchrun.  After the window every other rank hands rank 0 its card
(harness/trace.py ``Card``: peak memory, traced events, spans,
counters), which rank 0's run finds in ``cards``, indexed by rank.
Rank 0 alone then calls ``end_to_end()``, ``slice_counts()``,
``notes()`` and ``judge()``: it holds every slot's answers after the
program's gather.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List

import numpy as np

from harness.trace import Spans
from traffic import scene

MODES = ("program", "control", "cache-bf16")


def engine_config(mode: str, engine: dict = None):
    """The program's configuration: the defaults, as a deployment runs
    them, with the settings of the cell's traffic file (``engine``:
    ``{"group.field": value}``, such as ``"shapes.max_candidates"``);
    under "cache-bf16" the field is stored in bfloat16."""
    from lsdtpu_torch.config import DEFAULT
    settings = dict(engine or {})
    if mode == "cache-bf16":
        settings["match.cache_dtype"] = "bf16"
    cfg = DEFAULT
    for key, value in settings.items():
        group, field = key.split(".")
        cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(
            getattr(cfg, group), **{field: value})})
    return cfg


def now() -> float:
    return time.perf_counter()


def wait_until(t: float) -> None:
    d = t - time.perf_counter()
    if d > 0:
        time.sleep(d)


def percentile(values, q: float) -> float:
    """numpy's linear percentile; an unanswered request (inf) counts
    as missing every limit."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        return math.inf
    pos = (len(v) - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if math.isinf(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


class Base:
    """A run of one cell."""

    serving: tuple = ()
    ranks: bool = False     # runs over several cards (module docstring)
    rank: int = 0
    world: int = 1

    def __init__(self, cell, seed: int, device: str = "cuda",
                 mode: str = "program"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: expected one of {MODES}")
        self.cell = cell
        self.config = cell.config
        self.wl = cell.workload
        self.seed = int(seed)
        self.device = device
        self.mode = mode
        self.spans = Spans()
        self.cfg = engine_config(mode, self.wl.get("engine")) \
            if mode != "control" else None
        self.t0 = None
        self.seconds = None     # the window's length, set by the runner

    # -- shared pieces -----------------------------------------------------
    def geometry(self):
        c = self.config
        return (c["resol"], c["ori_x"], c["ori_y"])

    def rdp_rounds(self) -> int:
        from lsdtpu_torch.scan import featurize
        return featurize._rdp_rounds.rounds

    def reference_field(self, grid):
        from reference import lsd as rlsd
        return rlsd.create_map_cache(grid.copy(), self.config["resol"])

    def truth_px(self, walk, frames) -> np.ndarray:
        """The walk's true positions at ``frames`` in map pixels, as the
        program answers them."""
        c = self.config
        return (walk.pos[np.asarray(frames)] -
                (c["ori_x"], c["ori_y"])) / c["resol"]

    def failed(self) -> int:
        """Requests due in the window never answered (an open loop's)."""
        return int(np.sum(~np.isfinite(np.asarray(getattr(self, "lat",
                                                          [])))))

    def latency_metrics(self) -> dict:
        return {"scan_p95_ms": percentile(self.lat, 95),
                "scan_p50_ms": percentile(self.lat, 50)}

    def free_device(self) -> None:
        """Hand the freed program state back to the card."""
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Robot:
    """One robot's stream: a walk replayed forwards and backwards from a
    start position in a direction, scans due every ``period`` from
    ``phase``."""
    sid: str
    walk: scene.Walk
    start: int
    direction: int
    phase: float

    def frame(self, t: int) -> int:
        return scene.cycle_index(len(self.walk.pos), self.start, t,
                                 self.direction)

    def scan(self, t: int):
        return self.walk.scans[self.frame(t)]

    def odom(self, t: int):
        return self.walk.odom[self.frame(t)]


def draw_robots(rng, walks, n: int, period: float) -> List[Robot]:
    F = len(walks[0].pos)
    out = []
    for i in range(n):
        out.append(Robot(f"r{i}", walks[int(rng.integers(len(walks)))],
                         int(rng.integers(2 * F - 2)),
                         1 if rng.random() < 0.5 else -1,
                         float(rng.uniform(0.0, period))))
    return out


def reference_steps(robot: Robot, ts) -> List[dict]:
    """The scans of ``robot`` at stream steps ``ts`` (in the order the
    program took them) as the reference reads them, with the odometry
    pair the program was given."""
    steps, prev = [], None
    for t in ts:
        r, a = scene.ros_to_polar(robot.scan(t))
        cur = robot.odom(t)
        steps.append({"ranges": r, "angles": a,
                      "odom_prev": cur if prev is None else prev,
                      "odom_cur": cur})
        prev = cur
    return steps


def latency_lines(lat_ms, late_ms) -> List[str]:
    lat = np.asarray(lat_ms)
    late = np.asarray(late_ms) if len(late_ms) else np.zeros(1)
    answered = int(np.isfinite(lat).sum())
    return [f"requests attempted={len(lat)} answered={answered} "
            f"p50_ms={percentile(lat, 50):.4f} "
            f"p95_ms={percentile(lat, 95):.4f} "
            f"max_ms={float(np.max(lat)) if len(lat) else math.nan:.4f}",
            f"generator lateness p50_ms={percentile(late, 50):.4f} "
            f"max_ms={float(np.max(late)):.4f}"]
