"""The benchmark's own tests: its directory and the checkout's root on
the import path, and a tiny cell of each traffic kind for the CPU."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a room of the generator's default size: 200 x 260 cells at 0.05 m
TINY_CONFIG = {"name": "tiny", "cols": 260, "rows": 200, "resol": 0.05,
               "scan_points": 360, "frames": 24, "range_m": 10.0,
               "lidar_hz": 10, "ori_x": -2.0, "ori_y": -1.5,
               "scene_seed": 3, "interior_walls": 3, "wall_scale": 1.0,
               "clear_m": 1.5}
# the cells' own judge counts, with more sessions than are judged
TINY = {"fleet": {"robots": 24, "walks": 2},
        "mapswitch": {"maps": 3, "control_switches": 3},
        "replay": {"lanes": 24, "walks": 2, "warmup_frames": 2}}


CELLS = {"fleet": "fleet.f3key-data1", "mapswitch": "mapswitch.f3key-data1", "replay": "replay.hall-0523"}


def tiny_cell(kind: str, **over):
    """The cell of ``kind`` on the tiny room: its traffic file's keys and
    limits, the tiny sizes above, BENCHMARK.json's metrics of its kind's
    end-to-end metrics."""
    from harness.spec import BENCH_DIR, Cell, load_json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = CELLS[kind]
    wl = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    wl.update(TINY[kind], walk_radius_m=1.0, **over)
    e2e = {"fleet": "scan_", "mapswitch": "map_",
           "replay": "replay_"}[kind]
    end_to_end = [m for m in bench["end_to_end"]
                  if m["name"].startswith(e2e) or m["name"] == "setup_s"]
    entry = {"name": name, "config": wl["config"], "traffic": kind,
             "chips": 1}
    return Cell(name, entry, dict(TINY_CONFIG), wl, end_to_end, [])


@pytest.fixture
def tiny():
    return tiny_cell
