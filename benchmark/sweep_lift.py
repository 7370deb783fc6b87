#!/usr/bin/env python3
"""The lift cell's knee: its traffic at several fleet sizes.

    python3 benchmark/sweep_lift.py [--robots 128 152 192 256]
        [--seconds 20] [--seed 5]

on the card, from the root of a checkout.  For each fleet size N it runs
lift.f3f4key-building's traffic (one SessionPool of capacity N over two
floors, 10 Hz scans at seeded phases, open loop, a lift car every
0.5 s carrying 4 riders) for ``--seconds`` in this process, and prints
one line: scan_p50_ms, scan_p95_ms, map_to_pose_ms, unanswered scans,
ticks, the mean latency of the first and the last quarter of the window
and the pool's mean tick.  The knee is the largest N whose p95 stays
within the lidar period with every scan answered and no growing backlog
(the last quarter's mean under 1.5 times the first's), as
sweep_fleet.py's.  The last line is the table as JSON.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def one(cell, n, seconds, seed):
    import numpy as np
    import torch
    from harness import kind
    c = copy.deepcopy(cell)
    c.workload["robots"] = n
    run = c.traffic_module().Run(c, seed, device="cuda")
    run.seconds = seconds
    t0 = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    run.window(seconds)
    lat = np.asarray(run.lat)
    q = len(run.lat) // 4       # answered in about the order due
    ticks = [(b - a) / 1e6 for nm, a, b in run.spans.spans
             if nm == "pool.step"]
    row = {"robots": n, "scan_p50_ms": kind.percentile(lat, 50),
           "scan_p95_ms": kind.percentile(lat, 95),
           "map_to_pose_ms": run.end_to_end()["map_to_pose_ms"],
           "unanswered": run.failed(), "scans": len(lat),
           "ticks": len(ticks), "tick_ms_mean": float(np.mean(ticks)),
           "first_quarter_ms": float(np.mean(run.lat[:q])),
           "last_quarter_ms": float(np.mean(run.lat[-q:])),
           "setup_s": setup_s,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    run.release()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, nargs="+",
                    default=[128, 152, 192, 256])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep_lift: no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness.spec import find_cell
    cell = find_cell("lift.f3f4key-building")
    period_ms = 1e3 / cell.config["lidar_hz"]
    rows = []
    for n in args.robots:
        row = one(cell, n, args.seconds, args.seed)
        row["within"] = bool(row["scan_p95_ms"] <= period_ms
                             and row["unanswered"] == 0
                             and row["last_quarter_ms"]
                             <= 1.5 * row["first_quarter_ms"])
        rows.append(row)
        print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    ok = [r["robots"] for r in rows if r["within"]]
    knee = max(ok) if ok else None
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "knee": knee,
                      "cell_robots": None if knee is None
                      else int(0.8 * knee) // 8 * 8, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
