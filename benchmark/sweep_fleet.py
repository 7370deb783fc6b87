#!/usr/bin/env python3
"""The fleet's knee: the fleet cell's traffic at several fleet sizes.

    python3 benchmark/sweep_fleet.py [--robots 64 128 192 256 384 512]
        [--seconds 20] [--seed 5]

on the card, from the root of a checkout.  For each fleet size N it runs
fleet.f3key-data1's traffic (one SessionPool of capacity N, 10 Hz scans
at seeded phases, open loop) for ``--seconds`` in this process, and
prints one line: scan_p50_ms, scan_p95_ms, unanswered scans, ticks, the
mean latency of the first and the last quarter of the window (a backlog
that grows shows as the last above the first) and the pool's mean tick.
The knee is the largest N whose p95 stays within the lidar period with
every scan answered and no growing backlog (the last quarter's mean
under 1.5 times the first's); the fleet cell runs at 80% of it, rounded
down to a multiple of 8.  The last line is the table as JSON.
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
    run.window(seconds)
    lat = np.asarray(run.lat)
    q = len(run.lat) // 4       # answered in about the order due
    first = float(np.mean(run.lat[:q])) if q else float("nan")
    last = float(np.mean(run.lat[-q:])) if q else float("nan")
    ticks = [(b - a) / 1e6 for nm, a, b in run.spans.spans
             if nm == "pool.step"]
    row = {"robots": n, "scan_p50_ms": kind.percentile(lat, 50),
           "scan_p95_ms": kind.percentile(lat, 95),
           "unanswered": run.failed(), "scans": len(lat),
           "ticks": len(ticks), "tick_ms_mean": float(np.mean(ticks)),
           "first_quarter_ms": first, "last_quarter_ms": last,
           "setup_s": setup_s,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    run.release()
    torch.cuda.reset_peak_memory_stats()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, nargs="+",
                    default=[64, 128, 192, 256, 384, 512])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep_fleet: no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from harness.spec import find_cell
    cell = find_cell("fleet.f3key-data1")
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
