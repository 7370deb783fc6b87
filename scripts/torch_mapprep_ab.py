#!/usr/bin/env python3
"""Map-prep time to value of the PyTorch/CUDA port for the checkout at
--root, on one NVIDIA card.

    python3 scripts/torch_mapprep_ab.py --root DIR --label NAME

lsdtpu_torch is imported from DIR and the scenes from this checkout's
chip_smoke.py, so two checkouts (a parent and a change) are measured by
the same code on the same grids.  Run them in turns, one process per
checkout, parent, change, change, parent, to compare them on one card.
The cases, f32 on the card, grid on the host -> lines on the host, each
after one warm-up run: wave growth on the data1-sized scene, then wave
and FIFO growth on the same scene with chip_smoke.py's round pillars;
for each the median of --repeats runs (wall ms and the process's host
CPU ms), the seed walk's host syncs and the line count, and from one
more run under torch.profiler the device operations it launched and
their device-busy ms (counts that host noise cannot move).  The last
line of the output is one JSON object.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose lsdtpu_torch is measured")
    ap.add_argument("--label", default="",
                    help="name printed with the results")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per case (the median is reported)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    here = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    import lsdtpu_torch
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    if not Path(lsdtpu_torch.__file__).resolve().is_relative_to(root):
        cs.fail(f"lsdtpu_torch came from {lsdtpu_torch.__file__}, not {root}")
    device = torch.device("cuda")
    smi = cs.nvidia_smi_line()

    cases = []
    for pillars, growths in ((0, ("wave",)), (cs.PILLARS, ("wave", "fifo"))):
        ds = cs.make_scene(pillars).dataset
        for growth in growths:
            def run(stats):
                art = prepare_map(ds.map_value, ds.param.resol, growth=growth,
                                  dtype=torch.float32, device=device,
                                  stats=stats)
                return art.lines_info.cpu().numpy()

            run(MapPrepStats())
            times, cpu = [], []
            for _ in range(args.repeats):
                st = MapPrepStats()
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), time.process_time()
                lines = run(st)
                times.append((time.perf_counter() - t0) * 1e3)
                cpu.append((time.process_time() - c0) * 1e3)
            _wall, acts = cs.device_profile(lambda: run(MapPrepStats()))
            case = dict(name=f"{growth}_pillars{pillars}",
                        median_ms=float(np.median(times)), min_ms=min(times),
                        max_ms=max(times), times_ms=times,
                        host_cpu_ms=float(np.median(cpu)), syncs=st.syncs,
                        seeds=st.seeds, nfa_calls=st.nfa_calls,
                        lines=len(lines),
                        device_ops=sum(v[0] for v in acts.values()),
                        device_busy_ms=sum(v[1] for v in acts.values())
                        / 1e3)
            cs.phase("mapprep_ab", label=args.label, card=repr(smi), **case)
            cases.append(case)
    print(smi, flush=True)
    print(json.dumps({"label": args.label, "root": root, "card": smi,
                      "cases": cases}), flush=True)


if __name__ == "__main__":
    main()
