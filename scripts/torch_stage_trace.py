#!/usr/bin/env python3
"""The port's stage spans in a benchmark cell, on one NVIDIA card.

    python3 scripts/torch_stage_trace.py coverage \\
        --workload fleet.f3key-data1 --seed 7 --seconds 51
    python3 scripts/torch_stage_trace.py cost \\
        --workload fleet.f3key-data1 --seed 7 --seconds 51 --recording 1

from the root of a checkout.  ``coverage`` makes one traced run of the
cell as ``benchmark/run.py --trace 1`` does (its device trace over the
cell's slice; the program records its spans while the profiler is on),
without the judge, and reads: the cell's per-layer metrics; the device
idle time inside the program's outer spans against that inside the
benchmark's entry spans over the slice (``outer_share``); the part of
it inside the stage spans the cell's stage metrics read
(``stage_share``); the idle time inside every span name a request; and
the longest idle gaps, each named by the innermost program span open at
its middle, with the ticks, switches or frames that lie whole inside it
(a gap that holds one holds device work the trace lost).  ``cost`` runs
the cell's window untraced, with the tracer's ``recording()`` held open
over the whole window (``--recording 1``) or not (``0``), and reads the
end-to-end metrics, the spans recorded a tick, switch or frame, the
spans dropped, and the three longest ticks, switches or frames with
their stages.

One JSON line on standard output.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"

# per traffic kind: the program's outer spans, the benchmark's entry
# spans they answer for, the span a value is per, and the stages the
# cell's stage metrics read
KINDS = {
    "fleet": dict(outer=("pool.step",), bench=("pool.step",),
                  per="pool.step",
                  stages=("step.featurize", "step.match", "pool.pack",
                          "pool.readback", "host.gc")),
    "replay": dict(outer=("batch.run",), bench=("replay.call",),
                   per="batch.frame",
                   stages=("step.featurize", "step.match")),
    "mapswitch": dict(outer=("online.set_map", "online.push"),
                      bench=("mapswitch.set_map", "mapswitch.first_push"),
                      per="online.set_map",
                      stages=("mapprep.field", "mapprep.seed",
                              "mapprep.grow", "mapprep.validate")),
}


def setup(workload: str, seed: int, seconds: float):
    """The cell's run, set up on the card, and its set-up seconds."""
    t0 = time.perf_counter()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import run as bench_run
    bench_run.environment()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("torch_stage_trace: no card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness.spec import find_cell
    cell = find_cell(workload)
    r = cell.traffic_module().Run(cell, seed, device="cuda")
    r.seconds = seconds
    r.setup()
    torch.cuda.synchronize()
    return cell, r, time.perf_counter() - t0


def innermost(spans, at: int):
    """The chain of program span names open at ``at``, outermost first."""
    by_id = {s.id: s for s in spans}
    open_ = [s for s in spans if s.start_ns <= at < s.end_ns]
    if not open_:
        return []
    s = min(open_, key=lambda s: s.end_ns - s.start_ns)
    chain = [s.name]
    while s.parent in by_id:
        s = by_id[s.parent]
        chain.append(s.name)
    return chain[::-1]


def coverage(cell, r, seconds: float) -> dict:
    import torch
    from harness import program
    from harness import trace as tr
    from lsdtpu_torch.runtime import trace as ptrace
    kind = KINDS[cell.kind]
    dev = tr.DeviceTrace()
    dev.warm()
    ptrace.clear()
    r.window(seconds, dev)
    torch.cuda.synchronize()
    view = tr.TraceView(r.spans.spans, r.spans.counters, dev.events,
                        dev.slice, r.slice_counts(), r.serving)
    metrics = {m["name"]: cell.metric_reader(m["name"]).read(view)
               for m in cell.per_layer}
    spans = program.program_spans(view)
    busy = view.busy()
    outer = program.intervals(spans, kind["outer"])
    bench = tr.clip(tr.union((a, b) for _n, a, b in
                             view.slice_spans(kind["bench"])), *view.slice)
    outer_idle = program.idle_ns(view, outer, busy)
    bench_idle = program.idle_ns(view, bench, busy)
    stages = program.intersect(program.intervals(spans, kind["stages"]),
                               outer)
    stage_idle = program.idle_ns(view, stages, busy)
    n_per = sum(1 for s in spans if s.name == kind["per"])
    by_name = {}
    for name in sorted({s.name for s in spans}):
        iv = program.intersect(program.intervals(spans, (name,)), outer)
        by_name[name] = {
            "spans": sum(1 for s in spans if s.name == name),
            "idle_ms_per": program.idle_ns(view, iv, busy) / 1e6 / n_per,
            "ms_per": sum(b - a for a, b in tr.clip(iv, *view.slice))
            / 1e6 / n_per}
    lo, hi = view.slice
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:5]
    bench_spans = view.slice_spans()
    named = []
    for d, a in gaps:
        mid = a + d // 2
        bname = next((n for n, s, e in sorted(bench_spans,
                                              key=lambda x: x[2] - x[1])
                      if s <= mid < e), "outside")
        # a tick, switch or frame whole inside a gap ran with no device
        # event recorded: the trace lost them, the device was not idle
        whole = sum(1 for s in spans if s.name == kind["per"] and
                    a <= s.start_ns and s.end_ns <= a + d)
        named.append({"at_s": (a - lo) / 1e9, "s": d / 1e9,
                      "benchmark": bname,
                      "program": innermost(spans, mid),
                      "whole_" + kind["per"]: whole})
    return {"metrics": metrics,
            "outer_idle_ms": outer_idle / 1e6,
            "bench_idle_ms": bench_idle / 1e6,
            "outer_share": outer_idle / bench_idle if bench_idle else None,
            "stage_idle_ms": stage_idle / 1e6,
            "stage_share": stage_idle / outer_idle if outer_idle else None,
            "per": kind["per"], "n_per": n_per,
            "slice_s": (hi - lo) / 1e9, "busy_s": tr.device_busy_s(view),
            "spans": len(spans), "dropped": ptrace.dropped(),
            "by_name": by_name, "gaps": named}


def cost(cell, r, seconds: float, recording: bool) -> dict:
    from lsdtpu_torch.runtime import trace as ptrace
    kind = KINDS[cell.kind]
    ptrace.clear()
    scope = ptrace.recording() if recording else contextlib.nullcontext()
    with scope:
        r.window(seconds, None)
    spans = ptrace.spans()
    pers = sorted((s for s in spans if s.name == kind["per"]),
                  key=lambda s: s.start_ns - s.end_ns)
    longest = [{"ms": (p.end_ns - p.start_ns) / 1e6,
                "stages_ms": {c.name: (c.end_ns - c.start_ns) / 1e6
                              for c in spans if c.parent == p.id}}
               for p in pers[:3]]
    return {"end_to_end": r.end_to_end(), "recording": recording,
            "spans": len(spans), "per": kind["per"], "n_per": len(pers),
            "spans_per": len(spans) / len(pers) if pers else None,
            "dropped": ptrace.dropped(), "longest": longest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("coverage", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recording", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, r, setup_s = setup(args.workload, args.seed, args.seconds)
    if args.mode == "coverage":
        out = coverage(cell, r, args.seconds)
    else:
        out = cost(cell, r, args.seconds, bool(args.recording))
    import torch
    out.update(mode=args.mode, workload=args.workload, seed=args.seed,
               seconds=args.seconds, setup_s=setup_s,
               card=torch.cuda.get_device_name(0))
    r.release()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
