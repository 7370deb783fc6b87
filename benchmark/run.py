#!/usr/bin/env python3
"""Run one benchmark cell once on the card.

    python3 benchmark/run.py --workload fleet.f3key-data1 --seed 7 \\
        --seconds 40 --trace 0

from the root of a checkout.  Set-up builds the cell's inputs from the
seed, opens the program (lsdtpu_torch) on them and warms up every shape
the traffic uses; then the window runs the traffic for ``--seconds``;
then the program's state is freed and a plain float64 reference
(benchmark/reference) judges a sample of what the window answered.
``--trace 1`` also traces a bounded slice of the window on the device
and reports the cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, [breakdown], checks); everything else goes on
earlier lines, and the numbers compared end standard error.  Exits 2
without the cards the cell asks for, and 1 if jax, jaxlib, flax or the
JAX package is loaded once the window has closed.

``--mode control`` reads the control instead (the reference in bfloat16
in the program's place, no window) and ``--mode cache-bf16`` runs the
program with its field stored in bfloat16: both have to come out not
correct.  They set and check the limits and are no part of a cell's run.

A cell whose ``chips`` N is above 1 runs over N ranks, one card each
(harness/kind.py, harness/ranks.py).  This process is rank 0: during
set-up it starts ranks 1..N-1 as its children (``run.py --rank k``, the
run on their standard input), every rank with torchrun's environment,
and the program starts its process group as under torchrun.  After the
window every rank hands rank 0 its card: peak memory, traced events,
spans and counters, and the forbidden modules it loaded.  The result
counts N cards, its ``memory_peak_bytes`` is the fullest card's and its
``busy_s`` the cards' mean; lines before it give each card's; the
breakdown is rank 0's card.  A rank that fails, or is not done
``--seconds`` + 180 s after the window began, ends the run with exit 1,
named with the end of its standard error; no rank outlives rank 0.  With
one card no process is started.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lsdtpu")


def environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its CUDA libraries under build/lsdtpu_torch/), and
    one host thread for the math libraries: the load comes from one
    process, and idle pool threads only add noise to a host-bound
    program."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    base = ROOT / "build" / "bench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def loaded_forbidden():
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def fail(msg: str, code: int = 1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "cache-bf16"))
    return ap.parse_args(argv)


def prepare(cuda: bool) -> None:
    import torch
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def open_run(module, cell, seed, seconds, device, mode, rank, world):
    run = module.Run(cell, seed, device=device, mode=mode)
    run.seconds, run.rank, run.world = seconds, rank, world
    return run


def peak_bytes(cuda: bool) -> int:
    """The card's peak memory since its last reset; on the CPU (tests)
    the process's resident set as the window closes (getrusage's peak
    also counts the process it was started from)."""
    if cuda:
        import torch
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def measure(run, seconds, trace, cuda):
    """This rank's window: the card's peak memory from its start, and the
    device trace of a slice of it (``trace``)."""
    import torch
    from harness import trace as tr
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dev_trace = tr.DeviceTrace() if trace else None
    if dev_trace is not None:
        dev_trace.warm()
    run.window(seconds, dev_trace)
    return peak_bytes(cuda), dev_trace


def card(rank, peak, run, dev_trace, program=False):
    """This rank's card (harness/trace.py); ``program``: with the
    program's span records and counters of this process."""
    from harness import trace as tr
    from harness.program import recorded
    spans, counters = recorded() if program else ([], {})
    return tr.Card(rank, int(peak),
                   dev_trace.events if dev_trace is not None else [],
                   dev_trace.slice if dev_trace is not None else None,
                   run.spans.spans, run.spans.counters, spans, counters,
                   loaded_forbidden())


def execute(cell, seed, seconds, trace, mode="program", device="cuda",
            t_start=None):
    """Set up, run the window and judge one cell; returns the result
    object and the lines to print before it.  ``device`` "cpu" runs the
    plain versions (tests).  A cell over several cards starts its other
    ranks here (module docstring)."""
    t_start = time.perf_counter() if t_start is None else t_start
    world = int(cell.entry.get("chips", 1))
    module = cell.traffic_module()
    if world == 1:
        return run_cell(module, cell, seed, seconds, trace, mode, device,
                        t_start)
    if not getattr(module.Run, "ranks", False):
        fail(f"cell {cell.name} asks for {world} cards, and its traffic "
             f"kind {cell.kind!r} does not run over ranks (no "
             f"`ranks = True`)", 2)
    from harness import ranks
    group = ranks.Group(cell, seed, seconds, trace, mode, device)
    try:
        out = run_cell(module, cell, seed, seconds, trace, mode, device,
                       t_start, group)
    except BaseException:
        group.abort()
        raise
    group.close()
    return out


def run_cell(module, cell, seed, seconds, trace, mode, device, t_start,
             group=None):
    """``execute`` on rank 0, with the other ranks' ``group`` (None on
    one card)."""
    import torch
    from harness import trace as tr
    cuda = device != "cpu"
    prepare(cuda)
    world = 1 if group is None else group.world
    run = open_run(module, cell, seed, seconds, device, mode, 0, world)
    run.setup()
    setup_s = time.perf_counter() - t_start
    lines = [f"cell={cell.name} kind={cell.kind} seed={seed} mode={mode} "
             f"seconds={seconds} trace={trace} setup_s={setup_s:.4f}"]
    dev_trace = None
    peak = 0
    if mode != "control":
        if group is not None:
            group.window_started()
        peak, dev_trace = measure(run, seconds, trace, cuda)
    cards = [card(0, peak, run, dev_trace)]
    if group is not None:
        cards += group.gather()
        peak = max(c.memory_peak_bytes for c in cards)
    run.cards = cards
    if mode != "control":
        lines += run.notes()
        if dev_trace is not None:
            ev = dev_trace.events
            lo, hi = dev_trace.slice
            lines.append(
                f"device trace: {len(ev)} events in the slice of "
                f"{dev_trace.n_raw} read, covering "
                f"{(ev[0][2] - lo) / 1e9 if ev else 0:.3f} to "
                f"{(ev[-1][3] - lo) / 1e9 if ev else 0:.3f} s of the "
                f"{(hi - lo) / 1e9:.3f} s slice; start "
                f"{dev_trace.start_s:.3f} s, stop and read "
                f"{dev_trace.stop_s:.3f} s")
    lines.append(f"device memory_peak_bytes={peak}")
    bad = loaded_forbidden()
    if bad:
        fail(f"modules loaded after the window: {bad}")
    for c in cards[1:]:
        if c.forbidden:
            fail(f"modules loaded after the window on rank {c.rank}: "
                 f"{c.forbidden}")
    metrics, device_info, breakdown, view = {}, {}, None, None
    if mode != "control":
        e2e = run.end_to_end()
        e2e["setup_s"] = setup_s
        if trace:
            view = tr.TraceView(run.spans.spans, run.spans.counters,
                                dev_trace.events, dev_trace.slice,
                                run.slice_counts(), run.serving, cards)
            for m in cell.per_layer:
                v = cell.metric_reader(m["name"]).read(view)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            device_info = {"busy_s": tr.device_busy_s(view),
                           "window_s": (view.slice[1] - view.slice[0]) / 1e9}
            breakdown = tr.breakdown(view)
        else:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    if group is not None:
        busy = tr.card_busy_s(view) if view is not None else None
        for c in cards:
            lines.append(f"card {c.rank}: memory_peak_bytes="
                         f"{c.memory_peak_bytes}" +
                         (f" busy_s={busy[c.rank]!r}" if busy else ""))
        if breakdown is not None:
            lines.append("breakdown: rank 0's card alone")
    run.release()
    t_judge = time.perf_counter()
    checks = run.judge()
    lines.append(f"judged in {time.perf_counter() - t_judge:.2f} s; "
                 f"readings not compared: {getattr(run, 'readings', {})}")
    attempted = getattr(run, "attempted", 0)
    failed = run.failed() if mode != "control" else 0
    correct = failed == 0 and all(c["ok"] for c in checks)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": world, "memory_peak_bytes": int(peak),
                         **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                    "op": c["op"]} for c in checks}
    return result, lines, checks


def rank_main(rank: int) -> int:
    """Rank ``rank`` (1..N-1) of a cell over cards, a child of rank 0:
    its run read from standard input, its card handed back on standard
    output once its window has closed (harness/ranks.py)."""
    environment()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness import ranks
    from harness.spec import Cell
    spec, report = ranks.start_rank()
    import torch
    torch.set_num_threads(1)
    cell = Cell(**spec["cell"])
    cuda = spec["device"] != "cpu"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    prepare(cuda)
    run = open_run(cell.traffic_module(), cell, spec["seed"],
                   spec["seconds"], spec["device"], spec["mode"], rank,
                   int(os.environ["WORLD_SIZE"]))
    run.setup()
    peak, dev_trace = 0, None
    if spec["mode"] != "control":
        peak, dev_trace = measure(run, spec["seconds"], spec["trace"], cuda)
    ranks.hand_over(report, card(rank, peak, run, dev_trace, program=True))
    run.release()
    return 0


def emit(result, lines, checks) -> None:
    """The run's lines, the numbers compared (standard error's last
    lines), and the result (standard output's last line)."""
    for ln in lines:
        print(ln, flush=True)
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['op']} "
              f"{c['limit']!r}) {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return rank_main(int(argv[1]))
    args = parse(argv)
    environment()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness.spec import find_cell
    try:
        cell = find_cell(args.workload)
    except (KeyError, FileNotFoundError, ValueError) as e:
        fail(f"cell {args.workload!r}: {e}", 2)
    import torch
    torch.set_num_threads(1)
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card", 2)
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, "
             f"{torch.cuda.device_count()} present", 2)
    try:
        import lsdtpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (lsdtpu_torch) is not in this checkout: {e}", 2)
    emit(*execute(cell, args.seed, args.seconds, args.trace, args.mode,
                  "cuda", T_START))
    return 0


if __name__ == "__main__":
    sys.exit(main())
