"""A cell over several cards, on the CPU: rank 0 (a process of its own
here, as run.py is) starts the other ranks, each joins the program's
gloo group and all-gathers a tensor a tick (tests/probe_kind.py), and
every card reaches rank 0: its count, its memory (on the CPU the
process's resident set as the window closes), its spans and counters,
on one clock.
A rank that fails, hangs or loads JAX ends the run with exit 1, and no
rank outlives rank 0."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import run as runner
from conftest import BENCH, ROOT
from harness.spec import Cell

PROBE = str(BENCH / "tests" / "probe_kind.py")
LIMITS = {"cards_missing": {"max": 0}, "ticks_apart": {"max": 0},
          "tick_spans_apart": {"max": 0},
          "gather_end_skew_ms": {"max": 50.0}}
E2E = [{"name": "gather_ms", "unit": "ms", "better": "lower", "bound": 0.25,
        "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]
# rank 0 as run.py's main runs it, less the look for a card
RANK0 = """
import json, sys
sys.path[:0] = {paths!r}
import run as runner
from harness import ranks
from harness.spec import Cell
a = json.loads(sys.argv[1])
ranks.GRACE_S = a["grace_s"]
runner.environment()
runner.emit(*runner.execute(Cell(**a["cell"]), a["seed"], a["seconds"], 0,
                            "program", "cpu"))
""".format(paths=[str(BENCH), str(ROOT)])


def probe_cell(world, **workload):
    name = f"probe.w{world}"
    wl = {"config": "probe", "traffic": "probe", "mib": 32,
          "limits": LIMITS, **workload}
    entry = {"name": name, "config": "probe", "traffic": "probe",
             "chips": world}
    return Cell(name, entry, {"name": "probe"}, wl, E2E, [], PROBE)


def rank0_args(world, seconds, grace_s, **workload):
    return [sys.executable, "-c", RANK0, json.dumps(
        {"cell": probe_cell(world, **workload).__dict__, "seed": 2**31 + 9,
         "seconds": seconds, "grace_s": grace_s})]


def clean_env():
    return {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE")}


def launch(world, seconds=1.0, grace_s=180.0, **workload):
    t0 = time.monotonic()
    res = subprocess.run(rank0_args(world, seconds, grace_s, **workload),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=30, env=clean_env())
    return res, time.monotonic() - t0


def started_pids(stderr):
    m = re.search(r"started, pids \[([0-9, ]*)\]", stderr)
    assert m, stderr[-2000:]
    return [int(p) for p in m.group(1).split(",")]


def alive(pid):
    """Whether ``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("world", [2, 4])
def test_every_card_reaches_rank_0(world):
    res, _s = launch(world)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == world
    # every rank's spans and counters reached rank 0, on one clock
    assert out["checks"]["cards_missing"]["value"] == 0
    assert out["checks"]["ticks_apart"]["value"] == 0
    assert out["checks"]["tick_spans_apart"]["value"] == 0
    assert out["checks"]["gather_end_skew_ms"]["value"] <= 50.0
    # the fullest card: the last rank holds (world x 32) MiB
    peaks = {int(k): int(v) for k, v in re.findall(
        r"^card (\d+): memory_peak_bytes=(\d+)", res.stdout, re.M)}
    assert sorted(peaks) == list(range(world))
    assert out["device"]["memory_peak_bytes"] == max(peaks.values())
    assert max(peaks, key=peaks.get) == world - 1
    assert "backend=gloo ticks=" in res.stdout
    assert all(not alive(p) for p in started_pids(res.stderr))


def test_a_rank_raising_in_setup_ends_the_run():
    res, _s = launch(2, fault="raise", fault_rank=1)
    assert res.returncode == 1
    assert "rank 1: exited with code 1" in res.stderr
    assert "planted failure in rank 1's set-up" in res.stderr
    assert '"correct"' not in res.stdout
    assert all(not alive(p) for p in started_pids(res.stderr))


def test_a_hanging_rank_ends_the_run_within_the_bound():
    res, took = launch(3, seconds=1.0, grace_s=3.0, fault="hang",
                       fault_rank=2)
    assert res.returncode == 1
    assert "ranks [0, 1, 2]: not done 3 s after the window's 1 s" in \
        res.stderr
    assert "the end of rank 2's standard error" in res.stderr
    assert '"correct"' not in res.stdout
    assert took < 25.0
    assert all(not alive(p) for p in started_pids(res.stderr))


def test_jax_loaded_on_a_rank_fails_the_run():
    res, _s = launch(2, fault="jax", fault_rank=1)
    assert res.returncode == 1
    assert "modules loaded after the window on rank 1: ['jax']" in \
        res.stderr
    assert '"correct"' not in res.stdout


def test_no_rank_outlives_rank_0_killed_by_sigterm():
    p = subprocess.Popen(rank0_args(2, 60.0, 180.0), cwd=ROOT,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                         text=True, env=clean_env())
    try:
        line = ""
        while "started, pids" not in line:
            line = p.stderr.readline()
            assert line, "rank 0 ended before starting its ranks"
        pids = started_pids(line)
        time.sleep(1.0)
        p.send_signal(signal.SIGTERM)
        p.wait(10)
        t_end = time.monotonic() + 5.0
        while any(alive(q) for q in pids) and time.monotonic() < t_end:
            time.sleep(0.05)
        assert not any(alive(q) for q in pids)
    finally:
        p.kill()
        p.wait()
        p.stderr.close()


def test_more_cards_need_a_kind_over_ranks(tiny):
    cell = tiny("fleet")
    cell.entry["chips"] = 2
    with pytest.raises(SystemExit) as e:
        runner.execute(cell, 5, 0.3, 0, "program", "cpu")
    assert e.value.code == 2


def test_one_card_starts_no_rank(monkeypatch):
    from harness import ranks

    def refuse(*a, **k):
        raise AssertionError("a rank started for one card")

    monkeypatch.setattr(ranks.Group, "__init__", refuse)
    res, lines, _checks = runner.execute(probe_cell(1), 5, 0.3, 0,
                                         "program", "cpu")
    assert res["correct"] and res["device"]["count"] == 1
    assert not any(ln.startswith("card ") for ln in lines)


def test_card_readings_on_a_canned_trace():
    """Two cards on one clock: busy seconds each and their mean, each
    card's idle share of its own rank's serving spans, and another
    rank's program spans clipped to rank 0's slice; a card's card
    survives its trip through the pipe as it was."""
    from harness import program, ranks, trace as tr
    ms = 1_000_000
    card0 = tr.Card(0, 10, [("k", "kernel", 10 * ms, 30 * ms)], (0, 100 * ms),
                    [("step", 0, 40 * ms)])
    card1 = tr.Card(1, 30, [("k", "kernel", 50 * ms, 60 * ms),
                            ("Memcpy DtoH", "dtoh", 90 * ms, 120 * ms)],
                    (1 * ms, 101 * ms), [("step", 40 * ms, 100 * ms)],
                    {"ticks": 3},
                    [program.ProgramSpan("s", 95 * ms, 99 * ms, None, "r",
                                         {"n": 1}, 7),
                     program.ProgramSpan("s", 200 * ms, 210 * ms, None, None,
                                         {}, 8)])
    t = tr.TraceView(card0.spans, {}, card0.events, card0.slice, {},
                     ("step",), [card0, card1])
    assert t.events_by_card == [card0.events, card1.events]
    assert tr.card_busy_s(t) == pytest.approx([0.020, 0.020])
    assert tr.device_busy_s(t) == pytest.approx(0.020)
    shares, mean = tr.card_idle_shares(t)
    assert shares == pytest.approx([0.5, 1 - 20 / 60])
    assert mean == pytest.approx((0.5 + 1 - 20 / 60) / 2)
    assert [s.id for s in program.card_program_spans(t, 1)] == [7]
    back = ranks.decode_card(json.loads(json.dumps(ranks.encode_card(card1))))
    assert back == card1
    lone = tr.TraceView([], {}, [], (0, 100 * ms), {}, ("step",),
                        [card0, tr.Card(1, 0)])
    assert tr.card_idle_shares(lone) == ([0.5, None], None)
