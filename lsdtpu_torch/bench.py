"""Headline benchmark of the port: full-loop localization throughput on
one card (counterpart of bench.py at the repository root).

Runs the complete per-frame pipeline (RDP featurization, scan-to-map
association scored by the CalcScore kernel on the mapCache prior,
fusion, UKF) as the port's rollout (runtime/loop.run_sequence) on the
card, and compares it against the REAL C++ reference engine compiled
from its sources and timed live on this host (scripts/refbench/; the
reference's 30-thread pool gets all cores).  If the reference cannot be
built or run here, the baseline is the port's copy of the
reference-semantics numpy oracle (oracle/driver.run_sequence over 60
frames).  Map prep is the oracle's (prepare_map_cached(backend=
"oracle"), cached by content hash).

Prints ONE JSON line on stdout, with bench.py's keys:
  {"metric": "scans_per_sec", "value": N, "unit": "scans/s",
   "vs_baseline": N / baseline_scans_per_sec, ..., "backend": "cuda",
   "card": ..., "power_limit": ...}
Auxiliary numbers (setup, each repeat, ATE, tracking) go to stderr.

Protocol: the configuration pins K = 4096 candidates and P = 2048 scan
pixels with an f32 map context; one warm rollout, then REPEATS = 5
timed repeats, each TIME-TO-VALUE (the poses read to the host before
its clock stops); the median is the headline.  Then the same rollout
with the frames already on the card (one warm, 3 timed), which
separates the per-call host-to-device copy of the frames from the rest.

Differences from bench.py, forced by the port's rules:
  * a failed device probe (a torch subprocess with a timeout, three
    tries) exits non-zero with its message and runs nothing; bench.py
    falls back to the CPU instead.  Without a card the bench exits 2
    with resolve_device's message.  LSDTPU_BENCH_BACKEND=cpu stays an
    explicit request for the CPU (no probe), and so does
    ``lsdtpu-torch --device cpu bench``;
  * main(data, device, cache_dir) takes the dataset directory as an
    argument (default: data1 of the reference datasets, under
    $LSDTPU_REFERENCE, default ~/reference); without it the bench fails
    as bench.py does, with no fallback to other data;
  * no baseline number is built in: a failing oracle baseline raises.

    python -m lsdtpu_torch.bench          # on the card
    lsdtpu-torch bench                    # the same through the CLI
    LSDTPU_BENCH_BACKEND=cpu python -m lsdtpu_torch.bench   # host CPU

LSDTPU_PROBE_TIMEOUT (s, default 90) bounds each probe;
LSDTPU_BENCH_TIMEOUT (s, default 600) arms the watchdog, which prints
the best result so far (or a zero marker) and exits 3 if the run hangs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.eval import ate as eval_ate
from lsdtpu_torch.io import load_dataset
from lsdtpu_torch.oracle import driver as odrv
from lsdtpu_torch.runtime import loop
from lsdtpu_torch.runtime.artifacts import prepare_map_cached

REFERENCE = os.environ.get("LSDTPU_REFERENCE",
                           os.path.join(os.path.expanduser("~"), "reference"))
DATA = os.path.join(REFERENCE, "data_20190513", "data_f3key", "data1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 5              # timed repeats of the headline (median reported)
RESIDENT_REPEATS = 3     # timed repeats with the frames on the card
BASELINE_FRAMES = 60     # frames of the oracle baseline
PROBE_RETRIES = 3
PROBE_WAIT_S = 30.0
PROBE_CODE = ("import torch; x = torch.ones((128, 128), device='cuda'); "
              "print('probe-ok', float((x @ x).sum()))")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_cfg():
    """DEFAULT with bench.py's pinned shapes: K = 4096 candidates, P =
    2048 scan pixels."""
    return dataclasses.replace(DEFAULT, shapes=dataclasses.replace(
        DEFAULT.shapes, max_candidates=4096, max_scan_pixels=2048))


def measure_baseline(ds, lines: np.ndarray, cache: np.ndarray,
                     n_frames: int = BASELINE_FRAMES) -> float:
    """scans/s of the numpy oracle's rollout over the first n_frames."""
    art = odrv.MapArtifacts(map_cache=cache, lines_info=lines, line_im=None)
    t0 = time.perf_counter()
    res = odrv.run_sequence(ds, art, max_frames=n_frames)
    return len(res.poses) / (time.perf_counter() - t0)


def measure_reference_baseline(data: str, n_runs: int = 3):
    """Build (once) and time the C++ reference engine on ``data``.
    Returns (scans_per_sec, n_reset_frames, note) of the chosen run, or
    None where it cannot be built or run.

    The reference is nondeterministic: its threadpool race can drop
    scoring tasks, which both loses tracking and makes the run faster
    (less work), so a plain best-of-N favors broken runs.  Each run
    dumps its pose trace; the baseline is the fastest run with zero
    reset frames, else the fastest overall (logged)."""
    import re
    import tempfile

    build = os.path.join(REPO, "scripts", "refbench", "build.sh")
    bin_path = os.path.join(REPO, "build", "refbench", "lsd_refbench")
    try:
        if not os.path.exists(bin_path):
            if not os.path.exists(build):
                log(f"reference baseline unavailable: no {build}")
                return None
            env = dict(os.environ, REF=os.path.join(REFERENCE, "LSD"))
            subprocess.run(["sh", build], check=True, capture_output=True,
                           timeout=300, env=env)
        runs = []   # (scans_per_sec, n_reset, n_frames)
        with tempfile.TemporaryDirectory() as td:
            for i in range(n_runs):
                dump = os.path.join(td, f"poses{i}.txt")
                out = subprocess.run([bin_path, data, "0", dump],
                                     check=True, capture_output=True,
                                     text=True, timeout=300)
                m = re.search(r"= ([0-9.]+) scans/s", out.stdout)
                if not m:
                    continue
                poses = np.loadtxt(dump, ndmin=2)
                runs.append((float(m.group(1)),
                             int((poses[:, 0] == -1.0).sum()),
                             poses.shape[0]))
        if not runs:
            return None
        clean = [r for r in runs if r[1] == 0]
        if clean:
            sps, resets, _ = max(clean)
            return sps, resets, "fastest tracking-clean run (no bias)"
        sps, resets, _ = max(runs)
        note = _healthy_run_note(runs)
        log(f"reference lost tracking in ALL {n_runs} runs "
            f"(resets: {[r[1] for r in runs]}) - baseline uses the "
            f"fastest broken run; {note}")
        return sps, resets, note
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        # the reference sources are optional
        log("reference baseline unavailable:", e)
        return None


def _healthy_run_note(runs) -> str:
    """What a tracking-healthy reference run would cost: a least-squares
    fit of time_i = (F - r_i) * t_track + r_i * t_event over the runs'
    (total time, reset count) samples; F / (F * t_track) is then the
    healthy run's throughput.  With all reset counts equal the system is
    singular and only the observed band is reported.  Reference for the
    races: LSD/myFA.cpp:45-62."""
    times = np.array([n / s for s, _r, n in runs])
    resets = np.array([float(r) for _s, r, _n in runs])
    frames = np.array([float(n) for _s, _r, n in runs])
    band = f"broken-run band {min(s for s, _r, _n in runs):.0f}-" \
        f"{max(s for s, _r, _n in runs):.0f} scans/s"
    if len(runs) < 2 or np.ptp(resets) == 0:
        return f"healthy-run cost not separable ({band})"
    A = np.stack([frames - resets, resets], axis=1)
    (t_track, t_event), *_ = np.linalg.lstsq(A, times, rcond=None)
    if t_track <= 0:
        return f"healthy-run fit degenerate ({band})"
    return (f"hypothetical tracking-healthy reference ~{1.0 / t_track:.0f} "
            f"scans/s (lstsq over {len(runs)} runs: "
            f"{t_track * 1e3:.2f} ms/tracking-frame, "
            f"{t_event * 1e3:+.2f} ms/reset-event; {band})")


def device_probe(timeout_s: float):
    """A small matmul on the card in a SUBPROCESS with a timeout, so a
    hung card cannot take this process with it; PROBE_RETRIES tries,
    PROBE_WAIT_S apart.  Returns None when it answered, else the last
    failure's message."""
    err, retries = "no probe ran", PROBE_RETRIES
    for attempt in range(retries):
        try:
            r = subprocess.run([sys.executable, "-c", PROBE_CODE],
                               timeout=timeout_s, capture_output=True,
                               text=True)
            if r.returncode == 0 and "probe-ok" in r.stdout:
                return None
            err = (r.stderr.strip().splitlines() or
                   [f"exit {r.returncode}"])[-1]
        except subprocess.TimeoutExpired:
            err = f"no answer within {timeout_s:.0f} s"
        if attempt < retries - 1:
            log(f"device probe attempt {attempt + 1}/{retries} failed "
                f"({err}) - retrying in {PROBE_WAIT_S:.0f}s")
            time.sleep(PROBE_WAIT_S)
    return err


def _arm_watchdog(seconds: float, best: dict):
    """If the bench stalls (a hung card), print the best result so far
    (best["json"]), or a zero marker, so the caller records something
    instead of hanging; exit 0 after a valid measurement, else 3."""
    import threading

    def fire():
        log(f"WATCHDOG: no completion after {seconds:.0f}s - device hung")
        if best["json"]:
            print(best["json"], flush=True)
            os._exit(0)
        print(json.dumps(
            {"metric": "scans_per_sec", "value": 0.0, "unit": "scans/s",
             "vs_baseline": 0.0}), flush=True)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def card_of(dev):
    """(name, power limit) as nvidia-smi gives them; (None, None) on the
    CPU."""
    if dev.type != "cuda":
        return None, None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        name, limit = r.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), limit.strip()
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return torch.cuda.get_device_name(dev), "not read"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(data: str, dev, cache_dir, best: dict) -> dict:
    """The protocol on ``dev``; returns the record of the JSON line.
    After every timed repeat best["json"] holds the line so far."""
    t0 = time.perf_counter()
    ds = load_dataset(data)
    lines, cache = prepare_map_cached(ds.map_value, ds.param.resol,
                                      cache_dir=cache_dir,
                                      dtype=torch.float64, device="cpu",
                                      backend="oracle")
    log(f"setup: {time.perf_counter() - t0:.1f}s, {len(ds.frames)} "
        f"frames, {lines.shape[0]} map lines, backend={dev.type}")

    ref = measure_reference_baseline(data)
    if ref is not None:
        baseline, baseline_resets, baseline_note = ref
        baseline_kind = "cpp-reference"
        log(f"baseline: {baseline:.1f} scans/s (REAL C++ reference, "
            f"best of 3 runs, {os.cpu_count()} cores, "
            f"{baseline_resets} reset frames in that run)")
    else:
        baseline = measure_baseline(ds, lines.numpy(), cache.numpy())
        baseline_kind, baseline_resets = "oracle", 0
        baseline_note = "race-free numpy oracle (no broken-run bias)"
        log(f"baseline: {baseline:.1f} scans/s (numpy oracle)")

    cfg = bench_cfg()
    ctx = loop.make_map_context(lines, cache, ds.param.resol,
                                ds.param.ori_x, ds.param.ori_y,
                                dtype=np.float32, device=dev)
    frames = loop.stack_frames(ds, dtype=np.float32)
    F = frames["ranges"].shape[0]
    name, limit = card_of(dev)
    times = []

    def result(extra=None):
        # the MEDIAN of the completed repeats (min/max carry the noise
        # band), kept after every repeat for the watchdog
        med = statistics.median(times)
        rec = {
            "metric": "scans_per_sec",
            "value": round(F / med, 1),
            "unit": "scans/s",
            "vs_baseline": round(F / med / baseline, 2),
            "n_repeats": len(times),
            "median_ms": round(med * 1e3, 3),
            "min_ms": round(min(times) * 1e3, 3),
            "max_ms": round(max(times) * 1e3, 3),
            "max_scans_per_sec": round(F / min(times), 1),
            "baseline_scans_per_sec": round(baseline, 1),
            "baseline_kind": baseline_kind,
            "baseline_reset_frames": baseline_resets,
            "baseline_note": baseline_note,
            "backend": dev.type,
            "method": "time-to-value",
            "card": name, "power_limit": limit}
        rec.update(extra or {})
        return rec

    def timed(fr):
        _sync(dev)
        t0 = time.perf_counter()
        o = loop.run_sequence(fr, ctx, cfg, device=dev)
        # TIME-TO-VALUE: the clock stops once the poses are on the host
        # (the copy waits for the card); a clock stopped at enqueue
        # would time the dispatch, not the work
        o["pose"].cpu().numpy()
        return o, time.perf_counter() - t0

    _o, dt = timed(frames)
    log(f"first run: {dt:.1f}s")
    for _ in range(REPEATS):
        outs, dt = timed(frames)
        times.append(dt)
        best["json"] = json.dumps(result())
        log(f"  repeat: {dt * 1e3:.2f} ms")
    med = statistics.median(times)

    # informational: the same rollout with the frames already on the
    # card - the headline stays the host-frames number (scans arrive
    # from the host); on the CPU there is no copy to separate
    extra = {}
    if dev.type == "cuda":
        fr_dev = loop.to_device(frames, dev)
        timed(fr_dev)
        dev_med = statistics.median(timed(fr_dev)[1]
                                    for _ in range(RESIDENT_REPEATS))
        log(f"device-resident frames: median {dev_med * 1e3:.2f} ms "
            f"(H2D share ~{(med - dev_med) * 1e3:.1f} ms)")
        extra = {"device_resident_ms": round(dev_med * 1e3, 3),
                 "device_resident_scans_per_sec": round(F / dev_med, 1)}

    poses = outs["pose"].cpu().numpy()
    scores = outs["score"].cpu().numpy()
    tracked = int(np.isfinite(scores).sum())
    rmse = None
    if ds.real_pos is not None:
        a = eval_ate.keyframe_ate(poses, ds.real_pos, ds.recorded_odom,
                                  ds.param.resol, ds.param.ori_x,
                                  ds.param.ori_y)
        rmse = round(float(a.rmse), 4) if np.isfinite(a.rmse) else None
    log(f"{F} frames, median {med * 1e3:.2f} ms over {len(times)} repeats "
        f"({F / med:.0f} scans/s; min {min(times) * 1e3:.2f} ms); "
        f"ATE rmse {rmse} m, tracked {tracked}/{F}")
    if tracked < F or rmse is None:
        log("WARNING: tracking degraded - throughput number suspect")
    return result({"ate_rmse_m": rmse, "tracked": tracked, "frames": F,
                   **extra})


def main(data: str = DATA, device="cuda", cache_dir=None) -> int:
    """Run the bench on ``device`` (LSDTPU_BENCH_BACKEND=cpu: the CPU) and
    print its JSON line.  Returns the exit code: 2 without a card or
    when the device probe fails (nothing then runs)."""
    if os.environ.get("LSDTPU_BENCH_BACKEND") == "cpu":
        log("LSDTPU_BENCH_BACKEND=cpu - the explicit host CPU run")
        device = "cpu"
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        log(f"lsdtpu-torch bench: {e}")
        return 2
    if dev.type == "cuda":
        probe_s = float(os.environ.get("LSDTPU_PROBE_TIMEOUT", "90"))
        err = device_probe(probe_s)
        if err is not None:
            log(f"DEVICE PROBE FAILED ({PROBE_RETRIES} tries, {probe_s:.0f}s "
                f"each): {err} - nothing ran; the bench does not fall back "
                "to the CPU")
            return 2
    # armed after the probes (subprocesses with their own timeouts)
    best = {"json": None}
    watchdog = _arm_watchdog(float(os.environ.get("LSDTPU_BENCH_TIMEOUT",
                                                  "600")), best)
    try:
        rec = run(data, dev, cache_dir, best)
    finally:
        watchdog.cancel()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
