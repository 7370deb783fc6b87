#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsdtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with one H100

Drives the port's paths at the extent of the bundled data1 sequence
(a 979x1440 map at 0.025 m/px, 279 frames of 360-ray scans to 13 m) on
a synthetic multi-room scene made from a seed, since no dataset is
mounted on the card's machine: the per-frame localization rollout
(run_sequence) and map prep (prepare_map: occupancy grid -> LSD map
lines + distance field), then both together, then the streaming entry
point (OnlineLocalizer and the ROS adapter).  Phases, each printed on
its own line; any failure exits non-zero before the last line:

  1. device: the card's name, count and power limit (no card: exit 2);
  2. build: nvcc builds csrc/score.cu, csrc/nfa.cu and csrc/grow.cu, one
     process each, started together (seconds, ptxas registers/spills);
  3. scene: the synthetic scene; its distance field from the port's
     create_map_cache on the card; its map lines from the wall segments;
  4. kernel check: the launch floor (the profiler's device time of a
     one-element PyTorch elementwise kernel), then the CalcScore kernel
     against its plain PyTorch version on the card, at a relock frame
     (~1000 candidates) and a tracking frame (~20), on the pruned and the
     unpruned path, with times, the bound, the floor, the launch counts
     and 50 repeated launches bitwise equal to the first;
  5. rollout: f64 on the card vs the CPU (identical decisions), then f32
     on the card, 3 repeats timed to value, with the kernel's launch
     count checked against one launch per frame (wall-segment lines, as
     before map prep was ported, so the numbers stay comparable);
  6. map prep: f64 on the card vs the CPU (the same lines within 1e-6
     px, the distance field bit-exact, one NFA kernel launch per count
     call), f32 on the card timed to value (median of 3) with the seed
     walk's counters and the device idle share, then the NFA kernel
     against its plain version on every launch the two runs made, on
     degenerate rectangles, and timed (with the bitwise repeat check) on
     three recorded batches;
  7. end to end: grid -> prepare_map (f32, card) -> make_map_context ->
     run_sequence of the 279 frames, 3 repeats, tracked frames and the
     position error against the true trajectory; then the CalcScore
     kernel at that path's relock frame (the port's own LSD lines, its
     K cap of 4096: the main path's largest launch), pruned and
     unpruned;
  8. (inside 4 and 5) the CalcScore kernel on u16/u8/bf16 fields and on
     a 768-px window of the field (col0 != 0), beside the f32 cases; and
     f64 card vs CPU rollouts on a u16 field with a window that engages
     (60 frames, scans clipped to 6 m): identical decisions;
  9. FIFO growth, on the same scene with round pillars (their arcs send
     regions through the radius reducer): the latency probe (SM cycles of
     a dependent on-chip load and of an atan2, for the queue kernels'
     chain bound); f64 FIFO map prep on the card
     (every grow_fifo and radius_reducer_fifo launch recorded) vs the CPU,
     the same lines within 1e-9 px and the same seed walk (else the first
     growth call where the two part ways); every recorded launch replayed through
     the plain versions (same region, queue and count, reg_deg within
     1e-12), 50 repeats of the largest bitwise equal, device time, plain
     time and bound; f32 wave and FIFO map prep timed to value with the
     counters, a sample of the f32 launches replayed; then grid -> FIFO
     map prep -> rollout of the 279 frames, 3 repeats, with every kernel's
     launches counted from 0 over that run;
 10. the streaming entry point (slice 5), on the same scene:
     online_f32 - the 279 scans as ROS-shaped LaserScans (INF where a
     ray hit nothing) through OnlineLocalizer.push_laser_scan (f32,
     wall-segment lines), per-scan latency to the numpy dict (p50, p99,
     max) and scans/s, bitwise equal to run_sequence on the same
     compacted frames, one CalcScore launch per scan, and a checkpoint
     saved after frame 140 resumed in a fresh session, bitwise equal to
     the uninterrupted run; online_polish_f64 - 30 scans with
     match.polish_pose, card vs CPU in f64 (identical decisions, poses
     within 1e-6 px); online_legacy - LsdRosAdapter(mode="legacy") over
     fake /map_metadata, /map (map prep on the card: wave, z = 2, f32;
     NFA launches equal to its count calls, time to value) and 279 /scan
     messages (legacy poses, latency, position error), then f64 legacy
     sessions on the card and the CPU on the adapter's artifacts: the
     same first-minimum pose on every frame;
 11. batched rollouts and the serving pool (slice 6), on the same scene
     and the pillar map: batch_kernel_check - the lane-batched CalcScore
     launch at 8 lanes (the relock frame beside seven tracking frames,
     the last lane on a 700x1100 crop padded with the cap) in f32 and f64,
     pruned and unpruned, and at 16 tracking lanes: against its plain
     version, each lane bit for bit against a single-lane launch, 50
     repeats bitwise, device ms against the sum of the single launches,
     the lanes' summed bound and the floor; batch_f32 - run_batch over 1,
     4, 16 and 64 lanes of 100 frames (the lanes alternating between the
     two maps, each from its own frame offset): time to value (median of
     3), scans/s,
     one batched CalcScore launch a frame, RDP rounds a frame, the device
     idle share of the 16-lane batch; f64 lanes against their solo
     rollouts on the card (identical decisions, poses within 1e-6 px);
     serving_f32 - a 16-slot SessionPool with 1, 4 and 16 active robots
     (per-tick latency to numpy, scans/s, one launch a tick), a robot
     leaving and another taking its slot, and an f64 pool against
     per-robot OnlineLocalizer sessions on the card;
 12. the command-line interface, on the same scene written to a
     dataset directory in the reference's text formats (realPos and
     recored_Odom from every 10th true pose) and read back through the
     port's loaders and native parser, equal to the scene: in this
     process, lsdtpu_torch.cli.main over one artifact cache -
     cli_prepare_map (cold; the --dump files reload to the artifacts),
     cli_run (all frames tracked, records equal to the library rollout
     after the CLI's rounding, the ATE summary), cli_run_legacy,
     cli_refine (1 and 8 segments; the f64 solve on the card within
     1e-9 px/deg of the CPU's, 8 segments within 1e-6 of 1, both timed),
     cli_profile (the per-stage split of a frame, a torch.profiler trace
     holding the CalcScore kernel), cli_batch (two lanes, and --concat),
     cli_serve (two robots), cli_viz (the PNGs open); then
     `python -m lsdtpu_torch.cli run` in a process of its own; every
     kernel's launches counted from 0 around each command;
 13. a JSON line of the kernels (with their launches on each path), the
     nvidia-smi name/power line, and the last line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# peaks of one H100 SXM (NVIDIA data sheet, dense, no tensor cores for
# these scalar ops), used for the bound: bytes over the memory rate,
# operations over the arithmetic rate of the working type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# floating-point operations per live (candidate, pixel) pair: 2 sub +
# 4 mul + 4 add/sub for the transform, 2 add + 2 floor for C-rounding,
# 2 accumulations
OPS_PER_PAIR = 16

# the scene: seed 1 gives a 1072-candidate relock frame, data1's scale
SCENE_SEED = 1
FRAMES = 279  # data1's sequence length
REPEATS = 3   # timed f32 rollouts (median reported)
CODES_FRAMES = 60  # depth of the u16 + window rollout check
PROFILE_FRAMES = 40  # depth of the profiled f32 rollout
PILLARS = 16  # round pillars of the FIFO phases' map (sparse regions)
FIFO_REPEATS = 3  # timed f32 map preps on the FIFO phases' map
RTOL = 2e-6   # f32 kernel vs plain: different summation order
ATOL = 2e-6


_CLOCK = {"start": time.perf_counter()}
_CLOCK["last"] = _CLOCK["start"]


def phase(tag, **kw):
    """One phase line: its values, the seconds since the previous line
    (phase_s) and since the start (t_s)."""
    now = time.perf_counter()
    kw.update(phase_s=round(now - _CLOCK["last"], 2),
              t_s=round(now - _CLOCK["start"], 2))
    _CLOCK["last"] = now
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_cuda(fn, reps):
    """Mean ms per call from CUDA events over ``reps`` warm calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn):
    """Run fn under torch.profiler; returns (wall_ms, {name: [count,
    device_us]}) of the device activities (kernels, copies) it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    acts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a = acts.setdefault(e.name, [0, 0.0])
            a[0] += 1
            a[1] += e.time_range.elapsed_us()
    return wall, acts


def kernel_device_ms(acts, kernel="score_partials_kernel"):
    """Mean device ms per launch of ``kernel``, or None."""
    hits = [v for k, v in acts.items() if kernel in k]
    if not hits:
        return None
    n = sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3


def launch_floor_ms(reps=50):
    """Device ms of the smallest launch: the profiler's mean time of a
    one-element PyTorch elementwise kernel."""
    import torch
    x = torch.zeros(1, device="cuda")
    x.add_(1.0)
    _w, acts = device_profile(lambda: [x.add_(1.0) for _ in range(reps)])
    hits = [v for v in acts.values() if v[0] == reps]
    if not hits:
        fail(f"launch floor: no device kernel launched {reps} times "
             f"({sorted(acts)})")
    return hits[0][1] / reps / 1e3


def repeats_bitwise(name, fn, first, reps=50):
    """Profile ``reps`` launches of fn; fail unless every output equals
    ``first`` bit for bit.  Returns the profiler's activities."""
    import torch
    runs = []
    _w, acts = device_profile(lambda: runs.extend(fn() for _ in range(reps)))
    for r in runs:
        if not all(torch.equal(a, b) for a, b in zip(first, r)):
            fail(f"{name}: {reps} repeated launches are not bitwise equal")
    return acts


def profiled_ms(name, fn, first, kernel, tries=3):
    """Device ms per launch of ``kernel`` over 50 launches of fn, each
    bitwise equal to ``first`` (repeats_bitwise); the profile is taken
    again when its activities miss the kernel (the profiler's device
    events can come back empty).  None when every try missed."""
    for _ in range(tries):
        ms = kernel_device_ms(repeats_bitwise(name, fn, first), kernel)
        if ms is not None:
            return ms
    return None


def lane_work(feats, idx, n, px, py, n_pix, field, row0, col0, rows, cols):
    """(bytes, pairs, distinct cells) one frame's CalcScore launch needs
    for this data: its live (candidate, pixel) pairs, each input read
    once (the live candidates' features, the live pixels, each distinct
    field cell the pairs touch, the survivor list) and the 4 outputs of
    every slot written once."""
    import torch
    from lsdtpu_torch.match import associate as assoc
    K = feats.shape[1]
    n_live = int(n)
    P = int(n_pix)
    sel = torch.arange(n_live, device=feats.device) if idx is None \
        else idx[:n_live].long()
    ca, sa, sx, sy, mx, my = feats[:, sel][:, :, None]
    tx = (px[None, :P] - sx) * ca - (py[None, :P] - sy) * sa + mx
    ty = (px[None, :P] - sx) * sa + (py[None, :P] - sy) * ca + my
    fx, fy = assoc.geo.c_round(tx), assoc.geo.c_round(ty)
    bh, bw = field.shape
    ins = (fx >= max(col0, 0)) & (fx < min(cols, col0 + bw)) & \
        (fy >= max(row0, 0)) & (fy < min(rows, row0 + bh))
    cells = int(torch.unique((fy[ins] * cols + fx[ins]).long()).numel())
    esize = feats.element_size()
    nbytes = (esize * (6 * n_live + 2 * P)                # inputs read once
              + field.element_size() * cells
              + (4 * n_live if idx is not None else 0)    # survivor list
              + K * (2 * esize + 2 * 4))                  # the 4 outputs
    return nbytes, n_live * P, cells


def bound(nbytes, pairs, dt):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the pairs' operations over the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_PAIR * pairs / PEAK_OPS[str(dt).split(".")[1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_case(name, cand, fs, ctx, cfg, coarse, device, reps, card,
                floor_ms, block=None):
    """Kernel vs plain on one frame's inputs; returns the measurements.
    block: (field view, row0, col0) to score instead of the whole field
    (a window), else ctx.cache."""
    import torch
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.ops import score as sc

    dt = cand.ca.dtype
    K = cand.ca.shape[0]
    feats = cand.feats()
    px, py, n_pix = assoc.pixel_args(fs.pixels, fs.pixels_mask, dt)
    z = cfg.map.z_occ_max_dis
    pen = cfg.match.max_dist_penalty
    if name.endswith("_pruned"):
        m = cfg.match
        idx, n = assoc.prune_survivors(
            cand, fs.pixels, fs.pixels_mask, coarse, ctx.rows, ctx.cols, z,
            pen, m.valid_ratio, m.obstacle_tolerance, m.score_accept,
            m.prune_block, m.prune_group)
    else:
        idx, n = None, cand.count.clamp(0, K).to(torch.int32)
    field, row0, col0 = (ctx.cache, 0, 0) if block is None else block
    # (col0 only for a window: scripts/torch_kernel_ab.py runs these cases
    # against checkouts whose score_partials predates it)
    args = (feats, idx, n, px, py, n_pix, field, row0, ctx.rows, ctx.cols,
            z, pen, z) + ((col0,) if col0 else ())
    before = sc.score_partials.launches
    got = sc.score_partials(*args)
    torch.cuda.synchronize()
    want = sc.score_partials_reference(*args)
    for i in (1, 3):
        if not torch.equal(got[i], want[i]):
            fail(f"{name}: kernel counts differ from the plain version")
    err = 0.0
    for i in (0, 2):
        g, w = got[i].double(), want[i].double()
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            fail(f"{name}: kernel sums differ from the plain version "
                 f"(max abs err {err})")
    s_got = assoc.finalize_scores(cand, got[0], got[1], fs.pixels_mask.sum()
                                  .to(dt), got[2], got[3], pen)
    s_want = assoc.finalize_scores(cand, want[0], want[1],
                                   fs.pixels_mask.sum().to(dt), want[2],
                                   want[3], pen)
    if not torch.equal(torch.isfinite(s_got), torch.isfinite(s_want)):
        fail(f"{name}: finite pattern of scores differs")
    # work this run's data needs: live pairs, distinct cells touched
    nbytes, pairs, cells = lane_work(feats, idx, n, px, py, n_pix, field,
                                     row0, col0, ctx.rows, ctx.cols)
    bh, bw = field.shape
    bound_ms, bound_by = bound(nbytes, pairs, dt)
    out = dict(name=name, field=str(field.dtype).split(".")[1],
               window=f"{bh}x{bw}@({row0},{col0})", live_candidates=int(n),
               live_pixels=int(n_pix), pairs=pairs, distinct_cells=cells,
               max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               check_launches=sc.score_partials.launches - before)
    # device time per launch from the profiler; CUDA events over
    # back-to-back launches also include the host's launch gaps
    dev_ms = profiled_ms(name, lambda: sc.score_partials(*args), got,
                         "score_partials_kernel")
    out["repeats_bitwise"] = 50
    out["kernel_ms"] = time_cuda(lambda: sc.score_partials(*args), reps)
    out["ms"] = out["kernel_ms"] if dev_ms is None else dev_ms
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: sc.score_partials_reference(*args), max(5, reps // 20))
    out["floor_ms"] = floor_ms
    phase("kernel_check", **out, bound_us=out["bound_ms"] * 1e3, card=card)
    return out


def make_scene(pillars=0):
    """The synthetic scene at data1's extent (seed SCENE_SEED), with
    ``pillars`` round pillars (the FIFO phases' map: their arcs give the
    sparse regions that send FIFO growth through the radius reducer)."""
    from lsdtpu_torch.io import synth
    return synth.synth_dataset(SCENE_SEED, F=FRAMES, H=979, W=1440,
                               resol=0.025, rmax=13.0, n_walls=46,
                               clear_m=2.5, wall_scale=2.5, pillars=pillars)


def score_frame_cases(scene, ctx, cfg, device, card, floor_ms, prefix="",
                      frames=("relock", "tracking"),
                      paths=("unpruned", "pruned"), window=0):
    """kernel_case on the given paths at the relock frame (frame 0, no
    prior pose: the full sweep) and a tracking frame (frame 1 from the
    true pose), as the main path builds them.  window > 0 scores a
    (window, window) view of the field around the pose (the windowed
    scorer's block, col0 != 0) instead of the whole field."""
    import torch
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.io import synth
    ds = scene.dataset
    sh = cfg.shapes
    dt = ctx.lines.dtype
    coarse = loop.prepare_coarse(ctx, cfg)
    fr = loop.stack_frames(ds, dtype=np.dtype(str(dt).split(".")[1]).type,
                           max_frames=2)
    truth = synth.true_pose_px(scene)
    cases = []
    for f, frame in ((0, "relock"), (1, "tracking")):
        if frame not in frames:
            continue
        inp = tuple(torch.as_tensor(fr[k][f], device=device)
                    for k in loop._FRAME_KEYS)
        fs = loop.featurize_stage(inp, ctx, cfg)
        last_pose = (loop.init_state(dt, device).last_pose if f == 0 else
                     torch.tensor([truth[f][0], truth[f][1], 0.0], dtype=dt,
                                  device=device))
        cand = assoc.generate_candidates(
            fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
            loop.geo.c_round(fs.lidar_pos), last_pose, sh.max_candidates,
            cfg.match.ignore_scan_length, cfg.match.scan_to_map_diff,
            cfg.match.max_esti_dist)
        block = None
        if window:
            _fits, r0, c0 = assoc.window_origin(
                window, torch.as_tensor(truth[max(f, 1)], dtype=dt,
                                        device=device),
                torch.zeros((), dtype=dt, device=device),
                cfg.match.max_esti_dist, ctx.rows, ctx.cols)
            block = (ctx.cache[r0:r0 + window, c0:c0 + window], r0, c0)
        for path in paths:
            c = kernel_case(f"{prefix}{frame}_{path}", cand, fs, ctx, cfg,
                            coarse, device, reps=200, card=card,
                            floor_ms=floor_ms, block=block)
            c["k_cap"] = sh.max_candidates
            cases.append(c)
    return cases

# --- map prep (slice 2) ------------------------------------------------

# operations of the NFA count per covered (rectangle, pixel) pair: sub,
# abs, compare, the 2*pi fold (sub, abs), compare; per (rectangle,
# column) walked: the column test (add, sub, 2 compares), the two bound
# expressions (sub, mul, add, compare each), ceil, floor, 4 range
# compares, 2 clamps
OPS_PER_COVERED = 6
OPS_PER_COLUMN = 20


def record_rect_counts(run):
    """Run ``run()`` with every rect_counts call recorded as (deg_map,
    scalars, all_pix, ali_pix); returns (result, calls)."""
    import types
    from lsdtpu_torch.mapprep import nfa as mnfa
    onfa = mnfa.onfa
    calls = []

    def rec(deg_map, scalars):
        out = onfa.rect_counts(deg_map, scalars)
        calls.append((deg_map, scalars.clone(), out[0].clone(),
                      out[1].clone()))
        return out

    # map prep reaches the kernel through mapprep/nfa.py's module
    # reference; the wrapper itself (and its launch count) stays as is
    mnfa.onfa = types.SimpleNamespace(rect_counts=rec)
    try:
        return run(), calls
    finally:
        mnfa.onfa = onfa


def match_lines(a, b, tol):
    """Greedy endpoint matching of two (n, 10) line sets (either
    direction); the number of rows of b matched within tol px."""
    used = np.zeros(len(a), bool)
    n = 0
    for rb in b:
        d = np.minimum(np.abs(a[:, 4:8] - rb[4:8]).max(1),
                       np.abs(a[:, [6, 7, 4, 5]] - rb[4:8]).max(1))
        d[used] = np.inf
        if len(a) and d.min() <= tol:
            used[int(np.argmin(d))] = True
            n += 1
    return n


def nfa_case(name, deg_map, scalars, reps, card, floor_ms):
    """The NFA kernel against its plain version on one recorded batch:
    counts, times, bound."""
    import torch
    from lsdtpu_torch.ops import nfa as onfa
    got = onfa.rect_counts(deg_map, scalars)
    torch.cuda.synchronize()
    want = onfa.rect_counts_reference(deg_map, scalars)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"nfa {name}: kernel counts differ from the plain version")
    inside = onfa.rect_inside(deg_map, scalars)
    R = scalars.shape[0]
    pairs = int(inside.sum())
    distinct = int(inside.any(0).sum())
    columns = int(inside.any(1).sum())
    esize = deg_map.element_size()
    nbytes = esize * (distinct + R * onfa.N_SCALARS) + R * 2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((OPS_PER_COVERED * pairs + OPS_PER_COLUMN * columns)
             / PEAK_OPS[str(deg_map.dtype).split(".")[1]] * 1e3)
    out = dict(name=name, rects=R, covered_pairs=pairs,
               distinct_pixels=distinct, max_abs_err=0.0,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    dev_ms = profiled_ms(f"nfa {name}",
                         lambda: onfa.rect_counts(deg_map, scalars), got,
                         "rect_counts_kernel")
    out["repeats_bitwise"] = 50
    out["kernel_ms"] = time_cuda(lambda: onfa.rect_counts(deg_map, scalars),
                                 reps)
    out["ms"] = out["kernel_ms"] if dev_ms is None else dev_ms
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: onfa.rect_counts_reference(deg_map, scalars), 20)
    out["floor_ms"] = floor_ms
    phase("nfa_kernel_check", **out, bound_us=out["bound_ms"] * 1e3,
          card=card)
    return out


def nfa_cases(calls, card, floor_ms):
    """nfa_case on three recorded launches of an f32 map prep: the one
    covering the most pixels and the median R = 1 and R = 5 launches."""
    def typical(r):
        sel = sorted((int(c[2].sum()), i) for i, c in enumerate(calls)
                     if c[1].shape[0] == r)
        return sel[len(sel) // 2][1] if sel else None

    most = max(range(len(calls)), key=lambda i: int(calls[i][2].sum()))
    out = []
    for label, i in (("most_covered", most), ("typical_R1", typical(1)),
                     ("typical_R5", typical(5))):
        if i is None:
            phase("nfa_kernel_check", name=label, note="'no such launch'")
            continue
        out.append(nfa_case(label, calls[i][0], calls[i][1], 200, card,
                            floor_ms))
    return out


def degenerate_rects(deg_map):
    """Packed scalars of a vertical, a horizontal and a partly
    out-of-image rectangle on deg_map's field (inf/NaN edge slopes and
    the INT_MIN bound conversion)."""
    import torch
    from lsdtpu_torch.mapprep import nfa as mnfa
    t = np.dtype(str(deg_map.dtype).split(".")[1]).type
    H, W = deg_map.shape
    recs = []
    for x1, y1, x2, y2, wid in ((40, 10, 40, H - 20, 3.0),
                                (10, 50, W - 30, 50, 2.0),
                                (-12, -5, 60, 30, 4.0),
                                (W - 20, H - 10, W + 15, H + 8, 5.0)):
        th = np.arctan2(y2 - y1, x2 - x1)
        recs.append({k: t(v) for k, v in dict(
            x1=x1, y1=y1, x2=x2, y2=y2, wid=wid, dx=np.cos(th),
            dy=np.sin(th), deg=0.3, prec=0.125 * np.pi).items()})
    with np.errstate(all="ignore"):
        sc = np.stack([mnfa.pack_rect_scalars(r) for r in recs])
    return torch.from_numpy(sc).to(deg_map.device)

# --- FIFO growth (slice 4) ---------------------------------------------

# operations the bound counts: per popped pixel 9 neighbour tests (bounds,
# flags, angle difference, fold, compare: ~6 each); per accepted pixel two
# adds and an atan2 (~20 float operations).  Per reducer point a distance
# (2 sub, 2 mul, add, sqrt) and a compare.
OPS_PER_POP = 54
OPS_PER_ACCEPT = 22
OPS_PER_REDUCER_POINT = 7


def record_fifo(run):
    """Run ``run()`` with every grow_fifo and radius_reducer_fifo call of
    map prep recorded (inputs and outputs, cloned); returns (result,
    grows, reduces)."""
    import types
    import torch
    from lsdtpu_torch.mapprep import lsd as mlsd
    from lsdtpu_torch.mapprep import rect as mrect
    og = mlsd.ogrow
    grows, reduces = [], []

    def grow(sy, sx, thre, ban, deg, sn, cs, queue=None):
        out = og.grow_fifo(sy, sx, thre, ban, deg, sn, cs, queue)
        n = int(out.counts[0])
        grows.append(dict(
            sy=sy, sx=sx, ban=ban.clone(), deg=deg, sn=sn, cs=cs,
            thre=thre.clone() if torch.is_tensor(thre) else thre,
            cur=out.cur.clone(), reg_deg=out.reg_deg.clone(),
            qy=out.qy[:n].clone(), qx=out.qx[:n].clone(),
            counts=out.counts.clone()))
        return out

    def reduce(sx, sy, rad, qy, qx, n, cur, fit):
        m = int(n[0])
        rec = dict(sx=sx, sy=sy, rad=rad, inputs=tuple(
            t.clone() for t in (qy[:m], qx[:m], n, cur, fit)))
        og.radius_reducer_fifo(sx, sy, rad, qy, qx, n, cur, fit)
        rec["outputs"] = tuple(t.clone() for t in (qy[:m], qx[:m], n, cur,
                                                   fit))
        reduces.append(rec)

    ns = types.SimpleNamespace(fifo_queue=og.fifo_queue, grow_fifo=grow,
                               radius_reducer_fifo=reduce)
    mlsd.ogrow, mrect.ogrow = ns, ns
    try:
        return run(), grows, reduces
    finally:
        mlsd.ogrow, mrect.ogrow = og, og


def replay_grow(c, cpu_maps):
    """One recorded grow_fifo launch through the plain version on the
    CPU; returns (same region, queue and count, reg_deg difference)."""
    import torch
    from lsdtpu_torch.ops import grow as og
    deg, sn, cs = cpu_maps
    H, W = deg.shape
    thre = c["thre"].cpu() if torch.is_tensor(c["thre"]) else c["thre"]
    want = og.grow_fifo_reference(c["sy"], c["sx"], thre, c["ban"].cpu(), deg,
                                  sn, cs, og.fifo_queue(H, W, "cpu"))
    n = int(want.counts[0])
    same = (c["counts"].cpu().tolist() == want.counts.tolist()
            and torch.equal(c["cur"].cpu(), want.cur)
            and torch.equal(c["qy"].cpu(), want.qy[:n])
            and torch.equal(c["qx"].cpu(), want.qx[:n]))
    return same, abs(float(c["reg_deg"]) - float(want.reg_deg))


def replay_reduce(c):
    """One recorded radius_reducer_fifo launch through the plain version
    on the CPU; True when every output is equal."""
    import torch
    from lsdtpu_torch.ops import grow as og
    cpu = tuple(t.cpu().clone() for t in c["inputs"])
    og.radius_reducer_fifo_reference(c["sx"], c["sy"], c["rad"], *cpu)
    return all(torch.equal(a.cpu(), b) for a, b in zip(c["outputs"], cpu))


def grow_bound(c, lat, sm_clock_hz):
    """The bound of one grow_fifo launch from this run's data.  The
    queue is serial, so its bound is the dependent chain: each popped
    pixel one dependent on-chip load (the faster of a shared-memory load
    and an L1 hit) and each accepted pixel, the seed's start angle
    included, one atan2 of the working type, at the latencies ``lat``
    measured on this card (ops/grow.py:latency_probe) and the maximum SM
    clock.  Beside it, bytes (the cells the walk touches - the region and
    its 8-neighbour ring - read once as angle, sin, cos and ban; the
    region mask, queue, angle and counts written once) and operations;
    the bound is the largest of the three."""
    import torch.nn.functional as F
    cur = c["cur"]
    dt = str(c["deg"].dtype).split(".")[1]
    esize = c["deg"].element_size()
    n, pops, _passes = c["counts"].tolist()
    ring = F.max_pool2d(cur.float()[None, None], 3, 1, 1)[0, 0] > 0
    touched = int(ring.sum())
    nbytes = touched * (3 * esize + 1) + cur.numel() + 8 * n + 12 + esize
    ops = OPS_PER_POP * pops + OPS_PER_ACCEPT * (n - 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    load = min(lat["smem_load"], lat["l1_load"])
    t_chain = (pops * load + n * lat[f"atan2_{dt}"]) / sm_clock_hz * 1e3
    return dict(bound_ms=max(t_bytes, t_ops, t_chain),
                bound_by="bytes" if t_bytes >= max(t_ops, t_chain)
                else "operations", bound_kind="dependent chain",
                chain_bound_ms=t_chain, bytes_bound_ms=t_bytes,
                ops_bound_ms=t_ops, touched_cells=touched, pops=pops,
                accepted=n - 1)


def reduce_bound(c, lat, sm_clock_hz, dt):
    """The bound of one radius_reducer_fifo pass: the dependent chain,
    one on-chip load per examined point (the slot a point is read from
    depends on the decision before it), as in grow_bound; beside it the
    n live queue entries read and written once, a mask cell written per
    removed point and the count, and the operations per point."""
    n = int(c["inputs"][2][0])
    removed = n - int(c["outputs"][2][0])
    nbytes = 16 * n + 2 * removed + 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_REDUCER_POINT * n / PEAK_OPS[dt] * 1e3
    t_chain = n * min(lat["smem_load"], lat["l1_load"]) / sm_clock_hz * 1e3
    return dict(bound_ms=max(t_bytes, t_ops, t_chain),
                bound_by="bytes" if t_bytes >= max(t_ops, t_chain)
                else "operations", bound_kind="dependent chain",
                chain_bound_ms=t_chain, bytes_bound_ms=t_bytes,
                ops_bound_ms=t_ops, points=n, removed=removed)


def first_differing_growth(a, b):
    """The first growth call at which two recorded FIFO map preps part
    ways (seed, threshold, ban mask or outcome), as (index, the card's
    call, the CPU's call) summaries; None when every call agrees."""
    import torch

    def summary(c):
        return dict(seed=(c["sy"], c["sx"]), thre=float(c["thre"]),
                    counts=c["counts"].tolist(),
                    reg_deg=float(c["reg_deg"]))

    for i, (x, y) in enumerate(zip(a, b)):
        if (summary(x) != summary(y)
                or not torch.equal(x["ban"].cpu(), y["ban"].cpu())
                or not torch.equal(x["cur"].cpu(), y["cur"].cpu())):
            return i, summary(x), summary(y)
    if len(a) != len(b):
        i = min(len(a), len(b))
        return i, (summary(a[i]) if i < len(a) else None), \
            (summary(b[i]) if i < len(b) else None)
    return None


def plain_ms(fn, reps=3):
    """Mean host ms of a plain version's call on CPU tensors."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi, in Hz."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def fifo_kernel_cases(grows, reduces, card, floor_ms, lat, clock):
    """Device time of the largest recorded grow_fifo region (50 launches,
    bitwise equal to the first) and of the largest reducer pass, with
    their bounds and their plain versions' times."""
    import torch
    from lsdtpu_torch.ops import grow as og
    big = max(grows, key=lambda c: int(c["counts"][1]))
    H, W = big["deg"].shape
    queue = og.fifo_queue(H, W, big["deg"].device)
    n = int(big["counts"][0])

    def launch():
        g = og.grow_fifo(big["sy"], big["sx"], big["thre"], big["ban"],
                         big["deg"], big["sn"], big["cs"], queue)
        return g.cur, g.reg_deg, g.qy[:n].clone(), g.qx[:n].clone(), g.counts

    first = tuple(t.clone() for t in launch())
    if not (torch.equal(first[0], big["cur"])
            and torch.equal(first[4], big["counts"])):
        fail("grow_fifo: a relaunch on the largest region differs from the "
             "recorded launch")
    grow_ms, grow_src = profiled_ms("grow_fifo", launch, first,
                                    "grow_fifo_kernel"), "profiler"
    if grow_ms is None:
        grow_ms, grow_src = time_cuda(launch, 50), "cuda events"
    cpu_maps = tuple(t.cpu() for t in (big["deg"], big["sn"], big["cs"]))
    thre = big["thre"].cpu() if torch.is_tensor(big["thre"]) else big["thre"]
    g_out = dict(
        name="grow_largest", seed=(big["sy"], big["sx"]),
        dtype=str(big["deg"].dtype).split(".")[1], region=n,
        **grow_bound(big, lat, clock), repeats_bitwise=50,
        ms=grow_ms, ms_source=grow_src,
        plain_ms=plain_ms(lambda: og.grow_fifo_reference(
            big["sy"], big["sx"], thre, big["ban"].cpu(), *cpu_maps,
            og.fifo_queue(H, W, "cpu"))), floor_ms=floor_ms)
    phase("grow_kernel_check", **g_out, bound_us=g_out["bound_ms"] * 1e3,
          chain_bound_us=g_out["chain_bound_ms"] * 1e3, card=card)
    out = [g_out]
    if reduces:
        rb = max(reduces, key=lambda c: int(c["inputs"][2][0]))

        def rlaunch():
            t = tuple(x.clone() for x in rb["inputs"])
            og.radius_reducer_fifo(rb["sx"], rb["sy"], rb["rad"], *t)
            return t

        r_first = rlaunch()
        if not all(torch.equal(a, b) for a, b in zip(r_first, rb["outputs"])):
            fail("radius_reducer_fifo: a relaunch differs from the recorded "
                 "launch")
        r_ms, r_src = profiled_ms("radius_reducer_fifo", rlaunch, r_first,
                                  "radius_reducer_fifo_kernel"), "profiler"
        if r_ms is None:
            r_ms, r_src = time_cuda(rlaunch, 50), "cuda events"
        dt_name = "float32" if isinstance(rb["rad"], np.float32) \
            else "float64"
        r_out = dict(
            name="reducer_largest", **reduce_bound(rb, lat, clock, dt_name),
            repeats_bitwise=50,
            ms=r_ms, ms_source=r_src,
            plain_ms=plain_ms(lambda: og.radius_reducer_fifo_reference(
                rb["sx"], rb["sy"], rb["rad"],
                *(t.cpu().clone() for t in rb["inputs"]))),
            floor_ms=floor_ms)
        phase("grow_kernel_check", **r_out, bound_us=r_out["bound_ms"] * 1e3,
              chain_bound_us=r_out["chain_bound_ms"] * 1e3, card=card)
        out.append(r_out)
    return out


# --- the streaming entry point (slice 5) -------------------------------

CHECKPOINT_AFTER = 140  # online_f32 saves its session after this frame
POLISH_FRAMES = 30      # depth of the f64 polish check, card vs CPU
SCAN_INC = 2.0 * np.pi / 360  # the raycaster's ray step (360 rays)


def rmse_m(poses_px, scene, tracked):
    """Position RMSE (m) of the tracked frames against the true
    trajectory, through the port's keyframe ATE (every frame a
    keyframe)."""
    from lsdtpu_torch.eval.ate import keyframe_ate
    p = scene.dataset.param
    n = int(tracked.sum())
    return keyframe_ate(poses_px[tracked], scene.true_pos[tracked],
                        np.arange(1, n + 1), p.resol, p.ori_x,
                        p.ori_y).rmse


def ros_scans(ds):
    """The frames as ROS LaserScan ranges on the raycaster's uniform
    360-ray grid (angle_min 0, SCAN_INC apart): INF where the ray hit
    nothing."""
    out = []
    for fr in ds.frames:
        full = np.full(360, np.inf)
        full[np.rint(fr[:, 1] / SCAN_INC).astype(int)] = fr[:, 0]
        out.append(full)
    return out


def ros_map_messages(ds):
    """(/map_metadata, /map) messages of the scene's grid: the int8
    payload inverts the ROS node's remap (-1 unknown, 0 free, 100
    occupied; main_on_linux.cpp:108-124)."""
    import types
    h, w = ds.map_value.shape
    p = ds.param
    grid = np.full(ds.map_value.shape, 100, np.int8)
    grid[ds.map_value == 0] = -1
    grid[ds.map_value == 255] = 0
    ns = types.SimpleNamespace
    meta = ns(width=w, height=h, resolution=p.resol,
              origin=ns(position=ns(x=p.ori_x, y=p.ori_y)))
    return meta, ns(data=grid.reshape(-1))


def stream(push, scans, ds, frames, after=None):
    """Push ``frames`` through ``push(scan, odom)``, timing each push to
    its numpy dict; ``after(f)`` runs after frame f's push, untimed.
    Returns (stacked outputs, per-push ms)."""
    outs, lat = [], []
    for f in frames:
        t0 = time.perf_counter()
        outs.append(push(scans[f], ds.odom[f + 1]))
        lat.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(f)
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}, lat


def latency_stats(lat):
    lat = np.asarray(lat)
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                max_ms=float(lat.max()),
                scans_per_s=len(lat) / float(lat.sum()) * 1e3)


def first_difference(a, b, keys):
    """The first frame at which two stacked outputs differ in any of
    ``keys`` (NaN equal to NaN), or None."""
    for f in range(len(a[keys[0]])):
        if not all(np.array_equal(a[k][f], b[k][f], equal_nan=True)
                   for k in keys):
            return f
    return None


def online_tracking(scene, lines, cache64, cfg, device, smi, kind):
    """online_f32: the scans through OnlineLocalizer.push_laser_scan on
    the card, against run_sequence on the same compacted frames, with a
    checkpoint after CHECKPOINT_AFTER frames resumed in a fresh session.
    Returns the CalcScore launches of the streamed run."""
    import tempfile
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.online import (OnlineLocalizer,
                                             laser_scan_to_polar)
    ds = scene.dataset
    p = ds.param
    scans = ros_scans(ds)
    F = len(scans)

    def session():
        loc = OnlineLocalizer(cfg, dtype=np.float32, device=device)
        loc.set_map_artifacts(lines, cache64, p.resol, p.ori_x, p.ori_y)
        return loc

    def push(loc):
        return lambda r, odom: loc.push_laser_scan(r, 0.0, SCAN_INC, odom)

    loc = session()
    stream(push(loc), scans, ds, range(3))           # warm-up
    loc.reset()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/session.npz"

        def save(f):
            if f + 1 == CHECKPOINT_AFTER:
                loc.save(ckpt)

        sc.score_partials.launches = 0
        got, lat = stream(push(loc), scans, ds, range(F), after=save)
        launches = sc.score_partials.launches
        resumed = session()
        resumed.restore(ckpt)
        tail, _ = stream(push(resumed), scans, ds,
                         range(CHECKPOINT_AFTER, F))
    if launches != F:
        fail(f"online_f32: {launches} CalcScore launches for {F} scans")
    fr = loop.stack_frames(ds, dtype=np.float32)
    for f, r in enumerate(scans):
        rr, aa = laser_scan_to_polar(r, 0.0, SCAN_INC)
        fr["ranges"][f, :len(rr)] = rr
        fr["angles"][f, :len(aa)] = aa
    fr["odom_prev"][0] = fr["odom_cur"][0]   # the first scan's own anchor
    want = {k: v.cpu().numpy() for k, v in
            loop.run_sequence(fr, loc.ctx, cfg, device=device).items()}
    keys = sorted(want)
    diff = first_difference(got, want, keys)
    if diff is not None:
        fail(f"online_f32: frame {diff} differs from run_sequence "
             f"(pose {got['pose'][diff]} vs {want['pose'][diff]})")
    ref = {k: v[CHECKPOINT_AFTER:] for k, v in got.items()}
    diff = first_difference(tail, ref, keys)
    if diff is not None:
        fail(f"online_f32: resumed frame {CHECKPOINT_AFTER + diff} differs "
             "from the uninterrupted session")
    tracked = np.isfinite(got["score"]) & ~np.isnan(got["pose"]).any(1)
    phase("online_f32", device=repr(kind), card=repr(smi), scans=F,
          run_sequence="bitwise", resume_after=CHECKPOINT_AFTER,
          resumed_frames=F - CHECKPOINT_AFTER, resume="bitwise",
          score_launches=launches, tracked=int(tracked.sum()),
          rmse_m=rmse_m(got["pose"], scene, tracked), **latency_stats(lat),
          first_scan_ms=lat[0])
    return launches


def online_polish(scene, lines, cache64, cfg, device, smi):
    """online_polish_f64: POLISH_FRAMES scans with match.polish_pose on
    the card and the CPU in f64: identical decisions, poses within 1e-6
    px."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    ds = scene.dataset
    p = ds.param
    scans = ros_scans(ds)
    cfg_p = dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, polish_pose=True))
    runs = []
    for dev in (device, torch.device("cpu")):
        loc = OnlineLocalizer(cfg_p, dtype=np.float64, device=dev)
        loc.set_map_artifacts(lines, cache64, p.resol, p.ori_x, p.ori_y)
        sc.score_partials.launches = 0
        out, lat = stream(
            lambda r, odom: loc.push_laser_scan(r, 0.0, SCAN_INC, odom),
            scans, ds, range(POLISH_FRAMES))
        runs.append((out, lat, sc.score_partials.launches))
    (a, lat, launches), (b, _l, _n) = runs
    same = (np.array_equal(a["n_candidates"], b["n_candidates"])
            and np.array_equal(np.isfinite(a["score"]),
                               np.isfinite(b["score"])))
    ok = ~np.isnan(a["pose"]).any(1) & ~np.isnan(b["pose"]).any(1)
    dpose = float(np.abs(a["pose"][ok] - b["pose"][ok]).max())
    if not same or not dpose <= 1e-6:
        f = first_difference(
            {k: a[k] for k in ("n_candidates", "pose")},
            {k: b[k] for k in ("n_candidates", "pose")},
            ["n_candidates", "pose"])
        fail(f"online_polish_f64: card and CPU part at frame {f}: "
             f"{a['pose'][f]} vs {b['pose'][f]} (max pose diff {dpose})")
    phase("online_polish_f64", card=repr(smi), frames=POLISH_FRAMES,
          decisions="identical", max_pose_diff_px=dpose,
          score_launches=launches, tracked=int(np.isfinite(a["score"]).sum()),
          card_p50_ms=float(np.median(lat)))
    return launches


def online_legacy(scene, cfg, device, smi, kind):
    """online_legacy: LsdRosAdapter(mode="legacy") on the card over fake
    /map_metadata, /map and /scan messages (map prep on the card: wave,
    z = 2, f32), then f64 legacy sessions on the card and the CPU on the
    adapter's artifacts: the same first-minimum pose on every frame.
    Returns the NFA launches of the adapter's map prep."""
    import torch
    from lsdtpu_torch.ops import nfa as onfa
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    from lsdtpu_torch.runtime.ros_node import LsdRosAdapter
    import types
    ds = scene.dataset
    p = ds.param
    scans = ros_scans(ds)
    F = len(scans)
    meta, grid = ros_map_messages(ds)
    ad = LsdRosAdapter(cfg, mode="legacy", device=device)
    if ad.on_map(grid) is not None:
        fail("online_legacy: /map before /map_metadata was not dropped")
    ad.on_map_metadata(meta)
    onfa.rect_counts.launches = sc.score_partials.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_lines, calls = record_rect_counts(lambda: ad.on_map(grid))
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    nfa_launches, n_calls = onfa.rect_counts.launches, len(calls)
    del calls
    if nfa_launches != n_calls or nfa_launches == 0:
        fail(f"online_legacy: {nfa_launches} NFA launches for {n_calls} "
             "count calls")
    got, lat = stream(
        lambda r, _odom: ad.on_scan(types.SimpleNamespace(
            ranges=r, angle_min=0.0, angle_increment=SCAN_INC)),
        scans, ds, range(F))
    if sc.score_partials.launches != 0:
        fail("online_legacy: the legacy matcher launched CalcScore")
    fin = np.isfinite(got["score"])
    if not fin.any():
        fail("online_legacy: no frame has a finite score")
    phase("online_legacy", device=repr(kind), card=repr(smi),
          map_lines=n_lines, map_prep_ms=prep_ms,
          nfa_launches=nfa_launches, nfa_count_calls=n_calls,
          cache_cap=float(ad.loc.ctx.cache.max()), scans=F,
          finite_frames=int(fin.sum()),
          overflow_frames=int(got["candidate_overflow"].sum()),
          mean_candidates=float(got["n_candidates"].mean()),
          rmse_m=rmse_m(got["pose"], scene, fin),
          **latency_stats(lat), first_scan_ms=lat[0])
    # f64 card vs CPU on the adapter's artifacts
    lines = ad.loc.ctx.lines[:n_lines].cpu()
    cache = ad.loc.ctx.cache.cpu()
    runs, secs = [], []
    for dev in (device, torch.device("cpu")):
        loc = OnlineLocalizer(cfg, mode="legacy", dtype=np.float64,
                              device=dev)
        loc.set_map_artifacts(lines, cache, p.resol, p.ori_x, p.ori_y)
        t0 = time.perf_counter()
        runs.append(stream(
            lambda r, _odom: loc.push_laser_scan(r, 0.0, SCAN_INC),
            scans, ds, range(F))[0])
        secs.append(round(time.perf_counter() - t0, 2))
    a, b = runs
    # the same candidate: the same floored pixel, its heading within
    # 1e-12 rad (the card's atan is not the CPU's to the ulp)
    differ = [f for f in range(F)
              if not (np.array_equal(a["pose"][f, :2], b["pose"][f, :2])
                      and abs(a["pose"][f, 2] - b["pose"][f, 2]) <= 1e-12)]
    for f in differ[:5]:
        phase("online_legacy_f64_difference", frame=f,
              card_pose=a["pose"][f].tolist(), cpu_pose=b["pose"][f].tolist())
    if differ:
        fail(f"online_legacy: f64 first-minimum poses differ card vs CPU on "
             f"{len(differ)} of {F} frames (first {differ[0]})")
    fin = np.isfinite(a["score"])
    rel = float(np.max(np.abs(a["score"][fin] - b["score"][fin])
                       / np.abs(b["score"][fin]))) if fin.any() else 0.0
    phase("online_legacy_f64_parity", card=repr(smi), frames=F,
          first_min_pose="identical", finite_frames=int(fin.sum()),
          max_heading_diff_rad=float(np.abs(a["pose"][:, 2]
                                            - b["pose"][:, 2]).max()),
          n_candidates_equal=bool(np.array_equal(a["n_candidates"],
                                                 b["n_candidates"])),
          max_score_rel_diff=rel, card_s=secs[0], cpu_s=secs[1])
    return nfa_launches


# --- batched rollouts and the serving pool (slice 6) ---------------------

BATCH_LANES = 8        # batch_kernel_check: one relocking, seven tracking
TRACKING_LANES = 16    # batch_kernel_check: sixteen tracking lanes
CROP = (700, 1100)     # the smaller map of batch_kernel_check's last lane
BATCH_SIZES = (1, 4, 16, 64)   # batch_f32: lanes
BATCH_FRAMES = 100     # batch_f32: frames a lane
BATCH_REPEATS = 3      # batch_f32: timed runs at each B (median reported)
BATCH_F64_LANES = 4    # batch_f32: f64 lanes against their solo rollouts
PROFILE_LANES = 16     # batch_f32: the profiled batch (10 frames)
POOL_CAPACITY = 16     # serving_f32
POOL_WAVES = (1, 4, 16)        # serving_f32: active sessions
POOL_TICKS = 25        # serving_f32: timed ticks at each active count
POOL_F64_TICKS = 20    # serving_f32: f64 pool vs OnlineLocalizer


def lane_frame_args(scene, ctx, cfg, device, f, pruned):
    """One frame's single-lane CalcScore arguments (feats, idx, n, px, py,
    n_pix) as the main path builds them: frame 0 relocks (no prior pose,
    the full sweep), a later frame tracks from the true pose."""
    import torch
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    dt = ctx.lines.dtype
    m = cfg.match
    fr = loop.stack_frames(scene.dataset, dtype=loop.numpy_dtype(dt),
                           max_frames=f + 1)
    inp = tuple(torch.as_tensor(fr[k][f], device=device)
                for k in loop._FRAME_KEYS)
    fs = loop.featurize_stage(inp, ctx, cfg)
    truth = synth.true_pose_px(scene)
    last = (loop.init_state(dt, device).last_pose if f == 0 else
            torch.tensor([truth[f][0], truth[f][1], 0.0], dtype=dt,
                         device=device))
    cand = assoc.generate_candidates(
        fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
        loop.geo.c_round(fs.lidar_pos), last, cfg.shapes.max_candidates,
        m.ignore_scan_length, m.scan_to_map_diff, m.max_esti_dist)
    K = cand.ca.shape[0]
    px, py, n_pix = assoc.pixel_args(fs.pixels, fs.pixels_mask, dt)
    if pruned:
        idx, n = assoc.prune_survivors(
            cand, fs.pixels, fs.pixels_mask, loop.prepare_coarse(ctx, cfg),
            ctx.rows, ctx.cols, cfg.map.z_occ_max_dis, m.max_dist_penalty,
            m.valid_ratio, m.obstacle_tolerance, m.score_accept,
            m.prune_block, m.prune_group)
    else:
        idx, n = None, cand.count.clamp(0, K).to(torch.int32)
    return cand.feats(), idx, n.reshape(1), px, py, n_pix.reshape(1)


def profiled_sum_ms(fn, reps, kernel, tries=3):
    """Device ms of ``kernel`` per call of fn (every launch of it that fn
    makes), from the profiler over ``reps`` calls; None when every try
    missed the kernel."""
    for _ in range(tries):
        _w, acts = device_profile(lambda: [fn() for _ in range(reps)])
        hits = [v for k, v in acts.items() if kernel in k]
        if hits:
            return sum(h[1] for h in hits) / reps / 1e3
    return None


def batch_kernel_case(name, scene, lines, cache64, cfg, device, card,
                      floor_ms, dtype, frames, pruned):
    """The lane-batched CalcScore launch on the recorded frames of the
    scene, one lane each (the last lane on a CROP of the map, padded to
    the canvas with the cap): against its plain version on the card, each
    lane bit for bit against a single-lane launch on its inputs, 50
    repeats bitwise, device ms against the sum of the single launches on
    the same inputs, the summed bound of the lanes and the floor."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import batch, loop
    p = scene.dataset.param
    crop = cache64[:CROP[0], :CROP[1]]
    fields = [cache64] * (len(frames) - 1) + [crop]
    ctx, ctx_crop = (loop.make_map_context(lines, f, p.resol, p.ori_x,
                                           p.ori_y, dtype=dtype, device=device)
                     for f in (cache64, crop))
    lanes = [lane_frame_args(scene, ctx_crop if b == len(frames) - 1 else ctx,
                             cfg, device, f, pruned)
             for b, f in enumerate(frames)]
    canvas = batch.batch_context(
        [(lines, fl) for fl in fields], [(p.resol, p.ori_x, p.ori_y)]
        * len(fields), cfg, dtype=dtype, device=device)
    z, pen = cfg.map.z_occ_max_dis, cfg.match.max_dist_penalty
    stack = [None if lanes[0][i] is None else
             torch.stack([ln[i] for ln in lanes]) for i in range(6)]
    stack[2], stack[5] = stack[2][:, 0], stack[5][:, 0]    # (B,) counts
    stack = [None if t is None else t.contiguous() for t in stack]
    bargs = (*stack, canvas.cache, canvas.rows, canvas.cols, z, pen, z)
    singles = [(*ln, canvas.cache[b], 0, int(canvas.rows[b]),
                int(canvas.cols[b]), z, pen, z) for b, ln in enumerate(lanes)]
    before = sc.score_partials_batched.launches
    got = sc.score_partials_batched(*bargs)
    torch.cuda.synchronize()
    want = sc.score_partials_batched_reference(*bargs)
    for i in (1, 3):
        if not torch.equal(got[i], want[i]):
            fail(f"{name}: batched kernel counts differ from the plain "
                 "version")
    err = 0.0
    for i in (0, 2):
        g, w = got[i].double(), want[i].double()
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            fail(f"{name}: batched kernel sums differ from the plain "
                 f"version (max abs err {err})")
    for b, a in enumerate(singles):
        one = sc.score_partials(*a)
        if not all(torch.equal(g[b], o) for g, o in zip(got, one)):
            fail(f"{name}: lane {b} differs from its single-lane launch")
    work = [lane_work(ln[0], ln[1], ln[2], ln[3], ln[4], ln[5],
                      canvas.cache[b], 0, 0, int(canvas.rows[b]),
                      int(canvas.cols[b])) for b, ln in enumerate(lanes)]
    bound_ms, bound_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work), stack[0].dtype)
    out = dict(name=name, lanes=len(lanes), dtype=str(stack[0].dtype)
               .split(".")[1], pruned=pruned,
               live=[int(ln[2]) for ln in lanes],
               live_pixels=[int(ln[5]) for ln in lanes],
               crop=f"{CROP[0]}x{CROP[1]}", max_abs_err=err,
               pairs=sum(w[1] for w in work), bound_ms=bound_ms,
               bound_by=bound_by,
               check_launches=sc.score_partials_batched.launches - before)
    dev_ms = profiled_ms(name, lambda: sc.score_partials_batched(*bargs),
                         got, "score_partials_kernel")
    out["repeats_bitwise"] = 50
    out["ms"] = dev_ms if dev_ms is not None else time_cuda(
        lambda: sc.score_partials_batched(*bargs), 200)
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["single_sum_ms"] = profiled_sum_ms(
        lambda: [sc.score_partials(*a) for a in singles], 20,
        "score_partials_kernel")
    out["plain_ms"] = time_cuda(
        lambda: sc.score_partials_batched_reference(*bargs), 3)
    out["floor_ms"] = floor_ms
    phase("batch_kernel_check", **out, card=card)
    return out


def lane_dataset(ds, offset, frames):
    """The frames [offset, offset + frames) of a sequence as a dataset."""
    return dataclasses.replace(ds, frames=ds.frames[offset:offset + frames],
                               odom=ds.odom[offset:offset + frames + 1])


def batch_rollouts(maps, cfg, device, smi, kind):
    """batch_f32: run_batch over BATCH_SIZES lanes of BATCH_FRAMES frames,
    the lanes alternating between the two maps, each from its own frame
    offset, BATCH_REPEATS timed runs at each B; then BATCH_F64_LANES lanes
    in f64 against their solo run_sequence on the card.  maps: [(scene,
    lines, field)].  Returns the batched CalcScore launches of the timed
    f32 runs."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import batch, loop
    from lsdtpu_torch.scan import featurize as fz
    F = BATCH_FRAMES
    span = len(maps[0][0].dataset.frames) - F

    def lanes(B, dtype):
        sel = [maps[b % 2] for b in range(B)]
        dss = [lane_dataset(m[0].dataset, (37 * b) % span, F)
               for b, m in enumerate(sel)]
        fr, ctxs, lens = batch.stack_batch(
            dss, [(m[1], m[2]) for m in sel], cfg, dtype=dtype,
            device=device)
        return dss, {k: torch.as_tensor(v, device=device)
                     for k, v in fr.items()}, ctxs

    total = 0
    for B in BATCH_SIZES:
        _d, fr, ctxs = lanes(B, np.float32)
        batch.run_batch({k: v[:, :3] for k, v in fr.items()}, ctxs, cfg,
                        device=device)                          # warm-up
        sc.score_partials_batched.launches = sc.score_partials.launches = 0
        fz._rdp_rounds.rounds = 0
        times = []
        for _ in range(BATCH_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = batch.run_batch(fr, ctxs, cfg, device=device)
            res = {k: v.cpu().numpy() for k, v in out.items()}  # to value
            times.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(times))
        launches = sc.score_partials_batched.launches
        if launches != F * BATCH_REPEATS or sc.score_partials.launches != 0:
            fail(f"batch_f32 B={B}: {launches} batched and "
                 f"{sc.score_partials.launches} single CalcScore launches "
                 f"for {BATCH_REPEATS} runs of {F} frames")
        if res["pose"].shape != (B, F, 3):
            fail(f"batch_f32 B={B}: pose shape {res['pose'].shape}")
        tracked = np.isfinite(res["score"]) & ~np.isnan(res["pose"]).any(-1)
        if not tracked.any(axis=1).all():
            fail(f"batch_f32 B={B}: a lane tracked no frame")
        total += launches
        phase("batch_f32", device=repr(kind), power=repr(smi), lanes=B,
              frames=F, median_ms=wall, min_ms=min(times),
              max_ms=max(times), scans_per_s=B * F / wall * 1e3,
              ms_per_frame=wall / F, score_launches=launches,
              launches_per_frame=launches / (F * BATCH_REPEATS),
              rdp_rounds_per_frame=fz._rdp_rounds.rounds
              / (F * BATCH_REPEATS),
              tracked=int(tracked.sum()), of=B * F)
        if B == PROFILE_LANES:
            sub = {k: v[:, :10] for k, v in fr.items()}
            pwall, acts = device_profile(
                lambda: batch.run_batch(sub, ctxs, cfg, device=device))
            busy = sum(v[1] for v in acts.values()) / 1e3
            phase("batch_f32_profile", card=repr(smi), lanes=B, frames=10,
                  wall_ms=pwall, device_busy_ms=busy,
                  device_idle_share=1.0 - busy / pwall,
                  device_ops_per_frame=sum(v[0] for v in acts.values()) / 10,
                  score_kernel_ms=sum(v[1] for k, v in acts.items()
                                      if "score_partials_kernel" in k) / 1e3)
        del fr, ctxs, out
    # f64: each lane against its solo rollout on the card
    dss, fr, ctxs = lanes(BATCH_F64_LANES, np.float64)
    got = {k: v.cpu().numpy() for k, v in
           batch.run_batch(fr, ctxs, cfg, device=device).items()}
    worst = 0.0
    for b, ds in enumerate(dss):
        m = maps[b % 2]
        p = ds.param
        c1 = loop.make_map_context(m[1], m[2], p.resol, p.ori_x, p.ori_y,
                                   dtype=np.float64, device=device)
        solo = {k: v.cpu().numpy() for k, v in loop.run_sequence(
            loop.stack_frames(ds, dtype=np.float64), c1, cfg,
            device=device).items()}
        if not (np.array_equal(got["n_candidates"][b], solo["n_candidates"])
                and np.array_equal(np.isfinite(got["score"][b]),
                                   np.isfinite(solo["score"]))):
            fail(f"batch_f64: lane {b} decides otherwise than its solo "
                 "rollout")
        ok = ~np.isnan(solo["pose"]).any(-1)
        worst = max(worst, float(np.abs(got["pose"][b][ok]
                                        - solo["pose"][ok]).max()))
    if not worst <= 1e-6:
        fail(f"batch_f64: lane poses {worst} px from the solo rollouts")
    phase("batch_f64_parity", card=repr(smi), lanes=BATCH_F64_LANES,
          frames=F, decisions="identical", max_pose_diff_px=worst)
    return total


def serving(maps, cfg, device, smi, kind):
    """serving_f32: a SessionPool(POOL_CAPACITY) on the two maps, robots
    joining in waves of POOL_WAVES active sessions, each wave timed over
    POOL_TICKS ticks (per-tick latency to the numpy dicts), then one
    robot leaves and another takes its slot; then an f64 pool against
    per-robot OnlineLocalizer sessions on the card.  Returns the batched
    CalcScore launches of the timed ticks."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    from lsdtpu_torch.runtime.serving import SessionPool
    scene = maps[0][0]
    H, W = scene.dataset.map_value.shape
    n_ticks = len(POOL_WAVES) * POOL_TICKS + 5
    span = len(scene.dataset.frames) - n_ticks

    def robot(r):
        m = maps[r % 2]
        p = m[0].dataset.param
        return m[0].dataset, (23 * r) % span, (m[1], m[2], p.resol, p.ori_x,
                                               p.ori_y)

    def submit(pool, sid, ds, f):
        fr = ds.frames[f]
        pool.submit_scan(sid, fr[:, 0], fr[:, 1], ds.odom[f + 1])

    pool = SessionPool(POOL_CAPACITY, (H, W), cfg, dtype=np.float32,
                       device=device)
    robots = {}           # sid -> [dataset, next frame]
    total = 0
    for active in POOL_WAVES:
        while len(robots) < active:
            ds, off, args = robot(len(robots))
            sid = f"r{len(robots)}"
            pool.open_session(sid, *args)
            robots[sid] = [ds, off]
        sc.score_partials_batched.launches = sc.score_partials.launches = 0
        lat = []
        for _ in range(POOL_TICKS):
            for sid, (ds, f) in robots.items():
                submit(pool, sid, ds, f)
                robots[sid][1] += 1
            t0 = time.perf_counter()
            res = pool.step()
            lat.append((time.perf_counter() - t0) * 1e3)
            if set(res) != set(robots):
                fail(f"serving_f32: results for {sorted(res)}, expected "
                     f"{sorted(robots)}")
        launches = sc.score_partials_batched.launches
        if launches != POOL_TICKS or sc.score_partials.launches != 0:
            fail(f"serving_f32: {launches} batched and "
                 f"{sc.score_partials.launches} single CalcScore launches in "
                 f"{POOL_TICKS} ticks")
        total += launches
        st = latency_stats(lat)
        st["scans_per_s"] = active * POOL_TICKS / float(np.sum(lat)) * 1e3
        phase("serving_f32", device=repr(kind), power=repr(smi),
              capacity=POOL_CAPACITY, active=active, ticks=POOL_TICKS,
              score_launches=launches, **st)
    # one robot leaves, another takes its slot and starts from the reset
    slot = pool._sessions["r3"]
    pool.close_session("r3")
    del robots["r3"]
    ds, off, args = robot(POOL_CAPACITY)
    pool.open_session("late", *args)
    robots["late"] = [ds, off]
    if pool._sessions["late"] != slot or pool.n_active != POOL_CAPACITY:
        fail("serving_f32: the joining robot did not take the free slot")
    for _ in range(5):
        for sid, (ds, f) in robots.items():
            submit(pool, sid, ds, f)
            robots[sid][1] += 1
        res = pool.step()
    if not np.isfinite(res["late"]["score"]):
        fail("serving_f32: the joining robot does not track")
    phase("serving_f32_join", slot=slot, active=pool.n_active,
          late_score=float(res["late"]["score"]))
    # f64: the pool against per-robot OnlineLocalizer sessions
    pool = SessionPool(4, (H, W), cfg, dtype=np.float64, device=device)
    locs = {}
    for r in range(2):
        ds, off, args = robot(r)
        pool.open_session(f"r{r}", *args)
        locs[f"r{r}"] = [OnlineLocalizer(cfg, dtype=np.float64,
                                         device=device), ds, off]
        locs[f"r{r}"][0].set_map_artifacts(*args)
    worst = 0.0
    for t in range(POOL_F64_TICKS):
        want = {}
        for sid, (loc, ds, off) in locs.items():
            submit(pool, sid, ds, off + t)
            fr = ds.frames[off + t]
            want[sid] = loc.push_scan(fr[:, 0], fr[:, 1], ds.odom[off + t + 1])
        got = pool.step()
        for sid in locs:
            if got[sid]["n_candidates"] != want[sid]["n_candidates"] or \
                    np.isfinite(got[sid]["score"]) != \
                    np.isfinite(want[sid]["score"]):
                fail(f"serving_f64: {sid} decides otherwise than its "
                     f"OnlineLocalizer at tick {t}")
            if not np.isnan(want[sid]["pose"]).any():
                worst = max(worst, float(np.abs(got[sid]["pose"]
                                                - want[sid]["pose"]).max()))
    torch.cuda.synchronize()
    if not worst <= 1e-6:
        fail(f"serving_f64: pool poses {worst} px from OnlineLocalizer")
    phase("serving_f64_parity", card=repr(smi), sessions=len(locs),
          ticks=POOL_F64_TICKS, decisions="identical",
          max_pose_diff_px=worst,
          tier="1e-9 px" if worst <= 1e-9 else "1e-6 px (beyond 1e-9)")
    return total


CLI_FRAMES_LEGACY = 60   # cli_run_legacy: frames of `run --mode legacy`
CLI_FRAMES_PROFILE = 20  # cli_profile: frames a profiled rollout
CLI_FRAMES_VIZ = 20      # cli_viz: frames of `run --viz`
CLI_KEYFRAME_EVERY = 10  # realPos.txt holds every 10th frame's true pose
REFINE_TOL = 1e-9        # refined poses, card vs CPU (px, deg; f64)
SEGMENTS_TOL = 1e-6      # refined poses, 8 segments vs 1 (px, deg)


def _wrappers():
    from lsdtpu_torch.ops import grow, nfa, score
    return {"score_partials": score.score_partials,
            "score_partials_batched": score.score_partials_batched,
            "rect_counts": nfa.rect_counts, "grow_fifo": grow.grow_fifo,
            "radius_reducer_fifo": grow.radius_reducer_fifo}


def write_dataset(root, scene):
    """The scene as a dataset directory in the reference's text formats
    (doubles as %.17g, exact): mapParam, mapValue, Odom (its F + 1 rows),
    Lidar (360 rows a frame, inf where a ray hit nothing), realPos (the
    true position of every CLI_KEYFRAME_EVERY-th frame) and recored_Odom
    (their 1-based indices)."""
    ds = scene.dataset
    p = ds.param
    with open(os.path.join(root, "mapParam.txt"), "w") as f:
        f.write(f"{p.col} {p.row} {p.resol!r} {p.ori_x!r} {p.ori_y!r}\n")
    np.savetxt(os.path.join(root, "mapValue.txt"), ds.map_value, fmt="%d")
    np.savetxt(os.path.join(root, "Odom.txt"), ds.odom, fmt="%.17g")
    rows = []
    for fr in ds.frames:
        full = np.full((360, 2), np.inf)
        full[:len(fr)] = fr
        full[len(fr):, 1] = 0.0
        rows.append(full)
    np.savetxt(os.path.join(root, "Lidar.txt"), np.concatenate(rows),
               fmt="%.17g")
    keys = np.arange(CLI_KEYFRAME_EVERY, len(ds.frames) + 1,
                     CLI_KEYFRAME_EVERY)
    np.savetxt(os.path.join(root, "realPos.txt"), scene.true_pos[keys - 1],
               fmt="%.17g", delimiter="\t")
    np.savetxt(os.path.join(root, "recored_Odom.txt"), keys, fmt="%d")
    return keys


def check_loaded(got, scene, keys):
    """Fail unless the dataset read back equals the scene (the loader's
    odometry quirks applied: Odom[0].x = 0 and the last row repeated)."""
    ds = scene.dataset
    odom = ds.odom.copy()
    odom[0, 0] = 0.0
    odom = np.concatenate([odom, odom[-1:]])
    bad = [name for name, ok in (
        ("param", got.param == ds.param),
        ("map_value", np.array_equal(got.map_value, ds.map_value)),
        ("odom", np.array_equal(got.odom, odom)),
        ("frames", len(got.frames) == len(ds.frames) and all(
            np.array_equal(a, b) for a, b in zip(got.frames, ds.frames))),
        ("real_pos", np.array_equal(got.real_pos,
                                    scene.true_pos[keys - 1])),
        ("recorded_odom", np.array_equal(got.recorded_odom, keys)))
        if not ok]
    if bad:
        fail(f"cli_dataset: the dataset read back differs in {bad}")


def cli_call(tag, argv):
    """lsdtpu_torch.cli.main(argv) in this process, its output captured,
    with every kernel's launch count set to 0 just before and read just
    after.  Fails unless it exits 0.  Returns (stdout JSON records,
    stderr lines, launches, seconds)."""
    import torch
    from lsdtpu_torch import cli
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if rc != 0:
        fail(f"{tag}: `lsdtpu-torch {' '.join(argv)}` exited {rc}: "
             f"{err.getvalue()[-2000:]}")
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    return recs, err.getvalue().splitlines(), launches, seconds


def need_launches(tag, launches, names):
    """Fail unless each named kernel launched at least once."""
    idle = [n for n in names if launches[n] == 0]
    if idle:
        fail(f"{tag}: {idle} launched no time ({launches})")


def run_records(outs):
    """The `run` records the CLI prints for these outputs (numpy)."""
    import math
    recs = []
    for f in range(len(outs["score"])):
        sc = float(outs["score"][f])
        rec = {"frame": f + 1,
               "pose": [round(float(v), 3) for v in outs["pose"][f]],
               "score": round(sc, 4) if math.isfinite(sc) else None,
               "n_candidates": int(outs["n_candidates"][f])}
        if outs["coasting"][f]:
            rec["coasting"] = True
        if outs["relock_deferred"][f]:
            rec["relock_deferred"] = True
        recs.append(rec)
    return recs


def wrap_diff(a, b):
    """Largest |a - b| over poses (x, y px; heading deg, wrapped)."""
    d = np.abs(a - b)
    d[:, 2] = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
    return float(d.max())


def timed_solve(fn, device, reps=3):
    """(result, median ms) of fn() to value on ``device``."""
    import torch
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        out = res[0].cpu().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def cli_phases(scene, device, smi, kind):
    """The port's command-line interface on the card, in this process
    (lsdtpu_torch.cli.main), over the scene written to a dataset
    directory; returns {path: {kernel: launches}}."""
    import torch
    from lsdtpu_torch import cli
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.io import loaders, native, refdump
    from lsdtpu_torch.refine import pose_graph
    from lsdtpu_torch.render import render_line_image
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.artifacts import prepare_map_cached
    from lsdtpu_torch.runtime.online import to_host

    tmp = tempfile.mkdtemp(prefix="lsdtpu_torch_cli_")
    try:
        data = os.path.join(tmp, "data")
        cache_dir = os.path.join(tmp, "cache")
        os.makedirs(data)
        common = ["--data", data, "--cache-dir", cache_dir, "--device",
                  device.type]
        F = len(scene.dataset.frames)
        by_path = {}

        # --- the dataset directory, read back through the native parser
        t0 = time.perf_counter()
        keys = write_dataset(data, scene)
        t_write = time.perf_counter() - t0
        if not native.available():
            fail(f"cli_dataset: the native parser did not build: "
                 f"{native.build_error()}")
        native.load_grid_native.calls = native.load_doubles_native.calls = 0
        t0 = time.perf_counter()
        ds = loaders.load_dataset(data)
        t_load = time.perf_counter() - t0
        parsed = (native.load_grid_native.calls,
                  native.load_doubles_native.calls)
        if parsed != (1, 3):
            fail(f"cli_dataset: {parsed} (grid, float) files parsed "
                 "natively, expected (1, 3)")
        check_loaded(ds, scene, keys)
        phase("cli_dataset", card=repr(smi), frames=F, keyframes=len(keys),
              write_s=round(t_write, 2), load_s=round(t_load, 3),
              native_parser=True, native_files=repr(parsed),
              equal_to_scene=True)

        # --- prepare-map, cold, with the reference-format dump
        dump = os.path.join(tmp, "dump")
        recs, _err, launches, secs = cli_call(
            "cli_prepare_map", ["prepare-map", *common, "--dump", dump])
        by_path["cli_prepare_map"] = launches
        need_launches("cli_prepare_map", launches,
                      ("rect_counts", "grow_fifo"))
        lines, cache = prepare_map_cached(
            ds.map_value, ds.param.resol, DEFAULT.map.z_occ_max_dis,
            cache_dir=cache_dir, device=device, growth=DEFAULT.lsd.growth)
        l_np, c_np = lines.cpu().numpy(), cache.cpu().numpy()
        H, W = ds.map_value.shape
        img = render_line_image(lines, torch.ones(len(lines), dtype=torch.bool,
                                                  device=device), H, W)
        shifted = np.zeros((H, W), np.int64)
        shifted[:-1, :-1] = img.cpu().numpy()[1:, 1:] > 0
        same = (np.array_equal(loaders.load_lines_info(os.path.join(
                    dump, "MaplinesInfo.txt")).astype(l_np.dtype), l_np),
                np.array_equal(refdump.load_map_cache(os.path.join(
                    dump, "mapCache.txt")).astype(c_np.dtype), c_np),
                np.array_equal(np.loadtxt(os.path.join(
                    dump, "MaplineIm.txt"), dtype=np.int64), shifted))
        if not all(same) or recs[0]["lines"] != len(l_np):
            fail(f"cli_prepare_map: the dump does not reload to the "
                 f"artifacts (lines, cache, lineIm equal: {same})")
        phase("cli_prepare_map", device=repr(kind), power=repr(smi),
              cold_s=secs, record_seconds=recs[0]["seconds"],
              lines=recs[0]["lines"], cache_shape=repr(recs[0]["cache_shape"]),
              dump_reloads_equal=True, launches=repr(launches))

        # --- run: all frames, against the library rollout
        recs, err, launches, secs = cli_call("cli_run", ["run", *common])
        by_path["cli_run"] = launches
        summary = json.loads(err[-1])
        if launches["score_partials"] != F or len(recs) != F:
            fail(f"cli_run: {len(recs)} records, launches {launches}")
        ctx = loop.make_map_context(lines, cache, ds.param.resol,
                                    ds.param.ori_x, ds.param.ori_y,
                                    dtype=np.float32, device=device)
        fr = loop.stack_frames(ds, dtype=np.float32)
        t0 = time.perf_counter()
        outs = to_host(loop.run_sequence(fr, ctx, DEFAULT, device=device))
        lib_ms = (time.perf_counter() - t0) * 1e3
        want = run_records(outs)
        diff = next((i for i, (a, b) in enumerate(zip(recs, want))
                     if a != b), None)
        if diff is not None:
            fail(f"cli_run: record {diff} {recs[diff]} differs from the "
                 f"library rollout's {want[diff]}")
        if summary["tracked"] != F or "ate_rmse_m" not in summary:
            fail(f"cli_run: summary {summary}")
        phase("cli_run", device=repr(kind), power=repr(smi), frames=F,
              tracked=summary["tracked"], ate_rmse_m=summary["ate_rmse_m"],
              ate_keyframes=summary["ate_keyframes"],
              candidate_overflow_frames=int(outs["candidate_overflow"].sum()),
              cli_wall_s=summary["wall_s"],
              cli_scans_per_s=summary["scans_per_sec"],
              library_ms=lib_ms, library_scans_per_s=F / lib_ms * 1e3,
              records_equal_library=True, command_s=secs,
              launches=repr(launches))

        # --- run --mode legacy
        recs, err, launches, secs = cli_call(
            "cli_run_legacy", ["run", *common, "--mode", "legacy",
                               "--frames", str(CLI_FRAMES_LEGACY)])
        by_path["cli_run_legacy"] = launches
        need_launches("cli_run_legacy", launches, ("rect_counts",))
        summary = json.loads(err[-1])
        if len(recs) != CLI_FRAMES_LEGACY or not all(
                np.isfinite(r["pose"]).all() for r in recs):
            fail(f"cli_run_legacy: {len(recs)} records or non-finite poses")
        phase("cli_run_legacy", device=repr(kind), power=repr(smi),
              frames=summary["frames"], tracked=summary["tracked"],
              command_s=secs, launches=repr(launches))

        # --- refine, 1 and 8 segments; the solve card vs CPU in f64
        rec = {}
        for seg in (1, 8):
            recs, _err, launches, secs = cli_call(
                f"cli_refine_{seg}", ["refine", *common, "--segments",
                                      str(seg)])
            by_path[f"cli_refine_{seg}"] = launches
            if launches["score_partials"] != F:
                fail(f"cli_refine_{seg}: launches {launches}")
            rec[seg] = recs[0]
        args = cli.refine_inputs(outs, 1)
        ref_gpu, gpu_ms = timed_solve(lambda: pose_graph.refine_trajectory(
            *args, device=device), device)
        ref_cpu, cpu_ms = timed_solve(lambda: pose_graph.refine_trajectory(
            *args, device="cpu"), torch.device("cpu"))
        args8 = cli.refine_inputs(outs, 8)
        ref8, gpu8_ms = timed_solve(
            lambda: pose_graph.refine_trajectory_distributed(
                *args8, n_segments=8, device=device), device)
        d_dev = wrap_diff(ref_gpu, ref_cpu)
        d_seg = wrap_diff(ref8[:F], ref_gpu)
        if not d_dev <= REFINE_TOL:
            fail(f"cli_refine: card vs CPU refined poses differ by {d_dev}")
        if not d_seg <= SEGMENTS_TOL:
            fail(f"cli_refine: 8 segments vs 1 differ by {d_seg}")
        from lsdtpu_torch.eval.ate import keyframe_ate
        ate = round(keyframe_ate(ref_gpu, ds.real_pos, ds.recorded_odom,
                                 ds.param.resol, ds.param.ori_x,
                                 ds.param.ori_y).rmse, 4)
        if rec[1]["ate_refined_rmse_m"] != ate:
            fail(f"cli_refine: record {rec[1]} against the library's "
                 f"refined ATE {ate}")
        phase("cli_refine", device=repr(kind), power=repr(smi), frames=F,
              n_measured=rec[1]["n_measured"],
              ate_online_rmse_m=rec[1]["ate_online_rmse_m"],
              ate_refined_rmse_m=rec[1]["ate_refined_rmse_m"],
              ate_refined_rmse_m_8_segments=rec[8]["ate_refined_rmse_m"],
              solve_card_ms=gpu_ms, solve_cpu_ms=cpu_ms,
              solve_card_8_segments_ms=gpu8_ms,
              card_vs_cpu_max_diff=d_dev, segments_8_vs_1_max_diff=d_seg)

        # --- profile: per-stage split of a frame, a trace of the card
        trace = os.path.join(tmp, "trace")
        recs, _err, launches, secs = cli_call(
            "cli_profile", ["profile", *common, "--frames",
                            str(CLI_FRAMES_PROFILE), "--repeats", "2",
                            "--trace", trace])
        by_path["cli_profile"] = launches
        need_launches("cli_profile", launches, ("score_partials",))
        stages, steady = recs
        path = os.path.join(trace, "trace.json")
        with open(path) as fh:
            has_kernel = "score_partials_kernel" in fh.read()
        if not has_kernel:
            fail("cli_profile: the trace holds no score_partials_kernel")
        phase("cli_profile", device=repr(kind), power=repr(smi),
              frame=stages["frame"],
              per_stage_ms=json.dumps(stages["per_stage_ms"]),
              steady_ms=steady["steady_ms"],
              scans_per_sec=steady["scans_per_sec"],
              frames=steady["frames"], trace_mb=round(
                  os.path.getsize(path) / 2**20, 1),
              trace_has_score_partials_kernel=True, command_s=secs,
              launches=repr(launches))

        # --- batch: two lanes; then --concat, one stream
        for tag, extra in (("cli_batch", []), ("cli_batch_concat",
                                                ["--concat"])):
            recs, err, launches, secs = cli_call(
                tag, ["batch", "--data", data, data, *common[2:], *extra])
            by_path[tag] = launches
            need_launches(tag, launches, ("score_partials" if extra else
                                          "score_partials_batched",))
            summary = json.loads(err[-1])
            if [r["tracked"] for r in recs] != [F, F]:
                fail(f"{tag}: records {recs}")
            phase(tag, device=repr(kind), power=repr(smi),
                  total_scans=summary["total_scans"],
                  scans_per_sec=summary["scans_per_sec"],
                  tracked=repr([r["tracked"] for r in recs]),
                  command_s=secs, launches=repr(launches))

        # --- serve: two robots through the pool
        recs, err, launches, secs = cli_call(
            "cli_serve", ["serve", "--data", data, data, *common[2:]])
        by_path["cli_serve"] = launches
        if launches["score_partials_batched"] != F:
            fail(f"cli_serve: launches {launches}")
        summary = json.loads(err[-1])
        if [r["tracked"] for r in recs] != [F, F]:
            fail(f"cli_serve: records {recs}")
        phase("cli_serve", device=repr(kind), power=repr(smi),
              robots=summary["robots"], ticks=summary["ticks"],
              scans_per_sec=summary["scans_per_sec"],
              ate_rmse_m=repr([r.get("ate_rmse_m") for r in recs]),
              command_s=secs, launches=repr(launches))

        # --- run --viz: the images open
        from PIL import Image
        viz = os.path.join(tmp, "viz")
        _recs, err, launches, secs = cli_call(
            "cli_viz", ["run", *common, "--frames", str(CLI_FRAMES_VIZ),
                        "--viz", viz])
        by_path["cli_viz"] = launches
        paths = json.loads(err[-1])["viz"]
        sizes = []
        for p in paths:
            with Image.open(p) as im:
                im.load()
                sizes.append(im.size)
        if len(paths) != 6 or sizes[2] != (W, H):
            fail(f"cli_viz: images {paths} of sizes {sizes}")
        phase("cli_viz", card=repr(smi), images=len(paths),
              trajectory_size=repr(sizes[2]), command_s=secs)

        # --- the module entry point, in a process of its own
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "lsdtpu_torch.cli",
                              "run", *common, "--frames", "5"],
                             capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        if res.returncode != 0 or len(res.stdout.splitlines()) != 5:
            fail(f"cli_module: exit {res.returncode}: {res.stderr[-2000:]}")
        phase("cli_module", card=repr(smi), exit_code=res.returncode,
              records=len(res.stdout.splitlines()),
              seconds=round(time.perf_counter() - t0, 2))
        return by_path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    import torch
    # --- 1. device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", flush=True)
        sys.exit(2)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    # the UKF's float32 matmuls run in full precision (ukf_step asserts)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", kind=repr(kind), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda)

    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.distance import create_map_cache
    from lsdtpu_torch.ops import build
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop

    # --- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load_libraries(["score", "nfa", "grow"])
    for name in ("score", "nfa", "grow"):
        log = build.BUILD_LOG.get(name, {})
        usage = re.findall(r"(Used \d+ registers[^\n]*|\d+ bytes spill "
                           r"stores[^\n]*)", log.get("ptxas", ""))
        phase("build", source=f"csrc/{name}.cu", card=repr(smi),
              seconds=round(time.perf_counter() - t0, 3),
              nvcc_seconds=round(log.get("seconds", 0.0), 3),
              ptxas=repr(" | ".join(usage) or "cached"))

    # --- 3. scene --------------------------------------------------------
    t0 = time.perf_counter()
    scene = make_scene()
    ds = scene.dataset
    F, resol = len(ds.frames), ds.param.resol
    H, W = ds.map_value.shape
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache64 = create_map_cache(ds.map_value, resol, DEFAULT.map.z_occ_max_dis,
                               dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    t_cache = time.perf_counter() - t0
    lines = synth.wall_lines(scene.walls)
    phase("scene", card=repr(smi), map=f"{H}x{W}", resol=resol, frames=F,
          walls=len(scene.walls), scans_mean_points=round(float(np.mean(
              [len(f) for f in ds.frames])), 1), build_s=round(t_scene, 2),
          map_cache_s=round(t_cache, 3),
          cache_at_cap=round(float((cache64 >= 1.0).float().mean()), 4))
    cfg = DEFAULT

    # --- 4. kernel check at the main path's shapes (f32) ------------------
    floor_ms = launch_floor_ms()
    phase("launch_floor", card=repr(smi), floor_ms=floor_ms,
          what="'profiler device time of a one-element x.add_(1.0)'")
    ctx32 = loop.make_map_context(lines, cache64, resol, ds.param.ori_x,
                                  ds.param.ori_y, dtype=np.float32,
                                  device=device)
    cases = score_frame_cases(scene, ctx32, cfg, device, repr(smi), floor_ms)
    # the compressed fields (the main path's relock and tracking launches)
    # and a 768-px window of the field (col0 != 0), beside the f32 cases
    code_cases = []
    for mode in ("u16", "u8", "bf16"):
        ctx_m = loop.make_map_context(lines, cache64, resol, ds.param.ori_x,
                                      ds.param.ori_y, dtype=np.float32,
                                      cache_dtype=mode, device=device)
        code_cases += score_frame_cases(scene, ctx_m, cfg, device, repr(smi),
                                        floor_ms, prefix=f"{mode}_",
                                        frames=("relock",), paths=("pruned",))
        code_cases += score_frame_cases(scene, ctx_m, cfg, device, repr(smi),
                                        floor_ms, prefix=f"{mode}_",
                                        frames=("tracking",),
                                        paths=("unpruned",))
    for ctx_w, tag in ((ctx32, "f32"), (ctx_m, "bf16")):
        code_cases += score_frame_cases(scene, ctx_w, cfg, device, repr(smi),
                                        floor_ms, prefix=f"window768_{tag}_",
                                        frames=("tracking",),
                                        paths=("unpruned",), window=768)
    f32_ms = {c["name"]: c["ms"] for c in cases}
    phase("kernel_check_fields", card=repr(smi), **{
        c["name"]: round(c["ms"] * 1e3, 3) for c in code_cases},
        f32_relock_pruned_us=round(f32_ms["relock_pruned"] * 1e3, 3),
        f32_tracking_us=round(f32_ms["tracking_unpruned"] * 1e3, 3),
        units="'us device per launch'")
    phase("library", library_ms="null",
          reason="'no single PyTorch call computes CalcScore'")

    # --- 5. rollout --------------------------------------------------------
    # f64 on the card vs the CPU (plain scorer): identical decisions
    fr64 = loop.stack_frames(ds, dtype=np.float64)
    runs = {}
    for dev in (device, torch.device("cpu")):
        c64 = loop.make_map_context(lines, cache64.cpu(), resol,
                                    ds.param.ori_x, ds.param.ori_y,
                                    dtype=np.float64, device=dev)
        t0 = time.perf_counter()
        out = loop.run_sequence(fr64, c64, cfg, device=dev)
        runs[dev.type] = {k: v.cpu().numpy() for k, v in out.items()}
        phase("rollout_f64", device=dev.type, card=repr(smi),
              seconds=round(time.perf_counter() - t0, 2),
              tracked=int(np.isfinite(runs[dev.type]["score"]).sum()))
    a, b = runs["cuda"], runs["cpu"]
    if not np.array_equal(a["n_candidates"], b["n_candidates"]):
        fail("f64 card and CPU rollouts accept different candidates")
    if not np.array_equal(np.isfinite(a["score"]), np.isfinite(b["score"])):
        fail("f64 card and CPU rollouts track different frames")
    ok = ~np.isnan(a["pose"]).any(1) & ~np.isnan(b["pose"]).any(1)
    phase("rollout_f64_parity", n_candidates="identical",
          tracked_pattern="identical",
          max_pose_diff_px=float(np.abs(a["pose"][ok] - b["pose"][ok]).max()))

    # u16 field and a 768-px window that engages: f64 card vs CPU on the
    # first 60 frames with the scans clipped to 6 m (a short-range lidar:
    # the coverage bound then fits the window on tracking frames)
    from lsdtpu_torch.match import associate as assoc
    t_codes = time.perf_counter()
    frc = {k: v[:CODES_FRAMES] for k, v in fr64.items()}
    far = frc["ranges"] > 6.0
    frc["valid"] = frc["valid"] & ~far
    frc["ranges"] = np.where(far, 0.0, frc["ranges"])
    cfg_c = dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, cache_dtype="u16", score_window=768))
    window_origin = assoc.window_origin
    runs = {}
    try:
        for dev in (device, torch.device("cpu")):
            engaged = []

            def origin(*a, **k):
                r = window_origin(*a, **k)
                engaged.append(r[0])
                return r

            assoc.window_origin = origin
            c16 = loop.make_map_context(lines, cache64.cpu(), resol,
                                        ds.param.ori_x, ds.param.ori_y,
                                        dtype=np.float64, cache_dtype="u16",
                                        device=dev)
            out = loop.run_sequence(frc, c16, cfg_c, device=dev)
            runs[dev.type] = ({k: v.cpu().numpy() for k, v in out.items()},
                              sum(engaged))
    finally:
        assoc.window_origin = window_origin
    (a, eng_gpu), (b, eng_cpu) = runs["cuda"], runs["cpu"]
    if not (np.array_equal(a["n_candidates"], b["n_candidates"])
            and np.array_equal(np.isfinite(a["score"]),
                               np.isfinite(b["score"]))):
        fail("u16 windowed f64 rollouts: card and CPU decisions differ")
    if eng_gpu != eng_cpu or eng_gpu == 0:
        fail(f"u16 windowed rollouts: the window engaged on {eng_gpu} card "
             f"and {eng_cpu} CPU frames")
    ok = ~np.isnan(a["pose"]).any(1) & ~np.isnan(b["pose"]).any(1)
    phase("rollout_codes", card=repr(smi), cache_dtype="u16", window=768,
          frames=CODES_FRAMES, clipped_m=6.0,
          tracked=int(np.isfinite(a["score"]).sum()),
          window_engaged_frames=eng_gpu, n_candidates="identical",
          tracked_pattern="identical",
          max_pose_diff_px=float(np.abs(a["pose"][ok] - b["pose"][ok]).max()),
          seconds=round(time.perf_counter() - t_codes, 2))

    # f32 on the card, timed to value; the main path's run for the counts
    fr32 = loop.stack_frames(ds, dtype=np.float32)
    fr32_dev = {k: torch.as_tensor(v, device=device)
                for k, v in fr32.items()}
    loop.run_sequence(fr32_dev, ctx32, cfg, device=device)  # warm-up
    times = []
    sc.score_partials.launches = 0
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop.run_sequence(fr32_dev, ctx32, cfg, device=device)
        res = {k: v.cpu().numpy() for k, v in out.items()}   # to value
        times.append((time.perf_counter() - t0) * 1e3)
    launches = sc.score_partials.launches
    if launches != F * REPEATS:
        fail(f"score_partials launched {launches} times in "
             f"{REPEATS} rollouts of {F} frames")
    if res["pose"].shape != (F, 3) or res["score"].shape != (F,):
        fail("rollout outputs have unexpected shapes")
    tracked = np.isfinite(res["score"]) & ~np.isnan(res["pose"]).any(1)
    if not tracked.any():
        fail("the f32 rollout tracked no frame")
    med = float(np.median(times))
    phase("rollout_f32", device=repr(kind), power=repr(smi),
          median_ms=med, min_ms=min(times), max_ms=max(times),
          scans_per_s=F / med * 1e3, frames=F,
          tracked=int(tracked.sum()),
          rmse_m=rmse_m(res["pose"], scene, tracked),
          launches=launches, launches_per_frame=launches / (F * REPEATS))

    # where the time goes: the first PROFILE_FRAMES frames once more under
    # the profiler (its event processing costs ~0.5 s a frame)
    fr_prof = {k: v[:PROFILE_FRAMES] for k, v in fr32_dev.items()}
    wall, acts = device_profile(
        lambda: loop.run_sequence(fr_prof, ctx32, cfg, device=device))
    busy = sum(v[1] for v in acts.values()) / 1e3
    top = sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]
    score_ms = sum(v[1] for k, v in acts.items()
                   if "score_partials_kernel" in k) / 1e3
    phase("profile_f32", card=repr(smi), frames=PROFILE_FRAMES, wall_ms=wall,
          device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
          device_ops_per_frame=sum(v[0] for v in acts.values())
          / PROFILE_FRAMES,
          score_kernel_ms=score_ms,
          top=repr([(k[:60], v[0], round(v[1] / 1e3, 3)) for k, v in top]))

    # --- 6. map prep (slice 2) -------------------------------------------
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.ops import nfa as onfa
    grid = ds.map_value
    cpu = torch.device("cpu")

    # f64 on the card vs the CPU: the same lines, one launch per count
    prep = {}
    for dev in (device, cpu):
        st = MapPrepStats()
        onfa.rect_counts.launches = 0
        t0 = time.perf_counter()
        art, calls = record_rect_counts(lambda: prepare_map(
            grid, resol, dtype=torch.float64, device=dev, stats=st))
        got = art.lines_info.cpu().numpy()
        prep[dev.type] = (art, st, onfa.rect_counts.launches, calls, got)
        phase("mapprep_f64", device=dev.type, card=repr(smi),
              seconds=round(time.perf_counter() - t0, 2), lines=len(got),
              seeds=st.seeds, waves=st.waves, nfa_calls=st.nfa_calls,
              nfa_rects=st.nfa_rects, syncs=st.syncs,
              nfa_launches=onfa.rect_counts.launches)
    (a_gpu, st_gpu, launch_gpu, calls64, l_gpu), (a_cpu, st_cpu, _l, _c,
                                                  l_cpu) = \
        prep["cuda"], prep["cpu"]
    if len(l_gpu) != len(l_cpu):
        fail(f"f64 map prep: {len(l_gpu)} lines on the card, {len(l_cpu)} "
             "on the CPU")
    end_diff = float(np.abs(l_gpu[:, 4:8] - l_cpu[:, 4:8]).max()) \
        if len(l_cpu) else 0.0
    if not end_diff <= 1e-6:
        fail(f"f64 map prep: endpoints differ by {end_diff} px card vs CPU")
    if not torch.equal(a_gpu.map_cache.cpu(), a_cpu.map_cache):
        fail("f64 map prep: map_cache differs card vs CPU")
    # every count call on the card launched the kernel; the seed walk is
    # the CPU's, and the count calls agree up to an improver phase that
    # one rectangle's ulp-level NFA difference can add or drop (CUDA's
    # sin/cos/atan2 and reduction order are not the CPU's)
    if not launch_gpu == st_gpu.nfa_calls > 0:
        fail(f"f64 map prep: {launch_gpu} NFA launches for "
             f"{st_gpu.nfa_calls} count calls on the card")
    if (st_gpu.seeds, st_gpu.waves) != (st_cpu.seeds, st_cpu.waves):
        fail("f64 map prep: the seed walks differ card vs CPU")
    if abs(st_gpu.nfa_calls - st_cpu.nfa_calls) > max(1, st_cpu.nfa_calls
                                                        // 100):
        fail(f"f64 map prep: {st_gpu.nfa_calls} count calls on the card, "
             f"{st_cpu.nfa_calls} on the CPU")
    phase("mapprep_f64_parity", lines=len(l_gpu),
          max_endpoint_diff_px=end_diff, map_cache="bit-exact",
          nfa_launches=launch_gpu, card_count_calls=st_gpu.nfa_calls,
          cpu_count_calls=st_cpu.nfa_calls, card_rects=st_gpu.nfa_rects,
          cpu_rects=st_cpu.nfa_rects)

    # f32 on the card, time to value (synchronize, lines to the host)
    def prep32(stats):
        art = prepare_map(grid, resol, dtype=torch.float32, device=device,
                          stats=stats)
        return art.lines_info.cpu().numpy()

    _l32, calls32 = record_rect_counts(lambda: prep32(MapPrepStats()))
    times, sts = [], []
    onfa.rect_counts.launches = 0
    for _ in range(3):
        sts.append(MapPrepStats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l32 = prep32(sts[-1])
        times.append((time.perf_counter() - t0) * 1e3)
    launches32 = onfa.rect_counts.launches
    if launches32 != sum(x.nfa_calls for x in sts) or launches32 == 0:
        fail(f"f32 map prep: {launches32} NFA launches for "
             f"{[x.nfa_calls for x in sts]} count calls")
    wall, acts = device_profile(lambda: prep32(MapPrepStats()))
    busy = sum(v[1] for v in acts.values()) / 1e3
    nfa_dev = kernel_device_ms(acts, "rect_counts_kernel")
    st = sts[-1]
    m25, m2 = match_lines(l32, l_gpu, 25.0), match_lines(l32, l_gpu, 2.0)
    phase("mapprep_f32", device=repr(kind), power=repr(smi),
          median_ms=float(np.median(times)), min_ms=min(times),
          max_ms=max(times), lines=len(l32), lines_f64=len(l_gpu),
          matched_25px=m25, matched_2px=m2, seeds=st.seeds, waves=st.waves,
          nfa_launches=st.nfa_calls, nfa_rects=st.nfa_rects, syncs=st.syncs,
          profiled_wall_ms=wall, device_busy_ms=busy,
          device_idle_share=1.0 - busy / wall,
          device_ops=sum(v[0] for v in acts.values()),
          nfa_kernel_mean_device_ms=nfa_dev,
          top=repr([(k[:50], v[0], round(v[1] / 1e3, 3)) for k, v in
                    sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]]))
    if not (0.7 * len(l_gpu) <= len(l32) <= 1.6 * len(l_gpu)
            and m25 >= int(0.9 * len(l_gpu)) and m2 >= int(0.7 * len(l_gpu))):
        fail("f32 map prep lines are not structurally the f64 lines")

    # the NFA kernel on the launches the main path made
    n_checked = 0
    for calls in (calls32, calls64):
        for deg_map, scal, all_pix, ali_pix in calls:
            want = onfa.rect_counts_reference(deg_map, scal)
            if not (torch.equal(all_pix, want[0])
                    and torch.equal(ali_pix, want[1])):
                fail("a recorded NFA launch differs from the plain version")
            n_checked += 1
    for deg_map in (calls32[0][0], calls64[0][0]):
        sc_d = degenerate_rects(deg_map)
        got = onfa.rect_counts(deg_map, sc_d)
        want = onfa.rect_counts_reference(deg_map, sc_d)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and int(got[0].min()) > 0):
            fail(f"degenerate rectangles ({deg_map.dtype}): kernel counts "
                 "differ from the plain version")
    phase("nfa_kernel_check", recorded_launches_checked=n_checked,
          f32_launches=len(calls32), f64_launches=len(calls64),
          degenerate="vertical, horizontal, outside: equal")

    nfa_runs = nfa_cases(calls32, repr(smi), floor_ms)
    phase("library", kernel="rect_counts", library_ms="null",
          reason="'no single PyTorch call rasterizes and counts a batch of "
                 "rectangles'")

    # --- 7. the whole path: grid -> map prep -> rollout (f32) -----------
    sc.score_partials.launches = 0
    onfa.rect_counts.launches = 0
    st = MapPrepStats()
    t0 = time.perf_counter()
    art = prepare_map(grid, resol, dtype=torch.float32, device=device,
                      stats=st)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    ctx_e = loop.make_map_context(art.lines_info, art.map_cache, resol,
                                  ds.param.ori_x, ds.param.ori_y,
                                  dtype=np.float32, device=device)
    cfg_e = cfg
    rollouts = 0
    while True:   # warm-up; raise the candidate cap until nothing overflows
        out = loop.run_sequence(fr32_dev, ctx_e, cfg_e, device=device)
        rollouts += 1
        over = out["candidate_overflow"].cpu().numpy()
        K = cfg_e.shapes.max_candidates
        if not over.any() or K >= 16384:
            break
        cfg_e = dataclasses.replace(cfg_e, shapes=dataclasses.replace(
            cfg_e.shapes, max_candidates=2 * K))
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop.run_sequence(fr32_dev, ctx_e, cfg_e, device=device)
        res = {k: v.cpu().numpy() for k, v in out.items()}
        times.append((time.perf_counter() - t0) * 1e3)
        rollouts += 1
    launches_e = {"rect_counts": onfa.rect_counts.launches,
                  "score_partials": sc.score_partials.launches}
    if launches_e["rect_counts"] != st.nfa_calls or st.nfa_calls == 0:
        fail(f"end to end: {launches_e['rect_counts']} NFA launches for "
             f"{st.nfa_calls} count calls")
    if launches_e["score_partials"] != F * rollouts:
        fail(f"end to end: score_partials launched "
             f"{launches_e['score_partials']} times in {rollouts} rollouts")
    tracked = np.isfinite(res["score"]) & ~np.isnan(res["pose"]).any(1)
    if not tracked.any():
        fail("the end-to-end f32 rollout on LSD map lines tracked no frame")
    phase("end_to_end_f32", device=repr(kind), power=repr(smi),
          map_prep_s=prep_s, map_lines=int(art.lines_info.shape[0]),
          max_candidates=cfg_e.shapes.max_candidates,
          max_candidates_raised=cfg_e.shapes.max_candidates
          != cfg.shapes.max_candidates,
          candidate_overflow_frames=int(res["candidate_overflow"].sum()),
          rollout_median_ms=float(np.median(times)), min_ms=min(times),
          max_ms=max(times), frames=F, tracked=int(tracked.sum()),
          rmse_m=rmse_m(res["pose"], scene, tracked),
          nfa_launches=launches_e["rect_counts"],
          score_launches=launches_e["score_partials"])
    # the CalcScore kernel at this path's relock frame: its largest launch
    e2e_cases = score_frame_cases(scene, ctx_e, cfg_e, device, repr(smi),
                                  floor_ms, prefix="e2e_",
                                  frames=("relock",))

    # --- 9. FIFO growth (slice 4) -----------------------------------------
    # the same scene with round pillars: their arcs grow sparse regions,
    # which the refiner sends through the radius reducer
    from lsdtpu_torch.ops import grow as og
    t_fifo = time.perf_counter()
    clock = sm_clock_hz()
    lat = og.latency_probe(device)
    phase("latency_probe", card=repr(smi), sm_clock_mhz=clock / 1e6,
          units="'SM cycles per dependent step'",
          **{k: round(v, 2) for k, v in lat.items()})
    scene_p = make_scene(PILLARS)
    ds_p = scene_p.dataset
    grid_p = ds_p.map_value

    # f64 on the card (every launch recorded) vs the CPU
    prep = {}
    for dev in (device, cpu):
        st = MapPrepStats()
        og.grow_fifo.launches = og.radius_reducer_fifo.launches = 0
        t0 = time.perf_counter()
        art, grows, reduces = record_fifo(lambda: prepare_map(
            grid_p, resol, growth="fifo", dtype=torch.float64, device=dev,
            stats=st))
        got = art.lines_info.cpu().numpy()
        prep[dev.type] = (st, got, grows, reduces,
                          (og.grow_fifo.launches,
                           og.radius_reducer_fifo.launches))
        phase("mapprep_fifo_f64", device=dev.type, card=repr(smi),
              seconds=round(time.perf_counter() - t0, 2), lines=len(got),
              seeds=st.seeds, growth_calls=st.fifo_calls, pops=st.pops,
              passes=st.passes, reducer_passes=st.reducer_passes,
              nfa_calls=st.nfa_calls, syncs=st.syncs,
              kernel_launches=prep[dev.type][4])
    (st_g, l_g, grows64, reduces64, (gl, rl)), (st_c, l_c, grows_c, _r,
                                                  _l) = prep["cuda"], prep["cpu"]
    if (gl, rl) != (st_g.fifo_calls, st_g.reducer_passes) or gl == 0:
        fail(f"f64 FIFO map prep: {gl} grow_fifo and {rl} reducer launches "
             f"for {st_g.fifo_calls} growth calls and {st_g.reducer_passes} "
             "reducer passes")

    # every recorded f64 launch through the plain version
    cpu_maps = tuple(t.cpu() for t in (grows64[0]["deg"], grows64[0]["sn"],
                                       grows64[0]["cs"]))
    t0 = time.perf_counter()
    differ, max_rd = [], 0.0
    for i, c in enumerate(grows64):
        same, rd = replay_grow(c, cpu_maps)
        max_rd = max(max_rd, rd) if same else max_rd
        if not same or rd > 1e-12:
            differ.append(i)
            if len(differ) == 1:
                phase("grow_kernel_check", first_differing_call=i,
                      seed=(c["sy"], c["sx"]), reg_deg_diff=rd,
                      kernel_counts=c["counts"].tolist())
    r_differ = [i for i, c in enumerate(reduces64) if not replay_reduce(c)]
    phase("grow_kernel_check", dtype="float64", grow_launches=len(grows64),
          grow_differing=len(differ), max_reg_deg_diff=max_rd,
          reducer_launches=len(reduces64), reducer_differing=len(r_differ),
          replay_s=round(time.perf_counter() - t0, 2))
    if differ or r_differ:
        fail(f"f64 FIFO kernels: {len(differ)} grow_fifo and "
             f"{len(r_differ)} radius_reducer_fifo launches differ from "
             "their plain versions")
    if len(reduces64) == 0:
        fail("f64 FIFO map prep never ran the radius reducer")
    end_diff = float(np.abs(l_g[:, 4:8] - l_c[:, 4:8]).max()) \
        if len(l_g) == len(l_c) and len(l_c) else np.inf
    walks = [(st.seeds, st.fifo_calls, st.pops, st.passes, st.reducer_passes,
              st.nfa_calls) for st in (st_g, st_c)]
    if len(l_g) != len(l_c) or not end_diff <= 1e-9 or walks[0] != walks[1]:
        part = first_differing_growth(grows64, grows_c)
        phase("mapprep_fifo_f64_divergence", walk_card=walks[0],
              walk_cpu=walks[1], first_differing_growth_call=(
                  "none" if part is None else part[0]),
              card_call=None if part is None else part[1],
              cpu_call=None if part is None else part[2])
        fail(f"f64 FIFO map prep: {len(l_g)} lines on the card, {len(l_c)} "
             f"on the CPU, endpoints within {end_diff} px; seed walk "
             f"(seeds, growth calls, pops, passes, reducer passes, NFA "
             f"calls) {walks[0]} on the card, {walks[1]} on the CPU")
    del grows_c
    phase("mapprep_fifo_f64_parity", lines=len(l_g),
          max_endpoint_diff_px=end_diff, seeds=st_g.seeds,
          growth_calls=st_g.fifo_calls, pops=st_g.pops,
          reducer_passes=st_g.reducer_passes)
    fifo_runs = fifo_kernel_cases(grows64, reduces64, repr(smi), floor_ms,
                                  lat, clock)
    del grows64, reduces64

    # f32 on the card: wave and FIFO on this map, time to value (median
    # of FIFO_REPEATS), and a sample of the FIFO launches replayed
    def prep_p(stats, growth):
        art = prepare_map(grid_p, resol, growth=growth, dtype=torch.float32,
                          device=device, stats=stats)
        return art.lines_info.cpu().numpy()

    res = {}
    for growth in ("wave", "fifo"):     # (wave is warm from phases 6-7)
        if growth == "fifo":
            _l, grows32, reduces32 = record_fifo(
                lambda: prep_p(MapPrepStats(), "fifo"))
        times, sts = [], []
        og.grow_fifo.launches = og.radius_reducer_fifo.launches = 0
        onfa.rect_counts.launches = 0
        for _ in range(FIFO_REPEATS):
            sts.append(MapPrepStats())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lines_g = prep_p(sts[-1], growth)
            times.append((time.perf_counter() - t0) * 1e3)
        res[growth] = (lines_g, sts[-1], times,
                       (og.grow_fifo.launches,
                        og.radius_reducer_fifo.launches,
                        onfa.rect_counts.launches))
    (lw, stw, tw, _lw), (lf, stf, tf, (gl, rl, nl)) = res["wave"], res["fifo"]
    want = tuple(sum(getattr(x, k) for x in sts)
                 for k in ("fifo_calls", "reducer_passes", "nfa_calls"))
    if (gl, rl, nl) != want or gl == 0:
        fail(f"f32 FIFO map prep: launches {(gl, rl, nl)} for the counted "
             f"calls {want}")
    wall, acts = device_profile(lambda: prep_p(MapPrepStats(), "fifo"))
    busy = sum(v[1] for v in acts.values()) / 1e3
    m25, m2 = match_lines(lf, l_g, 25.0), match_lines(lf, l_g, 2.0)
    phase("mapprep_fifo_f32", device=repr(kind), power=repr(smi),
          median_ms=float(np.median(tf)), min_ms=min(tf), max_ms=max(tf),
          wave_median_ms=float(np.median(tw)), lines=len(lf),
          wave_lines=len(lw), lines_f64=len(l_g), matched_25px=m25,
          matched_2px=m2, seeds=stf.seeds, growth_calls=stf.fifo_calls,
          pops=stf.pops, passes=stf.passes,
          reducer_passes=stf.reducer_passes, syncs=stf.syncs,
          wave_syncs=stw.syncs, nfa_launches=stf.nfa_calls,
          wave_nfa_launches=stw.nfa_calls, profiled_wall_ms=wall,
          device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
          grow_kernel_mean_device_ms=kernel_device_ms(acts,
                                                       "grow_fifo_kernel"),
          grow_kernel_device_ms=sum(v[1] for k, v in acts.items()
                                    if "grow_fifo_kernel" in k) / 1e3,
          top=repr([(k[:50], v[0], round(v[1] / 1e3, 3)) for k, v in
                    sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]]))
    if not (0.7 * len(l_g) <= len(lf) <= 1.6 * len(l_g)
            and m25 >= int(0.9 * len(l_g)) and m2 >= int(0.7 * len(l_g))):
        fail("f32 FIFO map prep lines are not structurally the f64 lines")
    cpu_maps = tuple(t.cpu() for t in (grows32[0]["deg"], grows32[0]["sn"],
                                       grows32[0]["cs"]))
    big32 = sorted(range(len(grows32)), key=lambda i: -int(grows32[i]
                                                          ["counts"][1]))
    sample = sorted(set(range(0, len(grows32), 25)) | set(big32[:20]))
    d32 = [i for i in sample if not replay_grow(grows32[i], cpu_maps)[0]]
    rd32 = [i for i, c in enumerate(reduces32) if not replay_reduce(c)]
    phase("grow_kernel_check", dtype="float32", sampled=len(sample),
          of=len(grows32), grow_differing=len(d32),
          first_differing=(None if not d32 else
                           (d32[0], grows32[d32[0]]["sy"],
                            grows32[d32[0]]["sx"])),
          reducer_launches=len(reduces32), reducer_differing=len(rd32))
    del grows32, reduces32

    # the whole FIFO path: grid -> FIFO map prep -> rollout (f32), every
    # kernel's count from 0 just before and read just after
    fr_p = {k: torch.as_tensor(v, device=device)
            for k, v in loop.stack_frames(ds_p, dtype=np.float32).items()}
    sc.score_partials.launches = onfa.rect_counts.launches = 0
    og.grow_fifo.launches = og.radius_reducer_fifo.launches = 0
    st = MapPrepStats()
    t0 = time.perf_counter()
    art = prepare_map(grid_p, resol, growth="fifo", dtype=torch.float32,
                      device=device, stats=st)
    pillar_art = art      # the pillar map of the batch phases
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    ctx_f = loop.make_map_context(art.lines_info, art.map_cache, resol,
                                  ds_p.param.ori_x, ds_p.param.ori_y,
                                  dtype=np.float32, device=device)
    cfg_f = cfg
    rollouts = 0
    while True:   # warm-up; raise the candidate cap until nothing overflows
        out = loop.run_sequence(fr_p, ctx_f, cfg_f, device=device)
        rollouts += 1
        K = cfg_f.shapes.max_candidates
        if not out["candidate_overflow"].cpu().numpy().any() or K >= 16384:
            break
        cfg_f = dataclasses.replace(cfg_f, shapes=dataclasses.replace(
            cfg_f.shapes, max_candidates=2 * K))
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop.run_sequence(fr_p, ctx_f, cfg_f, device=device)
        res_f = {k: v.cpu().numpy() for k, v in out.items()}
        times.append((time.perf_counter() - t0) * 1e3)
        rollouts += 1
    launches_f = {"score_partials": sc.score_partials.launches,
                  "rect_counts": onfa.rect_counts.launches,
                  "grow_fifo": og.grow_fifo.launches,
                  "radius_reducer_fifo": og.radius_reducer_fifo.launches}
    want = {"score_partials": F * rollouts, "rect_counts": st.nfa_calls,
            "grow_fifo": st.fifo_calls,
            "radius_reducer_fifo": st.reducer_passes}
    if launches_f != want or min(want.values()) == 0:
        fail(f"end to end FIFO: launches {launches_f}, expected {want}")
    tracked = np.isfinite(res_f["score"]) & ~np.isnan(res_f["pose"]).any(1)
    if not tracked.any():
        fail("the end-to-end FIFO rollout tracked no frame")
    phase("end_to_end_fifo_f32", device=repr(kind), power=repr(smi),
          pillars=PILLARS, map_prep_s=prep_s,
          map_lines=int(art.lines_info.shape[0]),
          max_candidates=cfg_f.shapes.max_candidates,
          candidate_overflow_frames=int(res_f["candidate_overflow"].sum()),
          rollout_median_ms=float(np.median(times)), min_ms=min(times),
          max_ms=max(times), frames=F, tracked=int(tracked.sum()),
          rmse_m=rmse_m(res_f["pose"], scene_p, tracked),
          launches=launches_f,
          fifo_seconds=round(time.perf_counter() - t_fifo, 2))

    # --- 10. the streaming entry point (slice 5) ---------------------------
    t_online = time.perf_counter()
    online_launches = online_tracking(scene, lines, cache64, cfg, device,
                                      smi, kind)
    polish_launches = online_polish(scene, lines, cache64, cfg, device, smi)
    legacy_nfa = online_legacy(scene, cfg, device, smi, kind)
    phase("online", card=repr(smi),
          seconds=round(time.perf_counter() - t_online, 2))

    # --- 11. batched rollouts and the serving pool (slice 6) ---------------
    t_batch = time.perf_counter()
    batch_cases = [
        batch_kernel_case(f"mixed{BATCH_LANES}_{tag}_{path}", scene, lines,
                          cache64, cfg, device, repr(smi), floor_ms, dt,
                          range(BATCH_LANES), path == "pruned")
        for tag, dt in (("f32", np.float32), ("f64", np.float64))
        for path in ("pruned", "unpruned")]
    batch_cases.append(batch_kernel_case(
        f"tracking{TRACKING_LANES}_f32_pruned", scene, lines, cache64, cfg,
        device, repr(smi), floor_ms, np.float32,
        range(1, TRACKING_LANES + 1), True))
    maps = [(scene, lines, cache64),
            (scene_p, pillar_art.lines_info, pillar_art.map_cache)]
    batch_launches = batch_rollouts(maps, cfg, device, smi, kind)
    pool_launches = serving(maps, cfg, device, smi, kind)
    phase("batch", card=repr(smi),
          seconds=round(time.perf_counter() - t_batch, 2))

    # --- 12. the command-line interface ------------------------------------
    t_cli = time.perf_counter()
    cli_runs = cli_phases(scene, device, smi, kind)
    # each kernel's launches in each command's run (the two refine and the
    # two batch commands summed)
    cli_paths = {}
    for tag, counts in cli_runs.items():
        path = tag.rsplit("_", 1)[0] if tag.startswith(
            ("cli_refine_", "cli_batch_")) else tag
        for k, v in counts.items():
            cli_paths.setdefault(path, dict.fromkeys(counts, 0))[k] += v
    phase("cli", card=repr(smi), launches=json.dumps(cli_paths),
          seconds=round(time.perf_counter() - t_cli, 2))

    # --- 13. report ------------------------------------------------------
    main_case = cases[1]      # relock frame as the main path scores it
    kern = {
        "name": "score_partials", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True, "launches": launches,
        "launches_by_path": {"rollout_f32": launches,
                             "end_to_end_f32": launches_e["score_partials"],
                             "end_to_end_fifo_f32":
                                 launches_f["score_partials"],
                             "online_f32": online_launches,
                             "online_polish_f64": polish_launches,
                             "online_legacy": 0,
                             "batch_f32": batch_launches,
                             "serving_f32": pool_launches},
        "launches_by_path_note": "batch_f32 and serving_f32 launch the "
                                 "kernel through score_partials_batched, "
                                 "one launch for all lanes",
        "max_abs_err": max(c["max_abs_err"] for c in
                           cases + e2e_cases + code_cases),
        "ms": main_case["ms"], "ms_source": main_case["ms_source"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "floor_ms": floor_ms,
        "design": "persistent grid (SMs x resident blocks); a block "
                  "scores one live slot at a time over the whole pixel "
                  "cloud held in registers; warp sums, warps in order, "
                  "no cross-block reduction",
        "cases": cases + e2e_cases + code_cases,
    }
    top = nfa_runs[0]         # the batch with the most covered pixels
    nfa_kern = {
        "name": "rect_counts", "route": "cuda",
        "source": "lsdtpu_torch/csrc/nfa.cu",
        "replaces": "lsdtpu/ops/nfa_pallas.py:87",
        "checked": True, "launches": launches_e["rect_counts"],
        "launches_by_path": {"end_to_end_f32": launches_e["rect_counts"],
                             "end_to_end_fifo_f32": launches_f["rect_counts"],
                             "online_legacy": legacy_nfa},
        "max_abs_err": 0.0, "ms": top["ms"], "ms_source": top["ms_source"],
        "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": None,
        "mean_device_ms_per_launch": nfa_dev, "floor_ms": floor_ms,
        "design": "one 512-thread block per rectangle; column bounds, "
                  "block scan of the heights, flat covered index by "
                  "binary search",
        "cases": nfa_runs,
    }
    fifo_kern = []
    for run, name, replaces in (
            (fifo_runs[0], "grow_fifo", "lsdtpu/mapprep/lsd.py:109"),
            (fifo_runs[-1], "radius_reducer_fifo",
             "lsdtpu/mapprep/rect.py:136")):
        fifo_kern.append({
            "name": name, "route": "cuda",
            "source": "lsdtpu_torch/csrc/grow.cu", "replaces": replaces,
            "replaces_note": "an XLA while_loop of the reference package; "
                             "no Pallas kernel",
            "checked": True, "launches": launches_f[name],
            "launches_by_path": {"end_to_end_fifo_f32": launches_f[name]},
            "max_abs_err": max_rd if name == "grow_fifo" else 0.0,
            "ms": run["ms"], "ms_source": run["ms_source"],
            "plain_ms": run["plain_ms"], "bound_ms": run["bound_ms"],
            "bound_by": run["bound_by"], "bound_kind": run["bound_kind"],
            "bytes_bound_ms": run["bytes_bound_ms"],
            "ops_bound_ms": run["ops_bound_ms"], "latency_cycles": lat,
            "library_ms": None,
            "floor_ms": floor_ms,
            "design": "one block; its threads clear the region mask, one "
                      "thread walks the queue with each pop's 9 neighbours "
                      "loaded before any decision" if name == "grow_fifo"
                      else "one thread: swap-with-last removal, then the "
                           "phantom-slot drop",
            "cases": [run]})
    bmain = batch_cases[0]    # one relocking lane beside seven tracking
    batched_kern = {
        "name": "score_partials_batched", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True, "launches": batch_launches + pool_launches,
        "launches_by_path": {"batch_f32": batch_launches,
                             "serving_f32": pool_launches},
        "max_abs_err": max(c["max_abs_err"] for c in batch_cases),
        "ms": bmain["ms"], "ms_source": bmain["ms_source"],
        "plain_ms": bmain["plain_ms"], "bound_ms": bmain["bound_ms"],
        "bound_by": bmain["bound_by"], "library_ms": None,
        "single_sum_ms": bmain["single_sum_ms"], "floor_ms": floor_ms,
        "design": "the CalcScore kernel on a (grid, B) grid: blockIdx.y is "
                  "the lane, each lane the same persistent x-extent (the "
                  "resident blocks over B); a lane's slots, arithmetic and "
                  "summation order are the single-lane launch's",
        "cases": batch_cases,
    }
    kernels = [kern, batched_kern, nfa_kern] + fifo_kern
    for k in kernels:
        k["launches_by_path"].update(
            {path: counts[k["name"]] for path, counts in cli_paths.items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
