#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsdtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with one H100

Drives the port's paths at the extent of the bundled data1 sequence
(a 979x1440 map at 0.025 m/px, 279 frames of 360-ray scans to 13 m) on
a synthetic multi-room scene made from a seed, since no dataset is
mounted on the card's machine: the per-frame localization rollout
(run_sequence) and map prep (prepare_map: occupancy grid -> LSD map
lines + distance field), then both together, then the streaming entry
point (OnlineLocalizer and the ROS adapter), and on to the CLI, the
multi-device runners, the numpy oracle's map prep and the bench entry
point.  Phases, each printed on
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
     on the card, 2 repeats timed to value, with the kernel's launch
     count checked against one launch per frame (wall-segment lines, as
     before map prep was ported, so the numbers stay comparable); then
     rollout_strategies_f32 - the same 279 frames under each
     execution strategy (the default loop, the default with the frames on
     the host, prefeaturize, scan_unroll 8 with and without the batched
     featurize, scan_unroll 32), one run each in turn (A B C ...):
     time to value, scans/s, RDP host rounds, one CalcScore launch a
     frame, the peak device memory, every run bitwise the default's; and
     the device idle share of PROFILE_FRAMES frames under prefeaturize;
  6. map prep: f64 on the card vs the CPU (the same lines within 1e-6
     px, the distance field bit-exact, one NFA kernel launch per count
     call), f32 on the card timed to value (median of 2) with the seed
     walk's counters and the device idle share, then the NFA kernel
     against its plain version on every launch the two runs made, on
     degenerate rectangles, and timed (with the bitwise repeat check) on
     three recorded batches;
  7. end to end: grid -> prepare_map (f32, card) -> make_map_context ->
     run_sequence of the 279 frames, 2 repeats, tracked frames and the
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
     time and bound; the kernels past their shared-memory plans (a region
     spilling the shared queue, a 1600x1600 field whose bitmap exceeds
     the shared budget, the reducer on queues past its shared slots),
     f32 and f64, each against its plain version; f32 wave and FIFO map
     prep timed to value with the counters, a sample of the f32 launches
     replayed, and each FIFO kernel's launches, mean and summed device ms
     and summed per-launch bounds over that map prep; then grid -> FIFO
     map prep -> rollout of the 279 frames, 2 repeats, with every kernel's
     launches counted from 0 over that run;
 10. the streaming entry point (slice 5), on the same scene:
     online_f32 - the 279 scans as ROS-shaped LaserScans (INF where a
     ray hit nothing) through OnlineLocalizer.push_laser_scan (f32,
     wall-segment lines), per-scan latency to the numpy dict (p50, p99,
     max) and scans/s, bitwise equal to run_sequence on the same
     compacted frames, one CalcScore launch per scan, and a checkpoint
     saved after frame 140 resumed in a fresh session, bitwise equal to
     the uninterrupted run; checkpoint_dcp (slice 14) - the same state
     through save_state_dcp / load_state_dcp on the card (bytes, save and
     load ms, median of 3), bitwise the npz-restored state, and a session
     with the npz's odometry anchor and the DCP state resuming bitwise;
     online_polish_f64 - 30 scans with
     match.polish_pose, card vs CPU in f64 (identical decisions, poses
     within 1e-6 px); online_legacy - LsdRosAdapter(mode="legacy") over
     fake /map_metadata, /map (map prep on the card: wave, z = 2, f32;
     NFA launches equal to its count calls, time to value) and 279 /scan
     messages (legacy poses, latency, position error), then f64 legacy
     sessions on the card and the CPU on the adapter's artifacts: the
     same first-minimum pose on each of the first 140 frames;
 11. batched rollouts and the serving pool (slice 6), on the same scene
     and the pillar map: batch_kernel_check - the lane-batched CalcScore
     launch at 8 lanes (the relock frame beside seven tracking frames,
     the last lane on a 700x1100 crop padded with the cap) in f32 and f64,
     pruned and unpruned, and at 16 tracking lanes: against its plain
     version, each lane bit for bit against a single-lane launch, 50
     repeats bitwise, device ms against the sum of the single launches,
     the lanes' summed bound and the floor; batch_f32 - run_batch over 1,
     4, 16 and 64 lanes of 100 frames (the lanes alternating between the
     two maps, each from its own frame offset): time to value (one run),
     scans/s,
     one batched CalcScore launch a frame, RDP rounds a frame, the device
     idle share of the 16-lane batch; at 16 and 64 lanes the runs
     alternate with as many under prefeaturize, bitwise the default's
     (rollout_strategies_batch_f32, the same numbers as the single
     sequence's strategies); checkpoint_dcp of the 16 lanes - stepped
     frame by frame (bitwise run_batch), checkpointed after frame 50 as
     npz and DCP (the DCP state bitwise the npz's, the remaining frames
     resumed from it bitwise), the end state saved and loaded, timed;
     f64 lanes against their solo
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
     kernel's launches counted from 0 around each command; then (slice
     9) oracle_mapprep - `prepare-map --mapprep oracle` and
     OnlineLocalizer(mapprep="oracle").set_map on the card give exactly
     the numpy oracle's lines and field (f64, and f32 in the session),
     the oracle's host time, and a streaming pass over them tracking
     every frame; and bench - lsdtpu_torch.bench.main over the dataset
     directory: its JSON line with bench.py's keys and backend "cuda",
     every frame tracked, the baseline kind, each of its rollouts
     (BENCH_REPEATS, each after a warm one) bit for bit a plain
     run_sequence, and one CalcScore launch a frame of each;
 13. the multi-device runners (slice 8): multi_world1 - run_batch_sharded
     (tp) and run_batch_sharded_mapblocks (mp) over one rank (NCCL) on
     two f64 lanes of the two maps, each bitwise run_batch, and the pod
     mesh of one host; multi_prep - the block-built distance field and the
     slab-sharded LSD prologue (4 blocks) bitwise their single-card
     counterparts; the lane-batched CalcScore over a row block (row0 > 0,
     f32 and f64) and, in 6, the NFA kernel on row blocks (row0 > 0, a
     block crossing n_rows) against their plain versions, timed;
     multi_two_ranks - two ranks spawned on the one card over gloo
     (python3 chip_smoke.py --multi-rank ...; a join timeout): tp = 2 and
     mp = 2 rollouts (poses within 1e-9 px of run_sequence, one launch a
     frame a rank, the mp ranks' row0), the pipelined rollout (bitwise
     run_sequence), a 2 x 8 slot pool against a 16-slot pool, the sharded
     wave LSD (f32, f64) against the unsharded one, with each rank's NFA
     launches equal to its count calls, and checkpoint_dcp - both ranks
     save one replicated state to one DCP checkpoint under the group (one
     .metadata, each field stored once) and load it back bitwise;
     multi_temporal - the whole
     sequence as 8 and 16 segments (the lanes of one rollout) against
     rollout_f32: tracked frames, position error, one launch a frame,
     scans/s (median of 2), the reconciled ATE; cli_sharded - prepare-map
     --mapprep tpu-sharded and batch --concat --temporal 8;
 14. fuzz_campaign (slice 12): scripts/torch_fuzz_campaign.py's campaign
     on the card at reduced counts (seeds 100-107 for the distance
     field, 100-102 for wave and FIFO LSD, 100-103 for f64 rollouts with
     seed 101's perfect-score chain, seed 100 on two ranks; then the
     FIFO map of seed 118, whose regions need the radius reducer): the
     oracle's contracts, card = CPU in f64, and every launch of the four
     kernels replayed through its plain version on the CPU; its tallies,
     launches held and wall time;
 15. the reference package's last two tools: sol_bound -
     scripts/torch_sol_bound.py's counting rollout of the 279 frames on
     the oracle's map of the scene (the bench's K = 4096, P = 2048, f32),
     every CalcScore launch of the phase counted and held against its
     plain version (the constants' timed repeats bitwise a held launch),
     the first 12 frames' counts equal to the CPU's in f64 and in f32 but
     on frame 3, whose one distance-gate flip is shown and traced to the
     stages that part the devices, the card's constants (gather rates,
     H2D, loop floor, featurize and UKF device ms) and the floor of each
     gather count beside one timed run of the counted configuration (and
     rollout_f32's and the strategies' times); pod_bench_w1 and
     pod_bench_w2 - scripts/torch_pod_bench.py (60 frames, 1 repeat, all
     four modes) in this process and as two ranks sharing the card over
     gloo (torchrun's environment; python3 chip_smoke.py --pod-rank
     ...), every CalcScore launch (single-lane and lane-batched) held
     against its plain version, each SCALING json checked and printed;
 16. a JSON line of the kernels (with their launches on each path), the
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
REPEATS = 2   # timed f32 rollouts (median reported)
CODES_FRAMES = 60  # depth of the u16 + window rollout check
PROFILE_FRAMES = 40  # depth of the profiled f32 rollout
STRATEGY_REPEATS = 1  # rollout_strategies_f32: runs of each, in turn
PILLARS = 16  # round pillars of the FIFO phases' map (sparse regions)
FIFO_REPEATS = 2  # timed f32 map preps on the FIFO phases' map
MAPPREP_REPEATS = 2  # timed f32 wave map preps of the scene
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
    """Print the failure on standard output and on standard error (a
    caller that keeps only the end of either still reads it); exit 1."""
    print(f"FAILED: {msg}", flush=True)
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
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


def device_profile(fn, want=None, tries=3):
    """Run fn under torch.profiler, tracing the card's activities only
    (host-op tracing slows the host and the trace's processing, and its
    device events came back empty late in this long process); returns
    (wall_ms, {name: [count, device_us]}) of the device activities
    (kernels, copies) it ran.  With ``want`` (a test of those
    activities), fn runs and is profiled again, ``tries`` times in all,
    while the test fails: the profiler's device events can come back
    empty or short.  The last profile is returned either way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        if want is None or want(acts):
            break
    return wall, acts


def kernel_launches(acts, kernel):
    """The profiled launches of ``kernel`` in device_profile's acts."""
    return sum(v[0] for k, v in acts.items() if kernel in k)


def kernel_device_ms(acts, kernel="score_partials_kernel"):
    """Mean device ms per launch of ``kernel``, or None."""
    hits = [v for k, v in acts.items() if kernel in k]
    if not hits:
        return None
    n = sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3


def launch_floor_ms(reps=50, tries=3):
    """Device ms of the smallest launch: the profiler's mean time of a
    one-element PyTorch elementwise kernel (the profile taken again when
    its device events come back empty)."""
    import torch
    x = torch.zeros(1, device="cuda")
    x.add_(1.0)
    _w, acts = device_profile(
        lambda: [x.add_(1.0) for _ in range(reps)],
        lambda a: any(v[0] == reps for v in a.values()), tries)
    hits = [v for v in acts.values() if v[0] == reps]
    if not hits:
        fail(f"launch floor: no device kernel launched {reps} times in "
             f"{tries} profiles ({sorted(acts)})")
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
    counts, sums, err = partials_agree(got, want)
    if not counts:
        fail(f"{name}: kernel counts differ from the plain version")
    if not sums:
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


def partials_agree(got, want):
    """(counts equal, sums within RTOL/ATOL, max abs err of the sums) of
    two CalcScore results (sum_d, n_valid, sum_far, n_far)."""
    import torch
    counts = all(torch.equal(got[i], want[i]) for i in (1, 3))
    sums, err = True, 0.0
    for i in (0, 2):
        g, w = got[i].double(), want[i].double()
        if g.numel():
            err = max(err, float((g - w).abs().max()))
        sums = sums and torch.allclose(g, w, rtol=RTOL, atol=ATOL)
    return counts, sums, err


def record_partials(run, name="score_partials"):
    """Run ``run()`` with every launch of the CalcScore wrapper ``name``
    (score_partials or score_partials_batched) that the scorer makes
    recorded: its arguments and outputs, cloned on the card (no host
    sync inside a timed run; replay_partials moves them to the CPU);
    returns (result, calls).  A call on CPU tensors launches nothing and
    is not recorded."""
    import torch
    from lsdtpu_torch.match import associate as assoc
    wrapper = getattr(assoc, name)
    calls = []

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def rec(*args, **kw):
        before = wrapper.launches
        out = wrapper(*args, **kw)
        if wrapper.launches > before:
            calls.append(dict(name=name, args=tuple(map(clone, args)),
                              kw={k: clone(v) for k, v in kw.items()},
                              out=tuple(map(clone, out))))
        return out

    # the scorer reaches the kernel through match/associate.py's names;
    # the wrapper itself (and its launch count) stays as is
    setattr(assoc, name, rec)
    try:
        return run(), calls
    finally:
        setattr(assoc, name, wrapper)


def replay_partials(c):
    """One recorded CalcScore launch through the plain version on the
    CPU; returns partials_agree's (counts equal, sums within tier, err)."""
    import torch
    from lsdtpu_torch.ops import score as sc

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    want = getattr(sc, c["name"] + "_reference")(
        *map(cpu, c["args"]), **{k: cpu(v) for k, v in c["kw"].items()})
    return partials_agree(tuple(map(cpu, c["out"])), want)


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
    scalars, all_pix, ali_pix, (row0, n_rows) as given); returns (result,
    calls)."""
    import types
    from lsdtpu_torch.mapprep import nfa as mnfa
    onfa = mnfa.onfa
    calls = []

    def rec(deg_map, scalars, *block):
        out = onfa.rect_counts(deg_map, scalars, *block)
        calls.append((deg_map, scalars.clone(), out[0].clone(),
                      out[1].clone(), block))
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


def nfa_case(name, deg_map, scalars, reps, card, floor_ms, row0=0,
             n_rows=None):
    """The NFA kernel against its plain version on one recorded batch
    (or on rows [row0, row0 + H) of a field of true height n_rows):
    counts, times, bound."""
    import torch
    from lsdtpu_torch.ops import nfa as onfa
    got = onfa.rect_counts(deg_map, scalars, row0, n_rows)
    torch.cuda.synchronize()
    want = onfa.rect_counts_reference(deg_map, scalars, row0, n_rows)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"nfa {name}: kernel counts differ from the plain version")
    inside = onfa.rect_inside(deg_map, scalars, row0, n_rows)
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
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               row0=row0, n_rows="null" if n_rows is None else n_rows)
    dev_ms = profiled_ms(f"nfa {name}",
                         lambda: onfa.rect_counts(deg_map, scalars, row0,
                                                  n_rows), got,
                         "rect_counts_kernel")
    out["repeats_bitwise"] = 50
    out["kernel_ms"] = time_cuda(lambda: onfa.rect_counts(
        deg_map, scalars, row0, n_rows), reps)
    out["ms"] = out["kernel_ms"] if dev_ms is None else dev_ms
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: onfa.rect_counts_reference(deg_map, scalars, row0, n_rows),
        20)
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


def nfa_row_cases(calls, card, floor_ms):
    """nfa_case on row blocks of a recorded launch's field (the most
    covered one whose rectangles clear row 0), cut through its
    rectangles' rows (lo..hi): rows [mid, H) (row0 > 0, as a rank's
    block), and rows from lo, twice the rectangles' height (zero rows
    past the field), of a field whose true height n_rows ends inside
    them - the sharded map prep's launches."""
    import torch
    from lsdtpu_torch.ops import nfa as onfa
    def rows(c):
        """The rows its rectangles cover, or None."""
        ys = torch.nonzero(onfa.rect_inside(c[0], c[1]).any(0).any(1))
        return (int(ys.min()), int(ys.max())) if len(ys) else None

    # the most covered launch whose rectangles lie clear of the top row,
    # so that the blocks start at row0 > 0
    inner = [(int(c[2].sum()), i) for i, c in enumerate(calls)
             if (rows(c) or (0, 0))[0] > 0]
    most = max(inner)[1]
    deg_map, scalars = calls[most][0], calls[most][1]
    H, W = deg_map.shape
    lo, hi = rows(calls[most])
    mid = (lo + hi) // 2
    n_rows = mid + (hi - mid) // 2 + 1
    rows = 2 * (hi - lo + 1)
    cross = torch.zeros((rows, W), dtype=deg_map.dtype,
                        device=deg_map.device)
    take = deg_map[lo:lo + rows]
    cross[:take.shape[0]] = take
    return [nfa_case("row_block_from_mid", deg_map[mid:].contiguous(),
                     scalars, 200, card, floor_ms, row0=mid, n_rows=H),
            nfa_case("row_block_crossing_n_rows", cross, scalars, 200, card,
                     floor_ms, row0=lo, n_rows=n_rows)]


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


def _bounds(t_bytes, t_ops, t_chain, t_chain_old, **rest):
    """A queue kernel's bound, the largest of bytes, operations and its
    dependent chain, beside the bound with the serial kernels' chain
    ("_old": one on-chip load a pop or reducer point, one atan2 an
    accept)."""
    return dict(bound_ms=max(t_bytes, t_ops, t_chain),
                bound_by="bytes" if t_bytes >= max(t_ops, t_chain)
                else "operations", bound_kind="dependent chain",
                chain_bound_ms=t_chain, bytes_bound_ms=t_bytes,
                ops_bound_ms=t_ops,
                bound_old_ms=max(t_bytes, t_ops, t_chain_old),
                chain_bound_old_ms=t_chain_old, **rest)


def grow_bound(c, lat, sm_clock_hz):
    """The bound of one grow_fifo launch from this run's data.  The
    queue is serial, so its bound is the dependent chain, counted from
    what the walk must take one step after another: the seed's start
    angle (one atan2) and, per accepted pixel, one acceptance step - its
    add, its atan2 and the angle test of the next candidate against the
    new angle - at the latencies ``lat`` measured on this card
    (ops/grow.py:latency_probe) and the maximum SM clock.  A pop without
    an acceptance is parallel work (many are tested at once), so it
    counts in the operations.  Beside it, bytes (the cells the walk
    touches - the region and its 8-neighbour ring - read once as angle,
    sin, cos and ban; the region mask, queue, angle and counts written
    once) and operations; the bound is the largest of the three."""
    import torch.nn.functional as F
    cur = c["cur"]
    dt = str(c["deg"].dtype).split(".")[1]
    esize = c["deg"].element_size()
    n, pops, _passes = c["counts"].tolist()
    ring = F.max_pool2d(cur.float()[None, None], 3, 1, 1)[0, 0] > 0
    touched = int(ring.sum())
    nbytes = touched * (3 * esize + 1) + cur.numel() + 8 * n + 12 + esize
    ops = OPS_PER_POP * pops + OPS_PER_ACCEPT * (n - 1)
    load = min(lat["smem_load"], lat["l1_load"])
    return _bounds(
        nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dt] * 1e3,
        (lat[f"atan2_{dt}"] + (n - 1) * lat[f"accept_{dt}"])
        / sm_clock_hz * 1e3,
        (pops * load + n * lat[f"atan2_{dt}"]) / sm_clock_hz * 1e3,
        touched_cells=touched, pops=pops, accepted=n - 1)


def reduce_bound(c, lat, sm_clock_hz, dt):
    """The bound of one radius_reducer_fifo pass: the dependent chain of
    one load and distance test of the n points (all at once: a point's
    flag is a function of the point alone), then one bit scan - a
    dependent on-chip load - per 32-slot word of flags, as the walk takes
    them; beside it the n live queue entries read and written once, a
    mask cell written per removed point and the count, and the
    operations per point."""
    n = int(c["inputs"][2][0])
    removed = n - int(c["outputs"][2][0])
    nbytes = 16 * n + 2 * removed + 8
    load = min(lat["smem_load"], lat["l1_load"])
    return _bounds(
        nbytes / HBM_BYTES_PER_S * 1e3,
        OPS_PER_REDUCER_POINT * n / PEAK_OPS[dt] * 1e3,
        (lat["l1_load"] + lat[f"dist_{dt}"] + -(-n // 32) * lat["smem_load"])
        / sm_clock_hz * 1e3,
        n * load / sm_clock_hz * 1e3, points=n, removed=removed)


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
        return (g.cur.clone(), g.reg_deg, g.qy[:n].clone(), g.qx[:n].clone(),
                g.counts)

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



def maze_field(H, W, box, seed, dtype):
    """A level-line field on the card whose open cells (angle 0.1 +- 0.01,
    75% of the box (row, col, rows, cols)) grow into one large region and
    whose other cells, each one of six angles 0.9 apart (also from 0.1 and
    across the wrap), form small clusters: every decision under the
    threshold 0.4 is far from it, so the f32 region is exact too.  Returns
    (deg, sin, cos, ban, seed cell inside the box)."""
    import torch
    rng = np.random.default_rng(seed)
    y0, x0, h, w = box
    levels = np.array([-2.6, -1.7, -0.8, 1.0, 1.9, 2.8])
    deg = levels[rng.integers(0, 6, (H, W))]
    deg[y0:y0 + h, x0:x0 + w] = np.where(
        rng.random((h, w)) < 0.75, 0.1 + rng.normal(0, 0.01, (h, w)),
        levels[rng.integers(0, 6, (h, w))])
    sy, sx = y0 + h // 2, x0 + w // 2
    deg[sy, sx] = 0.1
    d = torch.from_numpy(deg.astype(dtype)).cuda()
    ban = torch.from_numpy(rng.random((H, W)) < 0.01).cuda()
    ban[sy, sx] = False
    return d, torch.sin(d), torch.cos(d), ban, (sy, sx)


FIFO_EDGE_THRE = 0.4
# (name, field H, W, the open box, seed): a region past the shared queue
# on the map-prep field (shared bitmap), and a region on a field whose
# bitmap exceeds the shared budget (global mask; it spills the queue too)
FIFO_EDGE_GROWS = (("grow_spill", 293, 432, (0, 0, 293, 432), 4),
                   ("grow_global_mask", 1600, 1600, (1420, 1390, 180, 150),
                    5))


def fifo_edge_cases(card):
    """The FIFO kernels past their shared-memory plans (ops/grow.py:
    grow_plan, reduce_plan), in f32 and f64, each held against its plain
    version bit for bit (reg_deg to the atan2 ulp the tests allow): the
    FIFO_EDGE_GROWS regions, and four reducer passes over each region's
    queue, longer than the reducer's shared slots (on the 1600 x 1600
    field its far flags too are past the budget, in a global buffer)."""
    import torch
    from lsdtpu_torch.ops import grow as og
    out = []
    for dt in (np.float32, np.float64):
        tol = 1e-12 if dt == np.float64 else 1e-5
        for name, H, W, box, seed in FIFO_EDGE_GROWS:
            d, s, c, ban, (sy, sx) = maze_field(H, W, box, seed, dt)
            plan = og.grow_plan(H, W)
            queue = og.fifo_queue(H, W, d.device)
            g = og.grow_fifo(sy, sx, FIFO_EDGE_THRE, ban, d, s, c, queue)
            n = int(g.counts[0])
            got = (g.cur.cpu(), g.qy[:n].cpu(), g.qx[:n].cpu(),
                   g.counts.cpu(), float(g.reg_deg))
            want = og.grow_fifo_reference(
                sy, sx, FIFO_EDGE_THRE, ban.cpu(), d.cpu(), s.cpu(), c.cpu(),
                og.fifo_queue(H, W, "cpu"))
            rd = abs(got[4] - float(want.reg_deg))
            same = (torch.equal(got[0], want.cur)
                    and torch.equal(got[1], want.qy[:n])
                    and torch.equal(got[2], want.qx[:n])
                    and torch.equal(got[3], want.counts))
            case = dict(name=f"{name}_{np.dtype(dt).name}", field=(H, W),
                        region=n, pops=int(got[3][1]),
                        shared_mask=plan.shared_mask,
                        queue_cap=plan.queue_cap,
                        spilled=max(0, n - plan.queue_cap),
                        same=same, reg_deg_diff=rd,
                        ms=time_cuda(lambda: og.grow_fifo(
                            sy, sx, FIFO_EDGE_THRE, ban, d, s, c, queue), 5),
                        ms_source="cuda events")
            phase("grow_kernel_check", **case, card=card)
            out.append(case)
            if not same or rd > tol or case["spilled"] == 0 or (
                    name == "grow_global_mask") == plan.shared_mask:
                fail(f"grow_fifo {case['name']}: not the plain version's "
                     f"region or not past the shared plan ({case})")
            rplan = og.reduce_plan(g.qy.numel())
            dev = (g.qy.clone(), g.qx.clone(), g.counts[:1].clone(),
                   g.cur.clone(), g.cur.clone())
            cpu = tuple(t.cpu() for t in dev)
            rad, same, left = dt(160.0), True, []
            for _ in range(4):
                rad = rad * dt(0.75)
                og.radius_reducer_fifo(sx, sy, rad, *dev)
                og.radius_reducer_fifo_reference(sx, sy, rad, *cpu)
                left.append(int(cpu[2]))
                same = same and int(dev[2]) == int(cpu[2]) and all(
                    torch.equal(a[:n].cpu(), b[:n])
                    for a, b in zip(dev[:2], cpu[:2])) and all(
                    torch.equal(a.cpu(), b) for a, b in zip(dev[3:], cpu[3:]))
            rcase = dict(name=f"reducer_{name[5:]}_{np.dtype(dt).name}",
                         points=n, shared_slots=rplan.cap,
                         shared_flags=rplan.shared_flags, left=left,
                         same=same)
            phase("grow_kernel_check", **rcase, card=card)
            out.append(rcase)
            if not same or n <= rplan.cap or left[-1] >= n:
                fail(f"radius_reducer_fifo {rcase['name']}: not the plain "
                     f"version's outputs or not past the shared slots "
                     f"({rcase})")
    return out


def fifo_map_summary(grows, reduces, acts, lat, clock, card):
    """Over one recorded FIFO map prep and the profile of the same map
    prep: each kernel's launches, mean and summed device ms, and the sum
    of its per-launch bounds (grow_bound, reduce_bound) beside it, and
    the sum of the bounds with the serial kernels' chain ("_old").  The
    profiler can drop a few of a long profile's device events (25 of
    2876 grow_fifo launches in one run): the summed device ms is the
    profiled launches' mean times the recorded launches, and the line
    says how many it dropped.  The wrappers' counts hold the launches
    themselves (mapprep_fifo_f32)."""
    out = {}
    for name, kernel, calls in (
            ("grow_fifo", "grow_fifo_kernel", grows),
            ("radius_reducer_fifo", "radius_reducer_fifo_kernel", reduces)):
        hits = [v for k, v in acts.items() if kernel in k]
        launches = sum(h[0] for h in hits)
        if not 0 < launches <= len(calls):
            fail(f"{name}: {launches} profiled launches for {len(calls)} "
                 "recorded calls of the same map prep")
        mean_ms = sum(h[1] for h in hits) / 1e3 / launches
        if name == "grow_fifo":
            bounds = [grow_bound(c, lat, clock) for c in calls]
        else:
            bounds = [reduce_bound(c, lat, clock, "float32") for c in calls]
        bound_sum = sum(b["bound_ms"] for b in bounds)
        out[name] = dict(launches=launches, recorded=len(calls),
                         profiler_dropped=len(calls) - launches,
                         mean_ms=mean_ms, device_ms=mean_ms * len(calls),
                         bound_sum_ms=bound_sum,
                         over_bound_ms=mean_ms * len(calls) - bound_sum,
                         bound_sum_old_ms=sum(b["bound_old_ms"]
                                              for b in bounds))
        phase("grow_kernel_check", map="f32", kernel=name, **out[name],
              card=card)
    return out

# --- the streaming entry point (slice 5) -------------------------------

CHECKPOINT_AFTER = 140  # online_f32 saves its session after this frame
POLISH_FRAMES = 30      # depth of the f64 polish check, card vs CPU
LEGACY_F64_FRAMES = 140  # depth of the f64 legacy check, card vs CPU
SCAN_INC = 2.0 * np.pi / 360  # the raycaster's ray step (360 rays)
CKPT_REPEATS = 3        # checkpoint_dcp: timed saves and loads (median)
BATCH_CKPT_AFTER = 50   # checkpoint_dcp: the batch's checkpoint frame


def same_state(a, b):
    """The first field in which two TrackStates differ in dtype, shape,
    device or any bit, or None."""
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x.dtype, x.shape, x.device) != (y.dtype, y.shape, y.device):
            return f.name
        if x.is_floating_point():
            view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                x.element_size()]
            x, y = x.view(view), y.view(view)
        if not torch.equal(x, y):
            return f.name
    return None


def dcp_timed(path, state, device):
    """save_state_dcp of ``state`` at ``path`` CKPT_REPEATS times (each
    replacing the last), then load_state_dcp onto ``device`` as often:
    (median save ms, median load ms, bytes on disk, the last load)."""
    import torch
    from lsdtpu_torch.runtime.checkpoint import load_state_dcp, save_state_dcp
    save, load = [], []
    for _ in range(CKPT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state_dcp(path, state)
        save.append((time.perf_counter() - t0) * 1e3)
    for _ in range(CKPT_REPEATS):
        t0 = time.perf_counter()
        back = load_state_dcp(path, device=device)
        torch.cuda.synchronize()
        load.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(os.path.getsize(os.path.join(path, n))
                 for n in os.listdir(path))
    return float(np.median(save)), float(np.median(load)), nbytes, back


def step_loop(state, fr, ctx, cfg, frames):
    """loop.rollout's plain loop from ``state`` over ``frames`` of fr
    (stacked frames on the device, frame axis first): the state after
    the last frame and the outputs as numpy arrays, frame axis first."""
    import torch
    from lsdtpu_torch.runtime import loop
    coarse = loop.prepare_coarse(ctx, cfg)
    outs = []
    for f in frames:
        fr_f = {k: v[f] for k, v in fr.items()}
        state = loop.reset_carry(state, fr_f)
        state, out = loop.localization_step(
            state, tuple(fr_f[k] for k in loop._FRAME_KEYS), ctx, cfg,
            coarse=coarse)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                   for k in outs[0]}


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
    checkpoint after CHECKPOINT_AFTER frames resumed in a fresh session;
    then checkpoint_dcp: the same state through save_state_dcp (timed),
    loaded onto the card bitwise the npz's, and a session with the npz's
    odometry anchor and the DCP state resuming bitwise.  Returns the
    CalcScore launches of the streamed run."""
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
    held = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ckpt_dcp = f"{tmp}/session.npz", f"{tmp}/session.dcp"

        def save(f):
            if f + 1 == CHECKPOINT_AFTER:
                loc.save(ckpt)
                held["dcp"] = dcp_timed(ckpt_dcp, loc.state, device)

        sc.score_partials.launches = 0
        got, lat = stream(push(loc), scans, ds, range(F), after=save)
        launches = sc.score_partials.launches
        resumed = session()
        resumed.restore(ckpt)
        bad = same_state(held["dcp"][3], resumed.state)
        if bad is not None:
            fail(f"checkpoint_dcp: the DCP state's {bad} differs from the "
                 "npz-restored state")
        tail, _ = stream(push(resumed), scans, ds,
                         range(CHECKPOINT_AFTER, F))
        # the npz gives the session its odometry anchor, DCP its state
        from_dcp = session()
        from_dcp.restore(ckpt)
        from_dcp.state = held["dcp"][3]
        tail_dcp, _ = stream(push(from_dcp), scans, ds,
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
    diff = first_difference(tail_dcp, ref, keys)
    if diff is not None:
        fail(f"checkpoint_dcp: frame {CHECKPOINT_AFTER + diff} resumed from "
             "the DCP state differs from the uninterrupted session")
    save_ms, load_ms, nbytes, _ = held["dcp"]
    phase("checkpoint_dcp", case="'session'", card=repr(smi), ranks=1,
          dtype="'float32'", after_frame=CHECKPOINT_AFTER, bytes=nbytes,
          save_ms=save_ms, load_ms=load_ms, repeats=CKPT_REPEATS,
          state_vs_npz="bitwise", resumed_frames=F - CHECKPOINT_AFTER,
          resume="bitwise")
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
    adapter's artifacts: the same first-minimum pose on each of the first
    LEGACY_F64_FRAMES frames.
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
            scans, ds, range(LEGACY_F64_FRAMES))[0])
        secs.append(round(time.perf_counter() - t0, 2))
    a, b = runs
    F = LEGACY_F64_FRAMES
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
BATCH_REPEATS = 1      # batch_f32: timed runs at each B (median reported)
BATCH_F64_LANES = 4    # batch_f32: f64 lanes against their solo rollouts
PROFILE_LANES = 16     # batch_f32: the profiled batch (10 frames)
STRATEGY_LANES = (16, 64)      # batch_f32: B also timed under prefeaturize
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
    _w, acts = device_profile(lambda: [fn() for _ in range(reps)],
                              lambda a: kernel_launches(a, kernel), tries)
    hits = [v for k, v in acts.items() if kernel in k]
    return sum(h[1] for h in hits) / reps / 1e3 if hits else None


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


def host(out):
    """A rollout's outputs as numpy arrays (the read that ends a run)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def strategy_runs(runs, reps):
    """Timed runs to value of each of ``runs`` ({name: a call returning
    numpy outputs}) in turn (A B C A B C ...), ``reps`` rounds: per name
    the ms of each run, its CalcScore launches (single-lane, batched),
    its RDP host rounds, the most device memory allocated above what was
    resident before it, and the resident bytes.  Fails unless every run
    equals the first run of the first name bit for bit.  Returns (stats,
    that first run's outputs)."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.scan import featurize as fz
    stats = {n: dict(ms=[], launches=[], rounds=[], peak=0, resident=0)
             for n in runs}
    want = None
    for _ in range(reps):
        for name, run in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            sc.score_partials.launches = 0
            sc.score_partials_batched.launches = 0
            fz._rdp_rounds.rounds = 0
            t0 = time.perf_counter()
            out = run()
            ms = (time.perf_counter() - t0) * 1e3
            st = stats[name]
            st["ms"].append(ms)
            st["launches"].append((sc.score_partials.launches,
                                   sc.score_partials_batched.launches))
            st["rounds"].append(fz._rdp_rounds.rounds)
            st["peak"] = max(st["peak"],
                             torch.cuda.max_memory_allocated() - resident)
            st["resident"] = resident
            if want is None:
                want = out
            elif same_outputs(out, want) is not None:
                fail(f"{name}: output {same_outputs(out, want)!r} differs "
                     "from the default loop's")
    return stats, want


def strategy_line(tag, st, base_ms, scans, smi, kind, **kw):
    """One strategy's phase line: time to value, scans/s, RDP host rounds
    and launches a run, peak memory above the resident bytes."""
    med = float(np.median(st["ms"]))
    phase(tag, device=repr(kind), power=repr(smi), **kw, median_ms=med,
          min_ms=min(st["ms"]), max_ms=max(st["ms"]),
          runs=repr([round(t, 1) for t in st["ms"]]),
          scans_per_s=scans / med * 1e3, vs_default=med / base_ms,
          rdp_rounds=st["rounds"][0], score_launches=st["launches"][0],
          peak_mib=st["peak"] / 2**20, resident_mib=st["resident"] / 2**20,
          bitwise_default=True)


def rollout_strategies(fr32, fr32_dev, ctx32, cfg, device, smi, kind):
    """rollout_strategies_f32: the 279-frame f32 rollout under each
    execution strategy (the default loop, the default with the frames on
    the host, prefeaturize, scan_unroll 8 with and without the batched
    featurize, scan_unroll 32), STRATEGY_REPEATS runs each in turn, each
    bitwise the default's, one CalcScore launch a frame; then the first
    PROFILE_FRAMES frames under prefeaturize through the profiler.
    Returns (the CalcScore launches of the timed runs, {strategy: median
    ms})."""
    from lsdtpu_torch.runtime import loop
    F = fr32["ranges"].shape[0]

    def run(frames, **strategy):
        c = dataclasses.replace(cfg, **strategy)
        return lambda: host(loop.run_sequence(frames, ctx32, c,
                                              device=device))

    stats, _ = strategy_runs({
        "default": run(fr32_dev),
        "default_host_frames": run(fr32),
        "prefeaturize": run(fr32_dev, prefeaturize=True),
        "unroll8": run(fr32_dev, scan_unroll=8),
        "unroll8_per_frame": run(fr32_dev, scan_unroll=8,
                                 scan_unroll_batch_featurize=False),
        "unroll32": run(fr32_dev, scan_unroll=32)}, STRATEGY_REPEATS)
    base = float(np.median(stats["default"]["ms"]))
    total = 0
    for name, st in stats.items():
        if any(n != (F, 0) for n in st["launches"]):
            fail(f"rollout_strategies_f32 {name}: (single, batched) "
                 f"CalcScore launches {st['launches']} for {F} frames")
        total += sum(n for n, _ in st["launches"])
        strategy_line("rollout_strategies_f32", st, base, F, smi, kind,
                      strategy=name, frames=F)
    c = dataclasses.replace(cfg, prefeaturize=True)
    fr_prof = {k: v[:PROFILE_FRAMES] for k, v in fr32_dev.items()}
    wall, acts = device_profile(
        lambda: loop.run_sequence(fr_prof, ctx32, c, device=device))
    busy = sum(v[1] for v in acts.values()) / 1e3
    phase("rollout_strategies_f32_profile", card=repr(smi),
          strategy="prefeaturize", frames=PROFILE_FRAMES, wall_ms=wall,
          device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
          device_ops_per_frame=sum(v[0] for v in acts.values())
          / PROFILE_FRAMES)
    return total, {n: float(np.median(st["ms"])) for n, st in stats.items()}


def lane_dataset(ds, offset, frames):
    """The frames [offset, offset + frames) of a sequence as a dataset."""
    return dataclasses.replace(ds, frames=ds.frames[offset:offset + frames],
                               odom=ds.odom[offset:offset + frames + 1])


def batch_rollouts(maps, cfg, device, smi, kind):
    """batch_f32: run_batch over BATCH_SIZES lanes of BATCH_FRAMES frames,
    the lanes alternating between the two maps, each from its own frame
    offset, BATCH_REPEATS timed runs at each B, at STRATEGY_LANES in turn
    with as many under prefeaturize, bitwise the default's
    (rollout_strategies_batch_f32); then BATCH_F64_LANES lanes in f64
    against their solo run_sequence on the card.  maps: [(scene, lines,
    field)].  Returns the batched CalcScore launches of the timed default
    and prefeaturize runs."""
    import torch
    from lsdtpu_torch.runtime import batch, loop
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

    total = strategy_total = 0
    for B in BATCH_SIZES:
        _d, fr, ctxs = lanes(B, np.float32)
        cfgs = {"default": cfg}
        if B in STRATEGY_LANES:
            cfgs["prefeaturize"] = dataclasses.replace(cfg, prefeaturize=True)
        runs = {}
        for name, c in cfgs.items():
            batch.run_batch({k: v[:, :3] for k, v in fr.items()}, ctxs, c,
                            device=device)                      # warm-up
            runs[name] = (lambda c: lambda: host(batch.run_batch(
                fr, ctxs, c, device=device)))(c)
        stats, res = strategy_runs(runs, BATCH_REPEATS)
        st = stats["default"]
        times = st["ms"]
        wall = float(np.median(times))
        launches = sum(n for _, n in st["launches"])
        if any(n != (0, F) for n in st["launches"]):
            fail(f"batch_f32 B={B}: (single, batched) CalcScore launches "
                 f"{st['launches']} for {BATCH_REPEATS} runs of {F} frames")
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
              rdp_rounds_per_frame=sum(st["rounds"]) / (F * BATCH_REPEATS),
              tracked=int(tracked.sum()), of=B * F)
        if "prefeaturize" in stats:
            st = stats["prefeaturize"]
            if any(n != (0, F) for n in st["launches"]):
                fail(f"rollout_strategies_batch_f32 B={B}: (single, "
                     f"batched) CalcScore launches {st['launches']}")
            strategy_total += sum(n for _, n in st["launches"])
            strategy_line("rollout_strategies_batch_f32", st, wall, B * F,
                          smi, kind, strategy="prefeaturize", lanes=B,
                          frames=F, default_rdp_rounds=stats["default"][
                              "rounds"][0],
                          default_peak_mib=stats["default"]["peak"] / 2**20)
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
            batch_checkpoint(fr, ctxs, cfg, res, device, smi)
        del fr, ctxs, runs, res
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
    return total, strategy_total


def batch_checkpoint(fr, ctxs, cfg, want, device, smi):
    """checkpoint_dcp of a batch: batch_f32's lanes through the rollout's
    plain loop step by step (bitwise the run's outputs ``want``),
    checkpointed after BATCH_CKPT_AFTER frames as npz and DCP: the DCP
    state bitwise the npz's, and from it the remaining frames bitwise
    the run's; then the state at the end of the run saved and loaded
    (timed) bitwise."""
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.checkpoint import (load_state,
                                                 load_state_dcp, save_state,
                                                 save_state_dcp)
    fr = {k: v.transpose(0, 1).contiguous() for k, v in fr.items()}
    F, B = fr["ranges"].shape[:2]
    bcfg = loop.batched_cfg(cfg)
    mid, head = step_loop(loop.init_state(fr["ranges"].dtype, device,
                                          lanes=B),
                          fr, ctxs, bcfg, range(BATCH_CKPT_AFTER))
    with tempfile.TemporaryDirectory() as tmp:
        npz, ck = f"{tmp}/lanes.npz", f"{tmp}/lanes.dcp"
        save_state(npz, mid)
        save_state_dcp(ck, mid)
        got = load_state_dcp(ck, device=device)
        for other, what in ((load_state(npz, device=device), "npz-restored"),
                            (mid, "saved")):
            bad = same_state(got, other)
            if bad is not None:
                fail(f"checkpoint_dcp lanes{B}: the DCP state's {bad} "
                     f"differs from the {what} state")
        end, tail = step_loop(mid, fr, ctxs, bcfg,
                              range(BATCH_CKPT_AFTER, F))
        whole = {k: np.concatenate([head[k], tail[k]]).swapaxes(0, 1)
                 for k in head}
        bad = same_outputs(whole, want)
        if bad is not None:
            fail(f"checkpoint_dcp lanes{B}: the step loop's {bad} differs "
                 "from run_batch's")
        end_dcp, tail_dcp = step_loop(got, fr, ctxs, bcfg,
                                      range(BATCH_CKPT_AFTER, F))
        bad = same_outputs(tail_dcp, tail) or same_state(end_dcp, end)
        if bad is not None:
            fail(f"checkpoint_dcp lanes{B}: resumed from the DCP state, "
                 f"{bad} differs from the uninterrupted run")
        save_ms, load_ms, nbytes, back = dcp_timed(f"{tmp}/end.dcp", end,
                                                   device)
    bad = same_state(back, end)
    if bad is not None:
        fail(f"checkpoint_dcp lanes{B}: the end state's {bad} differs after "
             "the round trip")
    phase("checkpoint_dcp", case=f"'lanes{B}'", card=repr(smi), ranks=1,
          dtype=repr(str(fr["ranges"].dtype)[6:]), lanes=B, frames=F,
          bytes=nbytes, save_ms=save_ms, load_ms=load_ms,
          repeats=CKPT_REPEATS, steps_vs_run_batch="bitwise",
          after_frame=BATCH_CKPT_AFTER, state_vs_npz="bitwise",
          resumed_frames=F - BATCH_CKPT_AFTER, resume="bitwise",
          end_state="bitwise")


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
        # (run again, three times in all, while the trace's device
        # events come back empty)
        trace = os.path.join(tmp, "trace")
        path = os.path.join(trace, "trace.json")
        for _ in range(3):
            recs, _err, launches, secs = cli_call(
                "cli_profile", ["profile", *common, "--frames",
                                str(CLI_FRAMES_PROFILE), "--repeats", "2",
                                "--trace", trace])
            need_launches("cli_profile", launches, ("score_partials",))
            with open(path) as fh:
                has_kernel = "score_partials_kernel" in fh.read()
            if has_kernel:
                break
        by_path["cli_profile"] = launches
        stages, steady = recs
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

        # --- the numpy oracle's map prep, then the bench entry point
        by_path["oracle_mapprep"] = oracle_mapprep(ds, common, cache_dir,
                                                   device, smi, kind)
        by_path["bench"] = bench_phase(data, os.path.join(tmp, "bench"),
                                       device, smi, kind)
        return by_path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def oracle_mapprep(ds, common, cache_dir, device, smi, kind):
    """oracle_mapprep: `prepare-map --mapprep oracle` through the CLI and
    OnlineLocalizer(mapprep="oracle").set_map on the card give exactly
    the numpy oracle's lines and field (f64 in the CLI's cache, f32 in
    the session), then a streaming pass over them tracks every frame.
    Returns the kernels' launches of the CLI call and the pass."""
    import torch
    from lsdtpu_torch.oracle import driver as odrv
    from lsdtpu_torch.runtime.artifacts import prepare_map_cached
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    p = ds.param
    F = len(ds.frames)
    t0 = time.perf_counter()
    want = odrv.prepare_map(ds.map_value, p.resol)
    host_ms = (time.perf_counter() - t0) * 1e3
    n_want = len(want.lines_info)

    recs, _err, launches, secs = cli_call(
        "oracle_mapprep", ["prepare-map", *common, "--mapprep", "oracle"])
    lines, cache = prepare_map_cached(ds.map_value, p.resol,
                                      cache_dir=cache_dir,
                                      dtype=torch.float64, device=device,
                                      backend="oracle")
    if not (recs[0]["lines"] == n_want and lines.device.type == "cuda"
            and torch.equal(lines.cpu(), torch.from_numpy(want.lines_info))
            and torch.equal(cache.cpu(), torch.from_numpy(want.map_cache))):
        fail(f"oracle_mapprep: `prepare-map --mapprep oracle` gave "
             f"{recs[0]['lines']} lines, not the oracle's {n_want} lines "
             "and field")

    loc = OnlineLocalizer(dtype=np.float32, device=device, mapprep="oracle")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = loc.set_map(ds.map_value, p.resol, p.ori_x, p.ori_y)
    torch.cuda.synchronize()
    set_map_ms = (time.perf_counter() - t0) * 1e3
    f32 = torch.float32
    if not (n == n_want and torch.equal(
            loc.ctx.lines[:n].cpu(),
            torch.from_numpy(want.lines_info).to(f32))
            and torch.equal(loc.ctx.cache.cpu(),
                            torch.from_numpy(want.map_cache).to(f32))):
        fail("oracle_mapprep: OnlineLocalizer(mapprep='oracle').set_map "
             "differs from the oracle's arrays cast to float32")
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    got, lat = stream(lambda fr, odom: loc.push_scan(fr[:, 0], fr[:, 1],
                                                     odom),
                      ds.frames, ds, range(F))
    for k, w in wrappers.items():
        launches[k] += w.launches
    tracked = int((np.isfinite(got["score"])
                   & ~np.isnan(got["pose"]).any(1)).sum())
    if tracked != F or launches["score_partials"] != F:
        fail(f"oracle_mapprep: the streaming pass tracked {tracked}/{F} "
             f"with launches {launches}")
    phase("oracle_mapprep", device=repr(kind), power=repr(smi),
          lines=n, oracle_host_ms=host_ms, cli_prepare_map_s=secs,
          set_map_ms=set_map_ms, cli_lines_field_equal=True,
          session_lines_field_equal_f32=True, scans=F, tracked=tracked,
          **latency_stats(lat), launches=repr(launches))
    return launches


# bench.py's JSON keys (its result_json and the extras of the final line)
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "n_repeats", "median_ms",
    "min_ms", "max_ms", "max_scans_per_sec", "baseline_scans_per_sec",
    "baseline_kind", "baseline_reset_frames", "baseline_note", "backend",
    "method", "ate_rmse_m", "tracked", "frames")


BENCH_REPEATS = (1, 1)  # bench: its timed and frames-on-the-card repeats


def bench_phase(data, cache_dir, device, smi, kind):
    """bench: lsdtpu_torch.bench.main over the dataset directory, in this
    process, at BENCH_REPEATS (the entry point's REPEATS and
    RESIDENT_REPEATS, 5 and 3, cut for the run's time), every kernel's
    launch count set to 0 just before and read just after; its JSON line
    holds bench.py's keys, every frame tracked, and each of its rollouts
    equals a plain run_sequence on the same data and config bit for
    bit.  Returns the launches."""
    import torch
    from lsdtpu_torch import bench
    from lsdtpu_torch.io import loaders
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.artifacts import prepare_map_cached

    poses = []
    run_sequence = loop.run_sequence

    def recording(*a, **k):
        out = run_sequence(*a, **k)
        poses.append(out["pose"].clone())
        return out

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out, err = io.StringIO(), io.StringIO()
    loop.run_sequence = recording
    depth = bench.REPEATS, bench.RESIDENT_REPEATS
    bench.REPEATS, bench.RESIDENT_REPEATS = BENCH_REPEATS
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(data=data, device=device.type,
                            cache_dir=cache_dir)
        rollouts = 1 + bench.REPEATS + 1 + bench.RESIDENT_REPEATS
    finally:
        loop.run_sequence = run_sequence
        bench.REPEATS, bench.RESIDENT_REPEATS = depth
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or len(lines) != 1:
        fail(f"bench: exit {rc}, {len(lines)} JSON lines: "
             f"{err.getvalue()[-2000:]}")
    rec = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing or rec["backend"] != "cuda":
        fail(f"bench: keys {missing} missing or backend {rec['backend']!r}")
    ds = loaders.load_dataset(data)
    F = len(ds.frames)
    if not rec["tracked"] == rec["frames"] == F:
        fail(f"bench: tracked {rec['tracked']} of {rec['frames']} frames")
    if rec["baseline_kind"] not in ("oracle", "cpp-reference"):
        fail(f"bench: baseline_kind {rec['baseline_kind']!r}")
    if len(poses) != rollouts or launches["score_partials"] != F * rollouts:
        fail(f"bench: {len(poses)} rollouts (expected {rollouts}), "
             f"launches {launches}")
    lines_t, cache_t = prepare_map_cached(
        ds.map_value, ds.param.resol, cache_dir=cache_dir,
        dtype=torch.float64, device="cpu", backend="oracle")
    ctx = loop.make_map_context(lines_t, cache_t, ds.param.resol,
                                ds.param.ori_x, ds.param.ori_y,
                                dtype=np.float32, device=device)
    want = run_sequence(loop.stack_frames(ds, dtype=np.float32), ctx,
                        bench.bench_cfg(), device=device)["pose"]
    same = [torch.equal(p_, want) for p_ in poses]
    if not all(same):
        fail(f"bench: rollouts {[i for i, s in enumerate(same) if not s]} "
             "differ from a plain run_sequence")
    phase("bench", device=repr(kind), power=repr(smi),
          scans_per_s=rec["value"], median_ms=rec["median_ms"],
          min_ms=rec["min_ms"], max_ms=rec["max_ms"],
          vs_baseline=rec["vs_baseline"],
          baseline_scans_per_s=rec["baseline_scans_per_sec"],
          baseline_kind=repr(rec["baseline_kind"]),
          device_resident_ms=rec.get("device_resident_ms"),
          ate_rmse_m=rec["ate_rmse_m"], tracked=rec["tracked"], frames=F,
          card=repr(rec["card"]), power_limit=repr(rec["power_limit"]),
          rollouts=rollouts, poses_equal_run_sequence=True,
          seconds=round(seconds, 2), launches=repr(launches))
    return launches


MULTI_FRAMES = 100       # multi_world1: frames a lane (2 lanes, f64)
RANK_FRAMES = 60         # multi_two_ranks: frames of the tp/mp/pipeline runs
RANK_POOL_TICKS = 5      # multi_two_ranks: ticks of the 2 x 8 slot pool
RANK_TIMEOUT_S = 600     # multi_two_ranks: the spawned group's join timeout
PARALLEL_FRAMES = 12     # tests/test_runtime_parallel.py's NF (tier 1e-9 px)
# multi_two_ranks: the tp/mp poses' tier over RANK_FRAMES.  On the CPU
# over gloo the same 60 frames drift 9.6e-10 px (tp) and 8.4e-10 px (mp)
# from run_sequence (scripts/torch_sharded_drift.py), 5.7e-10 and
# 8.4e-10 px in the first 12: ulps of another summation order reach
# ~1e-9 px on this scene within 12 frames; a decade above that
RANK_TIER_PX = 1e-8
# multi_temporal: (S, warmup): the reference's default warmup of 24 at
# S = 8 (segments of 35 frames); 12 at S = 16 (segments of 18 frames)
TEMPORAL_CASES = ((8, 24), (16, 12))
MAX_ERR_PX = 6.0         # tests/test_temporal.py's documented tolerance
MEAN_ERR_PX = 1.0
LSD_TIER = dict(rtol=1e-4, atol=1e-3)   # tests/test_lsd_sharded.py


def lsd_scene():
    """The smaller map of the sharded LSD check (245x360 cells at 0.05 m,
    a sixteenth of data1's cells; 31 lines): each host read of the
    walk costs one to three collectives over gloo."""
    from lsdtpu_torch.io import synth
    return synth.synth_dataset(1, F=2, H=245, W=360, resol=0.05, rmax=13.0,
                               n_walls=20, clear_m=1.5, wall_scale=1.0)


def same_outputs(a, b):
    """Two output dicts equal bit for bit (NaN where NaN)."""
    import torch
    for k in b:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        if x.shape != y.shape or not torch.equal(x.isnan() if
                                                 x.is_floating_point() else x,
                                                 y.isnan() if
                                                 y.is_floating_point() else y):
            return k
        if x.is_floating_point() and not torch.equal(x.nan_to_num(),
                                                     y.nan_to_num()):
            return k
    return None


def counted(fn):
    """(fn(), {kernel: launches}, seconds) with every wrapper's count set
    to 0 just before and read just after."""
    import torch
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res, {k: w.launches for k, w in wrappers.items()}, \
        time.perf_counter() - t0


def multi_world1(scene, lines, cache64, scene_p, pillar, cfg, device, smi):
    """multi_world1: the sharded rollouts over one rank (this process,
    NCCL) on two lanes of the two maps, each bitwise run_batch; the pod
    mesh of one host.  Returns {path: launches}."""
    import torch.distributed as dist
    from lsdtpu_torch.runtime import batch, distributed, shard
    dss = [lane_dataset(scene.dataset, 0, MULTI_FRAMES),
           lane_dataset(scene_p.dataset, 0, MULTI_FRAMES)]
    frames, ctxs, lens = batch.stack_batch(
        dss, [(lines, cache64), pillar], cfg, dtype=np.float64,
        device=device)
    distributed.ensure_group(device)
    want, l_ref, s_ref = counted(lambda: batch.run_batch(frames, ctxs, cfg,
                                                         device=device))
    paths = {}
    for tag, run, mesh in (
            ("multi_world1_tp", shard.run_batch_sharded,
             shard.make_mesh(device=device)),
            ("multi_world1_mp", shard.run_batch_sharded_mapblocks,
             shard.make_mesh_mp(device=device))):
        got, launches, secs = counted(lambda: run(frames, ctxs, mesh, cfg,
                                                  device=device))
        bad = same_outputs(got, want)
        if bad is not None:
            fail(f"{tag}: {bad} differs from run_batch on one rank")
        if launches["score_partials_batched"] != MULTI_FRAMES:
            fail(f"{tag}: launches {launches}")
        paths[tag] = launches
        phase(tag, card=repr(smi), lanes=len(dss), frames=MULTI_FRAMES,
              mesh=repr(tuple(mesh.shape)), backend=repr(dist.get_backend()),
              bitwise_run_batch=True, seconds=round(secs, 2),
              run_batch_seconds=round(s_ref, 2), launches=repr(launches))
    pod = distributed.make_pod_mesh(device=device)
    if tuple(pod.shape) != (1, 1) or pod.mesh_dim_names != ("dp", "tp"):
        fail(f"multi_world1: pod mesh {pod}")
    phase("multi_world1_pod", mesh=repr(tuple(pod.shape)),
          names=repr(pod.mesh_dim_names))
    return paths


def multi_prep(scene, cache64, device, smi):
    """multi_prep: the block-built distance field and the slab-sharded
    LSD prologue over one rank with 4 blocks, bitwise their single-card
    counterparts."""
    import math
    import torch
    from lsdtpu_torch.mapprep import distance_sharded, lsd_sharded
    from lsdtpu_torch.mapprep.gaussian import gaussian_sampler
    from lsdtpu_torch.mapprep.gradient import gradient_field
    grid = scene.dataset.map_value
    p = scene.dataset.param
    t0 = time.perf_counter()
    field = distance_sharded.create_map_cache_sharded(
        grid, p.resol, 1.0, blocks_per_device=4, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not torch.equal(field, cache64):
        fail("multi_prep: the block-built field differs from "
             "create_map_cache")
    deg_thre = 22.5 / 180.0 * math.pi
    for dt in (torch.float32, torch.float64):
        rm, *got, _shape = lsd_sharded.prologue_sharded(
            grid, 0.3, 0.6, deg_thre, blocks_per_device=4, dtype=dt,
            device=device)
        g = torch.from_numpy(rm).to(device, dt)
        want = gradient_field(gaussian_sampler(g, 0.3, 0.6), deg_thre)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"multi_prep: the sharded prologue ({dt}) differs from "
                 "the unsharded one")
    phase("multi_prep", card=repr(smi), blocks=4, field_bitwise=True,
          prologue_bitwise="f32, f64", field_seconds=round(secs, 3))


def row_block_case(name, scene, lines, cache64, cfg, device, card, floor_ms,
                   dtype):
    """The lane-batched CalcScore launch of an mp rank: two lanes (the
    relock frame, a tracking frame), unpruned, over the rows
    [row0, row0 + H/2) of the field (rank 1 of mp = 2): against its plain
    version, the two blocks' counts adding up to the whole field's,
    device ms, plain ms, bound and floor."""
    import torch
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import batch, loop
    p = scene.dataset.param
    ctx = loop.make_map_context(lines, cache64, p.resol, p.ori_x, p.ori_y,
                                dtype=dtype, device=device)
    lanes = [lane_frame_args(scene, ctx, cfg, device, f, False)
             for f in (0, 1)]
    canvas = batch.batch_context([(lines, cache64)] * 2,
                                 [(p.resol, p.ori_x, p.ori_y)] * 2, cfg,
                                 dtype=dtype, device=device)
    H = canvas.cache.shape[1]
    bh = -(-H // 2)
    z, pen = cfg.map.z_occ_max_dis, cfg.match.max_dist_penalty
    feats, px, py = (torch.stack([ln[i] for ln in lanes]).contiguous()
                     for i in (0, 3, 4))
    n, n_pix = (torch.cat([ln[i] for ln in lanes]).contiguous()
                for i in (2, 5))
    blocks = [canvas.cache[:, r:r + bh].contiguous() for r in (0, bh)]
    args = [(feats, None, n, px, py, n_pix, blk, canvas.rows, canvas.cols,
             z, pen, z) for blk in blocks]
    got = [sc.score_partials_batched(*a, row0=r) for a, r in
           zip(args, (0, bh))]
    torch.cuda.synchronize()
    want = sc.score_partials_batched_reference(*args[1], row0=bh)
    whole = sc.score_partials_batched(feats, None, n, px, py, n_pix,
                                      canvas.cache, canvas.rows, canvas.cols,
                                      z, pen, z)
    for i in (1, 3):
        if not torch.equal(got[1][i], want[i]) or \
                not torch.equal(got[0][i] + got[1][i], whole[i]):
            fail(f"{name}: row-block counts differ from the plain version "
                 "or do not add up to the whole field's")
    err = max(float((got[1][i].double() - want[i].double()).abs().max())
              for i in (0, 2))
    if not all(torch.allclose(got[1][i].double(), want[i].double(),
                              rtol=RTOL, atol=ATOL) for i in (0, 2)):
        fail(f"{name}: row-block sums differ from the plain version "
             f"(max abs err {err})")
    work = [lane_work(feats[b], None, n[b], px[b], py[b], n_pix[b],
                      blocks[1][b], bh, 0, int(canvas.rows[b]),
                      int(canvas.cols[b])) for b in range(2)]
    bound_ms, bound_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work), feats.dtype)
    out = dict(name=name, lanes=2, row0=bh, block_rows=bh, dtype=str(
        feats.dtype).split(".")[1], pruned=False,
        live=[int(v) for v in n], pairs=sum(w[1] for w in work),
        max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
    dev_ms = profiled_ms(name, lambda: sc.score_partials_batched(
        *args[1], row0=bh), got[1], "score_partials_kernel")
    out["repeats_bitwise"] = 50
    out["ms"] = dev_ms if dev_ms is not None else time_cuda(
        lambda: sc.score_partials_batched(*args[1], row0=bh), 200)
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: sc.score_partials_batched_reference(*args[1], row0=bh), 3)
    out["floor_ms"] = floor_ms
    phase("batch_kernel_check", **out, card=card)
    return out


def to_np(x):
    """A tensor (on any device) or an array as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def rank_inputs(scene, lines, cache64, scene_p, pillar, cfg):
    """What multi_two_ranks sends every rank (numpy, pickled)."""
    from lsdtpu_torch.runtime import loop
    ds = scene.dataset
    p = ds.param
    fr = loop.stack_frames(ds, dtype=np.float64, max_frames=RANK_FRAMES)
    H, W = ds.map_value.shape
    pp = scene_p.dataset.param
    maps = [(to_np(lines), to_np(cache64), p.resol, p.ori_x, p.ori_y),
            (to_np(pillar[0]), to_np(pillar[1]).astype(np.float64),
             pp.resol, pp.ori_x, pp.ori_y)]
    dss = [scene.dataset, scene_p.dataset]
    robots = {f"r{r}": (r % 2, 17 * r) for r in range(POOL_CAPACITY)}
    ticks = []
    for t in range(RANK_POOL_TICKS):
        tick = {}
        for sid, (m, off) in robots.items():
            d = dss[m]
            f = off + t
            tick[sid] = (d.frames[f][:, 0], d.frames[f][:, 1], d.odom[f + 1])
        ticks.append(tick)
    return dict(frames=fr, map=maps[0], maps=maps, robots=robots,
                ticks=ticks, canvas=(H, W), grid=lsd_scene().dataset.map_value)


def pool_ticks(inp, cfg, device, mesh=None):
    """The robots of ``inp`` through a pool of one slot each (f64)."""
    from lsdtpu_torch.runtime.serving import SessionPool
    pool = SessionPool(len(inp["robots"]), inp["canvas"], cfg,
                       dtype=np.float64, device=device, mesh=mesh)
    for sid, (m, _off) in inp["robots"].items():
        pool.open_session(sid, *inp["maps"][m])
    out = []
    for tick in inp["ticks"]:
        for sid, scan in tick.items():
            pool.submit_scan(sid, *scan)
        out.append(pool.step())
    return out


def multi_rank(tmp, rank, world):
    """One spawned rank of multi_two_ranks (python3 chip_smoke.py
    --multi-rank DIR RANK WORLD): joins a gloo group through a file store
    in DIR on the parent's device (card 0), runs the tp = 2 and mp = 2
    rollouts, the pipelined rollout, the 2 x 8 slot pool and the sharded
    LSD (f32, f64), each with every kernel's launches counted, then
    saves and loads one DCP checkpoint of a replicated state with the
    other rank, and pickles the results to DIR."""
    import pickle
    import torch
    import torch.distributed as dist
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.mapprep import lsd_sharded
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.ops import nfa as onfa
    from lsdtpu_torch.runtime import (batch, convert, distributed, loop,
                                      pipeline, shard)
    from lsdtpu_torch.runtime.serving import make_pool_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device(inp["device"])
    backend = distributed.initialize(
        init_method="file://" + os.path.join(tmp, "store"), world_size=world,
        rank=rank, backend="gloo", device=dev, timeout_s=300)
    cfg = DEFAULT
    ctx = loop.make_map_context(*inp["map"], dtype=np.float64, device=dev)
    res = {"backend": backend}
    # the map-line (tp) and row-block (mp) rollouts of one lane; the mp
    # launches record the row0 they were given
    row0s = []
    batched = assoc.score_partials_batched

    def recording(*a, row0=0, **kw):
        row0s.append(int(row0))
        return batched(*a, row0=row0, **kw)

    frames = {k: v[None] for k, v in inp["frames"].items()}
    lines, cache, *params = inp["map"]
    ctxs = batch.batch_context([(lines, cache)], [params], cfg,
                               dtype=np.float64, device="cpu")
    for tag, make, run in (("tp2", shard.make_mesh, shard.run_batch_sharded),
                           ("mp2", shard.make_mesh_mp,
                            shard.run_batch_sharded_mapblocks)):
        mesh = make(dp=1, device=dev)
        assoc.score_partials_batched = recording
        try:
            outs, launches, secs = counted(lambda: run(frames, ctxs, mesh,
                                                       cfg, device=dev))
        finally:
            assoc.score_partials_batched = batched
        res[tag] = dict(outs={k: v.cpu().numpy() for k, v in outs.items()},
                        launches=launches, seconds=secs,
                        row0=sorted(set(row0s)))
        row0s.clear()
    mesh = pipeline.make_mesh_pp(device=dev)
    outs, launches, secs = counted(lambda: pipeline.run_sequence_pipelined(
        inp["frames"], ctx, mesh, cfg, device=dev))
    res["pipeline"] = dict(outs={k: v.cpu().numpy() for k, v in
                                 outs.items()}, launches=launches,
                           seconds=secs)
    ticks, launches, secs = counted(lambda: pool_ticks(
        inp, cfg, dev, make_pool_mesh(device=dev)))
    res["pool"] = dict(ticks=ticks, launches=launches, seconds=secs)
    for dt in (torch.float32, torch.float64):
        st = MapPrepStats()
        ((lines, mask, n, _rm), calls), launches, secs = counted(
            lambda: record_rect_counts(
                lambda: lsd_sharded.line_segment_detector_sharded(
                    inp["grid"], dtype=dt, device=dev, stats=st)))
        # every NFA launch of this rank, on its row block, against the
        # plain version on the same inputs (after the counted run)
        differ = 0
        for deg_map, scal, all_pix, ali_pix, block in calls:
            want = onfa.rect_counts_reference(deg_map, scal, *block)
            differ += not (torch.equal(all_pix, want[0])
                           and torch.equal(ali_pix, want[1]))
        res[f"lsd_{str(dt)[6:]}"] = dict(
            lines=lines.cpu().numpy(), mask=mask.cpu().numpy(), n=n,
            nfa_calls=st.nfa_calls, launches=launches, seconds=secs,
            nfa_checked=len(calls), nfa_differ=differ,
            nfa_blocks=sorted({(int(b[0]), int(b[1]), d.shape[0])
                               for d, _s, _a, _l, b in calls}))
    # one replicated state saved by both ranks to one DCP checkpoint under
    # the group, then loaded back by both
    st = convert.track_state_from_numpy(**inp["ckpt_state"], device=dev)
    save_ms, load_ms, nbytes, back = dcp_timed(
        os.path.join(tmp, "state.dcp"), st, dev)
    res["checkpoint_dcp"] = dict(
        state=convert.track_state_to_numpy(back), differs=same_state(back, st),
        save_ms=save_ms, load_ms=load_ms, bytes=nbytes)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def multi_two_ranks(scene, lines, cache64, scene_p, pillar, cfg, device,
                    smi):
    """multi_two_ranks: two spawned ranks on card 0 over gloo (NCCL
    refuses two ranks on one card), against this process's single-rank
    references computed first (so the ranks' times are their own).
    Returns {path: launches summed over the ranks}."""
    import pickle
    import torch
    from lsdtpu_torch.mapprep import lsd
    from torch.distributed.checkpoint import FileSystemReader
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.runtime import convert, loop
    inp = rank_inputs(scene, lines, cache64, scene_p, pillar, cfg)
    inp["device"] = device.type          # the ranks' device: card 0
    ctx = loop.make_map_context(*inp["map"], dtype=np.float64, device=device)
    seq, _l, seq_s = counted(lambda: loop.run_sequence(inp["frames"], ctx,
                                                       cfg, device=device))
    # the state both ranks checkpoint: the sequence's after 12 frames
    ckpt_state, _o = step_loop(
        loop.init_state(torch.float64, device),
        loop.to_device(inp["frames"], device), ctx, cfg,
        range(PARALLEL_FRAMES))
    inp["ckpt_state"] = convert.track_state_to_numpy(ckpt_state)
    seq = {k: v.cpu().numpy() for k, v in seq.items()}
    pool_want, _l, pool_s = counted(lambda: pool_ticks(inp, cfg, device))
    lsd_want = {}
    for dt in (torch.float32, torch.float64):
        st = MapPrepStats()
        (l_, m_, n_, _r), launches, secs = counted(
            lambda: lsd.line_segment_detector(inp["grid"], dtype=dt,
                                              device=device, stats=st))
        lsd_want[str(dt)[6:]] = (l_.cpu().numpy(), m_.cpu().numpy(), n_,
                                 secs, st.nfa_calls)
    tmp = tempfile.mkdtemp(prefix="lsdtpu_torch_ranks_")
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inp, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multi-rank", tmp,
             str(r), "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(
                    1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"multi_two_ranks: the ranks outlived {RANK_TIMEOUT_S} s")
        group_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                fail(f"multi_two_ranks: rank {r} exited {p.returncode}: "
                     f"{logs[r][-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        ck = os.path.join(tmp, "state.dcp")
        ck_files = sorted(os.listdir(ck))
        ck_stored = sorted(i.fqn for i in FileSystemReader(ck)
                           .read_metadata().storage_data)
        ck_left = sorted(n for n in os.listdir(tmp)
                         if n.startswith("state.dcp."))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    F = RANK_FRAMES
    paths = {}
    for tag in ("tp2", "mp2"):
        d = np.zeros(F)
        for r, res in enumerate(ranks):
            got = res[tag]["outs"]
            if not np.array_equal(got["n_candidates"][0],
                                  seq["n_candidates"]):
                fail(f"multi_two_ranks {tag}: rank {r} n_candidates differ "
                     "from run_sequence")
            d = np.maximum(d, np.abs(got["pose"][0] - seq["pose"]).max(-1))
            if res[tag]["launches"]["score_partials_batched"] != F:
                fail(f"multi_two_ranks {tag}: rank {r} launches "
                     f"{res[tag]['launches']} in {F} frames")
        # the rollout is causal, so its first 12 frames are a 12-frame run
        # (tests/test_runtime_parallel.py's length), printed with the
        # first frame that differs at all
        worst, first12 = float(d.max()), float(d[:PARALLEL_FRAMES].max())
        moved = np.nonzero(d)[0]
        row0 = [res[tag]["row0"] for res in ranks]
        if tag == "mp2" and not (row0[0] == [0] and row0[1][0] > 0):
            fail(f"multi_two_ranks mp2: the ranks launched with row0 {row0}")
        paths[f"multi_two_ranks_{tag}"] = {
            k: sum(res[tag]["launches"][k] for res in ranks)
            for k in ranks[0][tag]["launches"]}
        phase(f"multi_two_ranks_{tag}", card=repr(smi),
              backend=repr(ranks[0]["backend"]), frames=F,
              max_pose_diff_px=worst, n_candidates="identical",
              max_pose_diff_px_first_12=first12,
              first_differing_frame=int(moved[0]) if len(moved) else -1,
              diff_there_px=float(d[moved[0]]) if len(moved) else 0.0,
              tier_px=RANK_TIER_PX, row0_by_rank=repr(row0),
              launches_by_rank=repr([res[tag]["launches"] for res in ranks]),
              seconds_by_rank=repr([round(res[tag]["seconds"], 2)
                                    for res in ranks]),
              run_sequence_seconds=round(seq_s, 2))
        # RANK_TIER_PX (module constants): the psum adds the ranks'
        # partials in another order than the whole-field sum, and the
        # UKF chain carries the ulps
        if not worst <= RANK_TIER_PX:
            fail(f"multi_two_ranks {tag}: poses {worst} px from "
                 f"run_sequence in {F} frames")
    for r, res in enumerate(ranks):
        got = res["pipeline"]["outs"]
        bad = same_outputs(got, seq)
        if bad is not None:
            fail(f"multi_two_ranks pipeline: rank {r}'s {bad} differs from "
                 "run_sequence")
    paths["multi_two_ranks_pipeline"] = {
        k: sum(res["pipeline"]["launches"][k] for res in ranks)
        for k in ranks[0]["pipeline"]["launches"]}
    if paths["multi_two_ranks_pipeline"]["score_partials"] != F:
        fail(f"multi_two_ranks pipeline: launches "
             f"{paths['multi_two_ranks_pipeline']}")
    phase("multi_two_ranks_pipeline", card=repr(smi), frames=F,
          bitwise_run_sequence=True,
          launches_by_rank=repr([res["pipeline"]["launches"]
                                 for res in ranks]),
          seconds_by_rank=repr([round(res["pipeline"]["seconds"], 2)
                                for res in ranks]))
    worst = 0.0
    for r, res in enumerate(ranks):
        for g, w in zip(res["pool"]["ticks"], pool_want):
            if sorted(g) != sorted(w):
                fail(f"multi_two_ranks pool: rank {r} returned {sorted(g)}")
            for sid in w:
                if g[sid]["n_candidates"] != w[sid]["n_candidates"]:
                    fail(f"multi_two_ranks pool: {sid} decides otherwise")
                if not np.isnan(w[sid]["pose"]).any():
                    worst = max(worst, float(np.abs(g[sid]["pose"]
                                                    - w[sid]["pose"]).max()))
    if not worst <= 1e-9:
        fail(f"multi_two_ranks pool: poses {worst} px from the 16-slot pool")
    paths["multi_two_ranks_pool"] = {
        k: sum(res["pool"]["launches"][k] for res in ranks)
        for k in ranks[0]["pool"]["launches"]}
    phase("multi_two_ranks_pool", card=repr(smi),
          slots=f"'2 x {len(inp['robots']) // 2}'",
          ticks=RANK_POOL_TICKS, max_pose_diff_px=worst,
          launches_by_rank=repr([res["pool"]["launches"] for res in ranks]),
          seconds_by_rank=repr([round(res["pool"]["seconds"], 2)
                                for res in ranks]),
          one_rank_seconds=round(pool_s, 2))
    for dt, (wl, wm, wn, w_s, w_calls) in lsd_want.items():
        key = f"lsd_{dt}"
        for r, res in enumerate(ranks):
            g = res[key]
            if g["n"] != wn or not np.array_equal(g["mask"], wm) or \
                    not np.allclose(g["lines"][:wn, 4:8], wl[:wn, 4:8],
                                    **LSD_TIER):
                fail(f"multi_two_ranks {key}: rank {r}'s {g['n']} lines are "
                     f"not the unsharded wave tier's {wn}")
            if g["launches"]["rect_counts"] != g["nfa_calls"]:
                fail(f"multi_two_ranks {key}: rank {r} launched the NFA "
                     f"kernel {g['launches']['rect_counts']} times for "
                     f"{g['nfa_calls']} count calls")
            if g["nfa_checked"] != g["nfa_calls"] or g["nfa_differ"]:
                fail(f"multi_two_ranks {key}: rank {r}: {g['nfa_differ']} "
                     f"of {g['nfa_checked']} recorded NFA launches differ "
                     "from the plain version")
            # (row0, n_rows, block rows) of the rank's launches: rank 0
            # from row 0, rank 1 from a row0 > 0
            row0 = {b[0] for b in g["nfa_blocks"]}
            if len(row0) != 1 or (row0.pop() > 0) != (r > 0):
                fail(f"multi_two_ranks {key}: rank {r} launched on blocks "
                     f"{g['nfa_blocks']}")
        paths[f"multi_two_ranks_{key}"] = {
            k: sum(res[key]["launches"][k] for res in ranks)
            for k in ranks[0][key]["launches"]}
        phase(f"multi_two_ranks_{key}", card=repr(smi),
              map=repr(inp["grid"].shape), lines=wn,
              endpoint_tier=repr(LSD_TIER),
              nfa_calls_by_rank=repr([res[key]["nfa_calls"] for res in ranks]),
              nfa_launches_equal_plain="'all, each rank'",
              nfa_blocks_by_rank=repr([res[key]["nfa_blocks"]
                                       for res in ranks]),
              unsharded_nfa_calls=w_calls,
              seconds_by_rank=repr([round(res[key]["seconds"], 2)
                                    for res in ranks]),
              unsharded_seconds=round(w_s, 2))
    want = inp["ckpt_state"]
    if ck_files.count(".metadata") != 1 or ck_left or \
            ck_stored != sorted(want):
        fail(f"checkpoint_dcp two_ranks: the checkpoint holds {ck_files}, "
             f"stores {ck_stored}, leaves {ck_left}")
    for r, res in enumerate(ranks):
        got = res["checkpoint_dcp"]
        bad = got["differs"] or next(
            (k for k in want if got["state"][k].dtype != want[k].dtype
             or got["state"][k].shape != want[k].shape
             or got["state"][k].tobytes() != want[k].tobytes()), None)
        if bad is not None:
            fail(f"checkpoint_dcp two_ranks: rank {r} loaded {bad} otherwise "
                 "than the saved state")
    phase("checkpoint_dcp", case="'two_ranks'", card=repr(smi), ranks=2,
          backend=repr(ranks[0]["backend"]), dtype="'float64'",
          after_frame=PARALLEL_FRAMES, files=repr(ck_files),
          fields_stored_once=True,
          bytes=ranks[0]["checkpoint_dcp"]["bytes"],
          save_ms_by_rank=repr([res["checkpoint_dcp"]["save_ms"]
                                for res in ranks]),
          load_ms_by_rank=repr([res["checkpoint_dcp"]["load_ms"]
                                for res in ranks]),
          repeats=CKPT_REPEATS, loaded="'bitwise, each rank'")
    phase("multi_two_ranks", card=repr(smi), ranks=2, backend="'gloo'",
          group_seconds=round(group_s, 2))
    return paths


def multi_temporal(scene, fr32, ctx32, seq32, seq32_ms, cfg, device, smi,
                   kind):
    """multi_temporal: run_sequence_temporal over the whole f32 sequence
    with S segments as lanes on one card, against the sequential rollout
    timed in rollout_f32 (the same call, inputs and context); returns
    {path: launches}."""
    from lsdtpu_torch.runtime import temporal
    F = len(scene.dataset.frames)
    tracked = np.isfinite(seq32["score"])
    paths = {}
    for S, W in TEMPORAL_CASES:
        L = -(-F // S)
        temporal.run_sequence_temporal(fr32, ctx32, cfg=cfg, n_segments=S,
                                       warmup=W, device=device)  # warm-up
        times = []
        for w in _wrappers().values():
            w.launches = 0
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            par = temporal.run_sequence_temporal(
                fr32, ctx32, cfg=cfg, n_segments=S, warmup=W, device=device)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: w.launches for k, w in _wrappers().items()}
        if launches["score_partials_batched"] != REPEATS * (L + W) or \
                launches["score_partials"]:
            fail(f"multi_temporal S={S}: launches {launches}")
        ok = np.isfinite(par["score"])
        if (tracked & ~ok).any():
            fail(f"multi_temporal S={S}: frames tracked sequentially are "
                 "lost")
        err = np.linalg.norm(par["pose"][:, :2] - seq32["pose"][:, :2],
                             axis=1)[tracked]
        if not (err.max() < MAX_ERR_PX and err.mean() < MEAN_ERR_PX):
            fail(f"multi_temporal S={S}: position error max {err.max()} "
                 f"mean {err.mean()} px from run_sequence")
        refined, _info = temporal.reconcile_temporal(par, device=device)
        med = float(np.median(times))
        paths[f"multi_temporal_S{S}"] = launches
        phase("multi_temporal", device=repr(kind), power=repr(smi),
              segments=S, warmup=W, lanes=S, rollout_frames=L + W, frames=F,
              tracked=int(ok.sum()), sequential_tracked=int(tracked.sum()),
              median_ms=med, min_ms=min(times), max_ms=max(times),
              scans_per_s=F / med * 1e3,
              sequential_median_ms=seq32_ms,
              sequential_scans_per_s=F / seq32_ms * 1e3,
              max_err_px=float(err.max()), mean_err_px=float(err.mean()),
              rmse_m=rmse_m(par["pose"], scene, ok),
              reconciled_rmse_m=rmse_m(refined, scene, ok),
              launches=repr(launches),
              launches_per_rollout_frame=launches["score_partials_batched"]
              / (REPEATS * (L + W)))
    return paths


def cli_sharded(scene, device, smi, kind):
    """cli_sharded: `prepare-map --mapprep tpu-sharded` and `batch
    --concat --temporal 8` through lsdtpu_torch.cli.main in this process
    (one rank), over the scene written as a dataset directory; returns
    {path: launches}."""
    tmp = tempfile.mkdtemp(prefix="lsdtpu_torch_cli_sharded_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        write_dataset(data, scene)
        common = ["--cache-dir", os.path.join(tmp, "cache"), "--device",
                  device.type]
        F = len(scene.dataset.frames)
        paths = {}
        recs, _err, launches, secs = cli_call(
            "cli_sharded_prepare_map", ["prepare-map", "--data", data,
                                        *common, "--mapprep", "tpu-sharded"])
        need_launches("cli_sharded_prepare_map", launches, ("rect_counts",))
        paths["cli_sharded_prepare_map"] = launches
        phase("cli_sharded_prepare_map", device=repr(kind), power=repr(smi),
              lines=recs[0]["lines"], cold_s=secs, launches=repr(launches))
        recs, err, launches, secs = cli_call(
            "cli_sharded_batch_temporal",
            ["batch", "--data", data, *common, "--concat", "--temporal", "8",
             "--mapprep", "tpu-sharded"])
        need_launches("cli_sharded_batch_temporal", launches,
                      ("score_partials_batched",))
        summary = json.loads(err[-1])
        if recs[0]["frames"] != F:
            fail(f"cli_sharded_batch_temporal: records {recs}")
        paths["cli_sharded_batch_temporal"] = launches
        phase("cli_sharded_batch_temporal", device=repr(kind),
              power=repr(smi), tracked=recs[0]["tracked"], frames=F,
              scans_per_sec=summary["scans_per_sec"], command_s=secs,
              launches=repr(launches))
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# fuzz_campaign: the campaign's flags (seed 101 holds the perfect-score
# chain), then a FIFO map whose regions need the radius reducer
def _script(name):
    """scripts/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FUZZ_RUNS = (("--cache", "8", "--lsd", "3", "--fifo", "3", "--rollout", "4",
              "--shard", "1", "--seed0", "100"),
             ("--cache", "0", "--lsd", "0", "--fifo", "1", "--rollout", "0",
              "--shard", "0", "--seed0", "118"))


def fuzz_campaign(smi):
    """fuzz_campaign: scripts/torch_fuzz_campaign.py's campaign on the
    card for each of FUZZ_RUNS (a failure fails the run); returns
    {"fuzz_campaign": {kernel: launches}} - this process's launches from
    the wrappers' counts, set to 0 just before, and the two ranks'
    lane-batched launches as the ranks counted them."""
    from lsdtpu_torch.ops import grow as og
    from lsdtpu_torch.ops import nfa as onfa
    from lsdtpu_torch.ops import score as sc
    fc = _script("torch_fuzz_campaign")
    wrappers = {w.__name__: w for w in (sc.score_partials, onfa.rect_counts,
                                        og.grow_fifo, og.radius_reducer_fifo)}
    for w in wrappers.values():
        w.launches = 0
    sc.score_partials_batched.launches = 0
    t0 = time.perf_counter()
    held = dict.fromkeys(list(wrappers) + ["score_partials_batched"], 0)
    runs = []
    for argv in FUZZ_RUNS:
        rc, res = fc.campaign(list(argv))
        if rc != 0:
            fail(f"fuzz_campaign {' '.join(argv)}: exit {rc}")
        for k, v in res["launches_held"].items():
            held[k] += v
        runs.append({k: res[k] for k in ("seed0", "sections", "seconds")})
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["score_partials_batched"] = held["score_partials_batched"]
    if sc.score_partials_batched.launches:
        fail("fuzz_campaign launched the lane-batched kernel in this "
             "process; only its ranks should")
    if launches != held or 0 in launches.values():
        fail(f"fuzz_campaign: launches {launches}, held against the plain "
             f"versions {held}")
    phase("fuzz_campaign", card=repr(smi), runs=json.dumps(runs),
          launches=json.dumps(launches),
          seconds=round(time.perf_counter() - t0, 2))
    return {"fuzz_campaign": launches}


# --- the reference package's last two tools --------------------------------

SOL_CPU_FRAMES = 12     # sol_bound: frames whose counts the CPU repeats
SOL_F32_PINNED = (3,)   # sol_bound: frames whose f32 counts may differ
SOL_PROFILE_FRAMES = 20  # sol_bound: profiled frames (featurize, UKF ms)
POD_FRAMES = 60         # pod_bench: --frames (temporal at two ranks: > 56)
POD_REPEATS = 1         # pod_bench: --repeats
POD_TIMEOUT_S = 600     # pod_bench_w2: the ranks' join timeout


def hold_calls(tag, calls):
    """Every recorded CalcScore launch through its plain version on the
    CPU; fails unless each agrees.  Returns (held, max abs err)."""
    err = 0.0
    for c in calls:
        counts, sums, e = replay_partials(c)
        if not (counts and sums):
            fail(f"{tag}: a recorded {c['name']} launch differs from the "
                 f"plain version (counts equal {counts}, max abs err {e})")
        err = max(err, e)
    return len(calls), err


def same_launch(a, b):
    """Whether two CalcScore launches' arguments are bitwise equal."""
    import torch
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else
        (not torch.is_tensor(y) and x == y) for x, y in zip(a, b))


def gate_flips(f, sides, cfg):
    """The hypotheses of frame ``f`` whose distance gate (d <
    max_esti_dist, match/associate.py:166-168) two counting rollouts
    decide apart.  sides: {"card": ..., "cpu": ...}, each (per-frame
    steps, MapContext, live count of frame f).  Each side's hypotheses
    come from generate_candidates with no prior pose (every length-gated
    hypothesis, in index order), d from their (rlx, rly) and the side's
    last pose as the gate computes it; fails unless each side's count of
    d < max_esti_dist is its live count.  The sides' hypotheses are
    matched slot by slot where their counts agree and their features
    agree to 1e-5 (relative and absolute).  Returns {lines_max_diff (per
    linesInfo column, over the live lines), hypotheses, matched,
    last_pose, flips: [{slot, d: {"<hypotheses' side>/<pose's side>":
    d}}]}."""
    import torch
    from lsdtpu_torch import geometry as geo
    from lsdtpu_torch.match import associate as assoc
    m = cfg.match
    got = {}
    for side, (steps, ctx, live) in sides.items():
        fs, state, _out = steps[f]
        S, M = fs.lines.shape[-2], ctx.lines.shape[-2]
        hyp = assoc.generate_candidates(
            fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
            geo.c_round(fs.lidar_pos), torch.full_like(state.last_pose, -1),
            S * M * 4, m.ignore_scan_length, m.scan_to_map_diff,
            m.max_esti_dist)
        n = int(hyp.count)
        rl = hyp.pose[:n, :2]
        d = geo.sqrt((rl[:, 0] - state.last_pose[0]) ** 2
                     + (rl[:, 1] - state.last_pose[1]) ** 2)
        if int((d < m.max_esti_dist).sum()) != live:
            fail(f"sol_bound: frame {f} on the {side}: "
                 f"{int((d < m.max_esti_dist).sum())} hypotheses within the "
                 f"distance gate, {live} live candidates")
        got[side] = dict(lines=fs.lines[fs.lines_mask].cpu(),
                         feats=hyp.feats()[:, :n].cpu(), rl=rl.cpu(),
                         pose=state.last_pose.cpu())
    a, b = got["card"], got["cpu"]
    res = dict(hypotheses={k: g["rl"].shape[0] for k, g in got.items()},
               last_pose={k: g["pose"].tolist() for k, g in got.items()},
               lines_max_diff=None, matched=False, flips=[])
    if a["lines"].shape == b["lines"].shape:
        res["lines_max_diff"] = torch.where(
            a["lines"] == b["lines"], 0.0,
            (a["lines"] - b["lines"]).abs()).amax(0).tolist()
    if a["feats"].shape != b["feats"].shape or not torch.allclose(
            a["feats"], b["feats"], rtol=1e-5, atol=1e-5):
        return res
    res["matched"] = True

    def dist(h, p):      # the gate's d, on the CPU, in the working type
        return geo.sqrt((got[h]["rl"][:, 0] - got[p]["pose"][0]) ** 2
                        + (got[h]["rl"][:, 1] - got[p]["pose"][1]) ** 2)

    d = {f"{h}/{p}": dist(h, p) for h in got for p in got}
    gate = {k: v < m.max_esti_dist for k, v in d.items()}
    for i in torch.nonzero(gate["card/card"] != gate["cpu/cpu"]).flatten():
        res["flips"].append(dict(slot=int(i), d={k: float(v[i])
                                                 for k, v in d.items()}))
    return res


# sol_bound: the stages that stage_swaps computes on the CPU, alone and
# all together
SOL_SWAPS = (("featurize",), ("sums",), ("fuse",), ("ukf",),
             ("featurize", "sums", "fuse", "ukf"))


def moved(x, dev):
    """x with every tensor in it (tuples, dataclasses) moved to dev."""
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(moved(v, dev) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            k.name: moved(getattr(x, k.name), dev)
            for k in dataclasses.fields(x)})
    return x


def stage_swaps(f, frames, ctx, cfg, device):
    """The card's f32 counting rollout of frames [0, f] with stages
    computed on the CPU (their arguments moved there, their results
    back), each of SOL_SWAPS: featurize (loop.featurize_stage),
    CalcScore's sums (the scorer's score_partials: the plain version,
    no launch), the candidates' fusion (associate.fuse) and the UKF
    (ukf_step).  Returns {"+".join(swap): (live count of frame f, the
    last pose before it)}."""
    from lsdtpu_torch.filter import ukf as fukf
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    sb = _script("torch_sol_bound")
    where = {"featurize": (loop, "featurize_stage"),
             "sums": (assoc, "score_partials"), "fuse": (assoc, "fuse"),
             "ukf": (fukf, "ukf_step")}
    kept = {k: getattr(*v) for k, v in where.items()}

    def on_cpu(fn):
        def run(*a, **kw):
            return moved(fn(*moved(a, "cpu"), **{k: moved(v, "cpu")
                                                 for k, v in kw.items()}),
                         device)
        return run

    out = {}
    for swap in SOL_SWAPS:
        steps = []
        for k in swap:
            setattr(*where[k], on_cpu(kept[k]))
        try:
            recs = sb.rollout_counts({k: v[:f + 1] for k, v in
                                      frames.items()}, ctx, cfg, device,
                                     steps=steps)
        finally:
            for k, v in where.items():
                setattr(*v, kept[k])
        out["+".join(swap)] = (int(recs["live_cand"][f]),
                               steps[f][1].last_pose.cpu())
    return out


def f32_divergence(frames, cfg, device, recs, steps, ctx, cpu32, cpu_steps,
                   cpu_ctx):
    """The first frames' f32 counts, card against CPU (the counting
    rollouts' records and steps on each): fails where they differ beyond
    the live and survivor counts of SOL_F32_PINNED, or where a live count
    differs by more than the distance gate's flips (gate_flips).  For
    each differing frame: the flips, the frame's cos / sin of its angles
    differing between the devices, the last poses' difference before
    each frame 1..f, and the card's rollout with stages computed on the
    CPU (stage_swaps).  Returns ({count: [differing frames]}, {frame: its
    diagnosis})."""
    import torch
    n0 = len(cpu32["live_cand"])
    differ = {k: [int(f) for f in np.flatnonzero(v != recs[k][:n0])]
              for k, v in cpu32.items()}
    off = {k: v for k, v in differ.items() if v and (
        k not in ("live_cand", "n_surv") or set(v) - set(SOL_F32_PINNED))}
    if off:
        fail(f"sol_bound: f32 counts of the first {n0} frames differ "
             f"between the card and the CPU beyond the pinned frames "
             f"{SOL_F32_PINNED} and the live and survivor counts: {off}")
    gates = {}
    for f in sorted(set(differ["live_cand"] + differ["n_surv"])):
        g = gate_flips(f, {"card": (steps, ctx, int(recs["live_cand"][f])),
                           "cpu": (cpu_steps, cpu_ctx,
                                   int(cpu32["live_cand"][f]))}, cfg)
        shift = sum(int(fl["d"]["card/card"] < cfg.match.max_esti_dist)
                    - int(fl["d"]["cpu/cpu"] < cfg.match.max_esti_dist)
                    for fl in g["flips"])
        if not g["matched"] or \
                shift != recs["live_cand"][f] - cpu32["live_cand"][f]:
            fail(f"sol_bound: f32 frame {f}: the live counts differ "
                 f"(card {recs['live_cand'][f]}, CPU "
                 f"{cpu32['live_cand'][f]}) but not by the distance gate "
                 f"alone: {g}")
        ang = np.asarray(frames["angles"][f])
        g["cos_sin_differ"] = [int((fn(torch.as_tensor(ang, device=device))
                                    .cpu() != fn(torch.as_tensor(ang)))
                                   .sum()) for fn in (torch.cos, torch.sin)]
        g["pose_diff_by_frame"] = [float(
            (steps[k][1].last_pose.cpu() - cpu_steps[k][1].last_pose).abs()
            .max()) for k in range(1, f + 1)]
        cpu_pose = cpu_steps[f][1].last_pose
        g["swaps"] = {k: dict(live=live, pose_equal_cpu=torch.equal(
            pose, cpu_pose), pose_max_diff=float((pose - cpu_pose).abs()
                                                 .max()))
            for k, (live, pose) in stage_swaps(f, frames, ctx, cfg,
                                               device).items()}
        gates[f] = g
    return differ, gates


def sol_bound(scene, seq_ms, strategy_ms, device, smi):
    """sol_bound: scripts/torch_sol_bound.py on the scene (the oracle's
    map, the bench's shapes, f32, every frame), every wrapper's count
    set to 0 just before the phase and read just after.  Every CalcScore
    launch that the rollouts make (the counting rollout, the card's f64
    rollout of the first SOL_CPU_FRAMES frames, f32_divergence's
    swaps, one timed run_sequence of the counted
    configuration, with the recorder's clones) is recorded and held
    against the plain version; the constants' timed launches (the
    relock frame's launch, repeated) are each bitwise the first, whose
    arguments and output are bitwise the counting rollout's launch of
    that frame; the wrappers' counts must equal the two.  The first
    SOL_CPU_FRAMES frames' counts on the card equal the CPU's in f64 and
    in f32 but where f32_divergence allows and explains them.  Prints
    the count lines, the constants with their methods (featurize and UKF
    profiled over the first SOL_PROFILE_FRAMES frames and scaled to all),
    and the floor of each count beside the timed run of the counted
    configuration and rollout_f32's and the strategies' times.  Returns
    {"sol_bound": {kernel: launches}}."""
    import torch
    from lsdtpu_torch.bench import bench_cfg
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.oracle import driver as odrv
    sb = _script("torch_sol_bound")
    t0 = time.perf_counter()
    cfg = bench_cfg()
    ds = scene.dataset
    art = odrv.prepare_map(ds.map_value, ds.param.resol)
    ctx, frames = sb.scene_context(ds, np.float32, device, art)
    F = frames["ranges"].shape[0]
    n0 = SOL_CPU_FRAMES

    def first(dt, dev, steps=None):
        c, fr = sb.scene_context(ds, dt, dev, art)
        return c, sb.rollout_counts({k: v[:n0] for k, v in fr.items()}, c,
                                    cfg, dev, steps=steps)

    def phase_runs():
        steps = []
        t = time.perf_counter()
        recs = sb.rollout_counts(frames, ctx, cfg, device, steps=steps)
        count_s = time.perf_counter() - t
        # the first frames' counts: card = CPU in f64, and in f32 but on
        # the pinned frames
        card64 = first(np.float64, device)[1]
        cpu64 = first(np.float64, "cpu")[1]
        for k, v in cpu64.items():
            if not np.array_equal(v, card64[k]):
                fail(f"sol_bound: f64 {k} of the first {n0} frames on the "
                     f"card {card64[k].tolist()}, on the CPU {v.tolist()}")
        cpu_steps = []
        cpu_ctx, cpu32 = first(np.float32, "cpu", cpu_steps)
        differ, gates = f32_divergence(frames, cfg, device, recs, steps, ctx,
                                       cpu32, cpu_steps, cpu_ctx)
        const, launch = sb.measure_constants(
            frames, ctx, cfg, recs, sys.modules[__name__], steps,
            SOL_PROFILE_FRAMES)
        del steps, cpu_steps
        torch.cuda.synchronize()
        t = time.perf_counter()
        host(loop.run_sequence(frames, ctx, cfg, device=device))
        run_ms = (time.perf_counter() - t) * 1e3
        return recs, count_s, differ, gates, const, launch, run_ms

    ((recs, count_s, differ, gates, const, launch, run_ms), calls), \
        launches, _secs = counted(lambda: record_partials(phase_runs))
    # recorded: the counting rollout, the card's f64 frames, the frames
    # of each swap that keeps the kernel (f32_divergence) and the timed run
    n_rec = len(calls)
    want = 2 * F + n0 + sum(f + 1 for f in gates) * sum(
        "sums" not in swap for swap in SOL_SWAPS)
    if n_rec != want or launches["score_partials"] != \
            n_rec + launch["launches"] or \
            sum(launches.values()) != launches["score_partials"]:
        fail(f"sol_bound: launches {launches}; {n_rec} recorded of {want} "
             f"rollout frames, {launch['launches']} timed")
    f_relock = const["gather_rate"]["relock_frame"]
    rel = calls[f_relock]
    if not (same_launch(rel["args"], launch["args"]) and
            same_launch(rel["out"], launch["out"])):
        fail(f"sol_bound: the constants' CalcScore launch is not the "
             f"counting rollout's launch of frame {f_relock}")
    held, err = hold_calls("sol_bound", calls)
    del calls

    counts = sb.gather_counts(recs, cfg)
    sb.print_counts(recs, counts)
    fl = sb.floors(counts, const)
    sb.print_bound(const, fl, smi)
    floor = fl["floor_ms"]["as_built"]
    best = min(strategy_ms, key=strategy_ms.get)
    phase("sol_bound", card=repr(smi), frames=F,
          pruned_frames=int(counts["pruned"].sum()),
          relock=repr(recs["live_cand"][~recs["tracking"]].tolist()),
          survivors=repr(recs["n_surv"][~recs["tracking"]].tolist()),
          cells=json.dumps({k: int(counts[k].sum()) for k in
                            ("useful", "as_chunked", "as_built")}),
          gather_rate=const["gather_rate"]["value"],
          gather_rate_which=const["gather_rate"]["which"],
          rates=json.dumps({k: v["rate"] for k, v in
                            const["gather_rate"]["rates"].items()}),
          h2d_ms=const["h2d_ms"]["value"],
          loop_floor_ms=const["loop_floor_ms"]["value"],
          featurize_ms=const["featurize_ms"]["value"],
          ukf_ms=const["ukf_ms"]["value"],
          gather_ms=json.dumps(fl["gather_ms"]),
          floor_ms=json.dumps(fl["floor_ms"]),
          rollout_counted_cfg_ms=run_ms,
          counted_cfg_over_floor=run_ms / floor,
          rollout_f32_ms=seq_ms, strategies_ms=json.dumps(strategy_ms),
          best_strategy=best,
          cpu_f64_frames_equal=n0, f32_differ=json.dumps(differ),
          f32_gate_flips=json.dumps(gates),
          launches=launches["score_partials"], recorded=n_rec,
          timed_launches=launch["launches"], held=held, differ=0,
          max_abs_err=err, counting_s=count_s,
          seconds=round(time.perf_counter() - t0, 2))
    return {"sol_bound": launches}


def run_pod_bench(argv):
    """scripts/torch_pod_bench.py's main(argv), every wrapper's count set
    to 0 just before and read just after, and every CalcScore launch
    (single-lane and lane-batched) recorded on the card during the run
    (clones: no host sync in its timed repeats), then held against the
    plain version on the CPU.  Returns {launches, held, max_abs_err,
    seconds}."""
    pb = _script("torch_pod_bench")
    ((rc, calls_b), calls_s), launches, secs = counted(
        lambda: record_partials(lambda: record_partials(
            lambda: pb.main(argv), "score_partials_batched"),
            "score_partials"))
    if rc != 0:
        fail(f"pod_bench {' '.join(argv)}: exit {rc}")
    n = launches["score_partials"] + launches["score_partials_batched"]
    if len(calls_s) + len(calls_b) != n or not (
            launches["score_partials"] and launches["score_partials_batched"]):
        fail(f"pod_bench: launches {launches}, {len(calls_s)} + "
             f"{len(calls_b)} recorded")
    held, err = hold_calls("pod_bench", calls_s + calls_b)
    return dict(launches=launches, held=held, max_abs_err=err, seconds=secs)


def pod_rank(tmp):
    """One rank of pod_bench_w2 (python3 chip_smoke.py --pod-rank DIR,
    torchrun's environment set by the parent): run_pod_bench on DIR's
    argv, its result pickled to DIR."""
    import pickle
    with open(os.path.join(tmp, "argv.pkl"), "rb") as f:
        argv = pickle.load(f)
    res = run_pod_bench(argv)
    with open(os.path.join(tmp, f"rank{os.environ['RANK']}.pkl"),
              "wb") as f:
        pickle.dump(res, f)


def check_scaling(js, world, smi):
    """Fail unless a SCALING json has all four modes at ``world`` ranks on
    the card."""
    modes = ("solo", "dp", "serving", "temporal")
    bad = [m for m in modes if m not in js or not js[m]["scans_per_sec"] > 0
           or not np.isfinite(js[m]["median_s"])
           or js[m]["n_repeats"] != POD_REPEATS]
    if bad or js["backend"] != "cuda" or js["n_devices"] != world or \
            js["frames"] != POD_FRAMES or js["card"] != smi or \
            (js["dp"]["n_sequences"], js["serving"]["n_sessions"],
             js["temporal"]["n_segments"]) != (world,) * 3:
        fail(f"pod_bench at world size {world}: malformed SCALING json "
             f"(modes {bad}): {json.dumps(js)}")


def scaling_line(tag, res, js, smi):
    """A pod_bench phase line (launches, held) and its SCALING json."""
    phase(tag, card=repr(smi), launches=json.dumps(res["launches"]),
          held=res["held"], differ=0, max_abs_err=res["max_abs_err"],
          seconds=round(res["seconds"], 2))
    print(json.dumps(js), flush=True)


def pod_bench(scene, device, smi):
    """pod_bench_w1 and pod_bench_w2: scripts/torch_pod_bench.py on the
    scene's first POD_FRAMES frames written as a dataset directory, with
    POD_REPEATS repeats: in this process (world size 1, on the group it
    holds), then as two rank processes sharing the card (torchrun's
    environment, a localhost rendezvous; the script takes gloo for ranks
    sharing a card).  Each run's CalcScore launches held against the
    plain version (run_pod_bench), its SCALING json checked and printed.
    Returns {path: {kernel: launches}} (the ranks' summed)."""
    import pickle
    import socket
    root = tempfile.mkdtemp(prefix="lsdtpu_torch_pod_")
    try:
        write_dataset(root, dataclasses.replace(scene, dataset=lane_dataset(
            scene.dataset, 0, POD_FRAMES)))
        base = ["--device", "cuda", "--frames", str(POD_FRAMES), "--repeats",
                str(POD_REPEATS), "--data", root]
        out1 = os.path.join(root, "SCALING_w1.json")
        w1 = run_pod_bench(base + ["--out", out1])
        with open(out1) as f:
            js1 = json.load(f)
        check_scaling(js1, 1, smi)
        scaling_line("pod_bench_w1", w1, js1, smi)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out2 = os.path.join(root, "SCALING_w2.json")
        with open(os.path.join(root, "argv.pkl"), "wb") as f:
            pickle.dump(base + ["--out", out2], f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pod-rank", root],
            env=dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(
                    1.0, POD_TIMEOUT_S - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"pod_bench_w2: the ranks outlived {POD_TIMEOUT_S} s")
        for r, p in enumerate(procs):
            if p.returncode != 0:
                fail(f"pod_bench_w2: rank {r} exited {p.returncode}: "
                     f"{logs[r][-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        with open(out2) as f:
            js2 = json.load(f)
        group_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_scaling(js2, 2, smi)
    if js2["dist_backend"] != "gloo" or \
            "backend gloo, world size 2" not in logs[0]:
        fail(f"pod_bench_w2: dist_backend {js2['dist_backend']}, not the "
             "gloo that ranks sharing a card take")
    w2 = dict(launches={k: sum(rk["launches"][k] for rk in ranks)
                        for k in ranks[0]["launches"]},
              held=sum(rk["held"] for rk in ranks),
              max_abs_err=max(rk["max_abs_err"] for rk in ranks),
              seconds=group_s)
    scaling_line("pod_bench_w2", w2, js2, smi)
    return {"pod_bench_w1": w1["launches"], "pod_bench_w2": w2["launches"]}


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
    seq32, seq32_ms = res, med     # the sequential rollout (multi_temporal)

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

    # the execution strategies on the same frames and context
    strategy_launches, strategy_ms = rollout_strategies(
        fr32, fr32_dev, ctx32, cfg, device, smi, kind)

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
    for _ in range(MAPPREP_REPEATS):
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
        for deg_map, scal, all_pix, ali_pix, _block in calls:
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
    nfa_row_runs = nfa_row_cases(calls32, repr(smi), floor_ms)
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
    fifo_edges = fifo_edge_cases(repr(smi))

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
    if d32 or rd32:
        fail(f"f32 FIFO kernels: {len(d32)} sampled grow_fifo and "
             f"{len(rd32)} radius_reducer_fifo launches differ from their "
             "plain versions")
    fifo_map = fifo_map_summary(grows32, reduces32, acts, lat, clock,
                                repr(smi))
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
    batch_launches, strategy_batch_launches = batch_rollouts(
        maps, cfg, device, smi, kind)
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

    # --- 13. the multi-device runners (slice 8) ----------------------------
    t_multi = time.perf_counter()
    pillar = (pillar_art.lines_info, pillar_art.map_cache)
    multi_paths = multi_world1(scene, lines, cache64, scene_p, pillar, cfg,
                               device, smi)
    multi_prep(scene, cache64, device, smi)
    row_cases = [row_block_case(f"row_block_mp2_{tag}", scene, lines,
                                cache64, cfg, device, repr(smi), floor_ms, dt)
                 for tag, dt in (("f32", np.float32), ("f64", np.float64))]
    multi_paths.update(multi_two_ranks(scene, lines, cache64, scene_p, pillar,
                                       cfg, device, smi))
    multi_paths.update(multi_temporal(scene, fr32, ctx32, seq32, seq32_ms,
                                      cfg, device, smi, kind))
    multi_paths.update(cli_sharded(scene, device, smi, kind))
    phase("multi", card=repr(smi), launches=json.dumps(multi_paths),
          seconds=round(time.perf_counter() - t_multi, 2))

    # --- 14. the fuzz campaign (slice 12) ---------------------------------
    fuzz_paths = fuzz_campaign(smi)

    # --- 15. the reference package's last two tools ------------------------
    tool_paths = sol_bound(scene, seq32_ms, strategy_ms, device, smi)
    tool_paths.update(pod_bench(scene, device, smi))

    # --- 16. report ------------------------------------------------------
    main_case = cases[1]      # relock frame as the main path scores it
    kern = {
        "name": "score_partials", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True, "launches": launches,
        "launches_by_path": {"rollout_f32": launches,
                             "rollout_strategies_f32": strategy_launches,
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
        "cases": nfa_runs + nfa_row_runs,
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
            "bound_old_ms": run["bound_old_ms"],
            "chain_bound_ms": run["chain_bound_ms"],
            "chain_bound_old_ms": run["chain_bound_old_ms"],
            "bytes_bound_ms": run["bytes_bound_ms"],
            "ops_bound_ms": run["ops_bound_ms"], "latency_cycles": lat,
            "library_ms": None,
            "floor_ms": floor_ms, "map_f32": fifo_map[name],
            "design": "one block; warp 0 walks the queue in windows of 4 "
                      "entries, lane L testing neighbour L % 8 of entry "
                      "L / 8, a ballot taking the acceptances in order; "
                      "the region a shared bitmap (a global mask past the "
                      "budget), the queue packed in shared memory "
                      "(spilling to qy/qx); the next window's loads issued "
                      "before the decisions; warps 1-7 clearing the call's "
                      "uint8 mask beside the walk" if name == "grow_fifo"
                      else "one block: far flags decided in parallel into "
                           "shared bit words, slots in shared memory; one "
                           "thread runs the swap-with-last walk in runs over "
                           "the flag words, then the phantom-slot drop",
            "cases": [run] + [c for c in fifo_edges if c["name"].startswith(
                "grow" if name == "grow_fifo" else "reducer")]})
    bmain = batch_cases[0]    # one relocking lane beside seven tracking
    batched_kern = {
        "name": "score_partials_batched", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True,
        "launches": batch_launches + strategy_batch_launches + pool_launches,
        "launches_by_path": {"batch_f32": batch_launches,
                             "rollout_strategies_batch_f32":
                                 strategy_batch_launches,
                             "serving_f32": pool_launches},
        "max_abs_err": max(c["max_abs_err"] for c in batch_cases
                           + row_cases),
        "ms": bmain["ms"], "ms_source": bmain["ms_source"],
        "plain_ms": bmain["plain_ms"], "bound_ms": bmain["bound_ms"],
        "bound_by": bmain["bound_by"], "library_ms": None,
        "single_sum_ms": bmain["single_sum_ms"], "floor_ms": floor_ms,
        "design": "the CalcScore kernel on a (grid, B) grid: blockIdx.y is "
                  "the lane, each lane the same persistent x-extent (the "
                  "resident blocks over B); a lane's slots, arithmetic and "
                  "summation order are the single-lane launch's; over a "
                  "row block (row0) for the mp ranks",
        "cases": batch_cases + row_cases,
    }
    kernels = [kern, batched_kern, nfa_kern] + fifo_kern
    for k in kernels:
        k["launches_by_path"].update(
            {path: counts[k["name"]] for path, counts in cli_paths.items()})
        k["launches_by_path"].update(
            {path: counts[k["name"]] for path, counts in multi_paths.items()})
        k["launches_by_path"].update(
            {path: counts[k["name"]] for path, counts in fuzz_paths.items()})
        k["launches_by_path"].update(
            {path: counts[k["name"]] for path, counts in tool_paths.items()})
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()    # the one-rank group of multi_world1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-rank"]:
        multi_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1:2] == ["--pod-rank"]:
        pod_rank(sys.argv[2])
    else:
        main()
