#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsdtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with one H100

Drives the port's two paths at the extent of the bundled data1 sequence
(a 979x1440 map at 0.025 m/px, 279 frames of 360-ray scans to 13 m) on
a synthetic multi-room scene made from a seed, since no dataset is
mounted on the card's machine: the per-frame localization rollout
(run_sequence) and map prep (prepare_map: occupancy grid -> LSD map
lines + distance field), then both together.  Phases, each printed on
its own line; any failure exits non-zero before the last line:

  1. device: the card's name, count and power limit (no card: exit 2);
  2. build: nvcc builds csrc/score.cu and csrc/nfa.cu, one process each,
     started together (seconds, ptxas registers/spills);
  3. scene: the synthetic scene; its distance field from the port's
     create_map_cache on the card; its map lines from the wall segments;
  4. kernel check: the launch floor (the profiler's device time of a
     one-element PyTorch elementwise kernel), then the CalcScore kernel
     against its plain PyTorch version on the card, at a relock frame
     (~1000 candidates) and a tracking frame (~20), on the pruned and the
     unpruned path, with times, the bound, the floor, the launch counts
     and 50 repeated launches bitwise equal to the first;
  5. rollout: f64 on the card vs the CPU (identical decisions), then f32
     on the card, 5 repeats timed to value, with the kernel's launch
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
     run_sequence of the 279 frames, 5 repeats, tracked frames and the
     position error against the true trajectory; then the CalcScore
     kernel at that path's relock frame (the port's own LSD lines, its
     K cap of 4096: the main path's largest launch), pruned and
     unpruned;
  8. a JSON line of the kernels, the nvidia-smi name/power line, and the
     last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
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
REPEATS = 5   # timed f32 rollouts (median reported)
RTOL = 2e-6   # f32 kernel vs plain: different summation order
ATOL = 2e-6


def phase(tag, **kw):
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


def kernel_case(name, cand, fs, ctx, cfg, coarse, device, reps, card,
                floor_ms):
    """Kernel vs plain on one frame's inputs; returns the measurements."""
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
    args = (feats, idx, n, px, py, n_pix, ctx.cache, 0, ctx.rows, ctx.cols,
            z, pen, z)
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
    n_live = int(n)
    P = int(n_pix)
    pairs = n_live * P
    sel = torch.arange(n_live, device=device) if idx is None \
        else idx[:n_live].long()
    ca, sa, sx, sy, mx, my = feats[:, sel][:, :, None]
    tx = (px[None, :P] - sx) * ca - (py[None, :P] - sy) * sa + mx
    ty = (px[None, :P] - sx) * sa + (py[None, :P] - sy) * ca + my
    fx, fy = assoc.geo.c_round(tx), assoc.geo.c_round(ty)
    ins = (fx >= 0) & (fx < ctx.cols) & (fy >= 0) & (fy < ctx.rows)
    cells = int(torch.unique((fy[ins] * ctx.cols + fx[ins]).long()).numel())
    esize = feats.element_size()
    nbytes = (esize * (6 * n_live + 2 * P + cells)       # inputs read once
              + (4 * n_live if idx is not None else 0)    # survivor list
              + K * (2 * esize + 2 * 4))                  # the 4 outputs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_PAIR * pairs / PEAK_OPS[str(dt).split(".")[1]] * 1e3
    out = dict(name=name, live_candidates=n_live, live_pixels=P,
               pairs=pairs, distinct_cells=cells, max_abs_err=err,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               check_launches=sc.score_partials.launches - before)
    # device time per launch from the profiler; CUDA events over
    # back-to-back launches also include the host's launch gaps
    acts = repeats_bitwise(name, lambda: sc.score_partials(*args), got)
    out["repeats_bitwise"] = 50
    out["kernel_ms"] = time_cuda(lambda: sc.score_partials(*args), reps)
    dev_ms = kernel_device_ms(acts)
    out["ms"] = out["kernel_ms"] if dev_ms is None else dev_ms
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: sc.score_partials_reference(*args), max(5, reps // 20))
    out["floor_ms"] = floor_ms
    phase("kernel_check", **out, bound_us=out["bound_ms"] * 1e3, card=card)
    return out


def make_scene():
    """The synthetic scene at data1's extent (seed SCENE_SEED)."""
    from lsdtpu_torch.io import synth
    return synth.synth_dataset(SCENE_SEED, F=FRAMES, H=979, W=1440,
                               resol=0.025, rmax=13.0, n_walls=46,
                               clear_m=2.5, wall_scale=2.5)


def score_frame_cases(scene, ctx, cfg, device, card, floor_ms, prefix="",
                      frames=("relock", "tracking")):
    """kernel_case on the unpruned and the pruned path at the relock
    frame (frame 0, no prior pose: the full sweep) and a tracking frame
    (frame 1 from the true pose), as the main path builds them."""
    import torch
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.io import synth
    ds = scene.dataset
    sh = cfg.shapes
    dt = ctx.cache.dtype
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
        for path in ("unpruned", "pruned"):
            c = kernel_case(f"{prefix}{frame}_{path}", cand, fs, ctx, cfg,
                            coarse, device, reps=200, card=card,
                            floor_ms=floor_ms)
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
    acts = repeats_bitwise(f"nfa {name}",
                           lambda: onfa.rect_counts(deg_map, scalars), got)
    out["repeats_bitwise"] = 50
    out["kernel_ms"] = time_cuda(lambda: onfa.rect_counts(deg_map, scalars),
                                 reps)
    dev_ms = kernel_device_ms(acts, "rect_counts_kernel")
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
    build.load_libraries(["score", "nfa"])
    for name in ("score", "nfa"):
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
    world = res["pose"][:, :2] * resol + np.array([ds.param.ori_x,
                                                   ds.param.ori_y])
    err = np.linalg.norm(world[tracked] - scene.true_pos[tracked], axis=1)
    med = float(np.median(times))
    phase("rollout_f32", device=repr(kind), power=repr(smi),
          median_ms=med, min_ms=min(times), max_ms=max(times),
          scans_per_s=F / med * 1e3, frames=F,
          tracked=int(tracked.sum()), rmse_m=float(np.sqrt(np.mean(err ** 2))),
          launches=launches, launches_per_frame=launches / (F * REPEATS))

    # where the time goes: one more rollout under the profiler
    wall, acts = device_profile(
        lambda: loop.run_sequence(fr32_dev, ctx32, cfg, device=device))
    busy = sum(v[1] for v in acts.values()) / 1e3
    top = sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]
    score_ms = sum(v[1] for k, v in acts.items()
                   if "score_partials_kernel" in k) / 1e3
    phase("profile_f32", card=repr(smi), wall_ms=wall, device_busy_ms=busy,
          device_idle_share=1.0 - busy / wall,
          device_ops_per_frame=sum(v[0] for v in acts.values()) / F,
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
    world = res["pose"][:, :2] * resol + np.array([ds.param.ori_x,
                                                   ds.param.ori_y])
    err = np.linalg.norm(world[tracked] - scene.true_pos[tracked], axis=1)
    phase("end_to_end_f32", device=repr(kind), power=repr(smi),
          map_prep_s=prep_s, map_lines=int(art.lines_info.shape[0]),
          max_candidates=cfg_e.shapes.max_candidates,
          max_candidates_raised=cfg_e.shapes.max_candidates
          != cfg.shapes.max_candidates,
          candidate_overflow_frames=int(res["candidate_overflow"].sum()),
          rollout_median_ms=float(np.median(times)), min_ms=min(times),
          max_ms=max(times), frames=F, tracked=int(tracked.sum()),
          rmse_m=float(np.sqrt(np.mean(err ** 2))),
          nfa_launches=launches_e["rect_counts"],
          score_launches=launches_e["score_partials"])
    # the CalcScore kernel at this path's relock frame: its largest launch
    e2e_cases = score_frame_cases(scene, ctx_e, cfg_e, device, repr(smi),
                                  floor_ms, prefix="e2e_",
                                  frames=("relock",))

    # --- 8. report -------------------------------------------------------
    main_case = cases[1]      # relock frame as the main path scores it
    kern = {
        "name": "score_partials", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases + e2e_cases),
        "ms": main_case["ms"], "ms_source": main_case["ms_source"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "floor_ms": floor_ms,
        "design": "persistent grid (SMs x resident blocks); a block "
                  "scores one live slot at a time over the whole pixel "
                  "cloud held in registers; warp sums, warps in order, "
                  "no cross-block reduction",
        "cases": cases + e2e_cases,
    }
    top = nfa_runs[0]         # the batch with the most covered pixels
    nfa_kern = {
        "name": "rect_counts", "route": "cuda",
        "source": "lsdtpu_torch/csrc/nfa.cu",
        "replaces": "lsdtpu/ops/nfa_pallas.py:87",
        "checked": True, "launches": launches_e["rect_counts"],
        "max_abs_err": 0.0, "ms": top["ms"], "ms_source": top["ms_source"],
        "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": None,
        "mean_device_ms_per_launch": nfa_dev, "floor_ms": floor_ms,
        "design": "one 512-thread block per rectangle; column bounds, "
                  "block scan of the heights, flat covered index by "
                  "binary search",
        "cases": nfa_runs,
    }
    print(json.dumps({"kernels": [kern, nfa_kern]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
