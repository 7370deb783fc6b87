#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsdtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with one H100

Drives the port's main path - the per-frame localization rollout
(run_sequence) - at the extent of the bundled data1 sequence (a
979x1440 map at 0.025 m/px, 279 frames of 360-ray scans to 13 m) on a
synthetic multi-room scene made from a seed, since no dataset is
mounted on the card's machine.  Phases, each printed on its own line;
any failure exits non-zero before the last line:

  1. device: the card's name, count and power limit (no card: exit 2);
  2. build: nvcc builds csrc/score.cu (seconds, ptxas registers/spills);
  3. scene: the synthetic scene; its distance field from the port's
     create_map_cache on the card; its map lines from the wall segments;
  4. kernel check: the CalcScore kernel against its plain PyTorch
     version on the card, at a relock frame (~1000 candidates) and a
     tracking frame (~40), on the pruned and the unpruned path, with
     times, the bound and the launch counts;
  5. rollout: f64 on the card vs the CPU (identical decisions), then f32
     on the card, 5 repeats timed to value, with the kernel's launch
     count checked against one launch per frame;
  6. a JSON line of the kernels, the nvidia-smi name/power line, and the
     last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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


def kernel_device_ms(acts):
    """Mean device ms per launch of the CalcScore kernel, or None."""
    hits = [v for k, v in acts.items() if "score_partials_kernel" in k]
    if not hits:
        return None
    n = sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3


def kernel_case(name, cand, fs, ctx, cfg, coarse, device, reps, card):
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
    _w, acts = device_profile(
        lambda: [sc.score_partials(*args) for _ in range(50)])
    out["kernel_ms"] = time_cuda(lambda: sc.score_partials(*args), reps)
    dev_ms = kernel_device_ms(acts)
    out["ms"] = out["kernel_ms"] if dev_ms is None else dev_ms
    out["ms_source"] = "cuda events" if dev_ms is None else "profiler"
    out["plain_ms"] = time_cuda(
        lambda: sc.score_partials_reference(*args), max(5, reps // 20))
    phase("kernel_check", **out, bound_us=out["bound_ms"] * 1e3, card=card)
    return out


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
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.ops import build
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop

    # --- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("score")
    log = build.BUILD_LOG.get("score", {})
    usage = re.findall(r"(Used \d+ registers[^\n]*|\d+ bytes spill "
                       r"stores[^\n]*)", log.get("ptxas", ""))
    phase("build", card=repr(smi),
          seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=round(log.get("seconds", 0.0), 3),
          ptxas=repr(" | ".join(usage) or "cached"))

    # --- 3. scene --------------------------------------------------------
    t0 = time.perf_counter()
    scene = synth.synth_dataset(SCENE_SEED, F=FRAMES, H=979, W=1440,
                                resol=0.025, rmax=13.0, n_walls=46,
                                clear_m=2.5, wall_scale=2.5)
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
    sh = cfg.shapes

    # --- 4. kernel check at the main path's shapes (f32) ------------------
    ctx32 = loop.make_map_context(lines, cache64, resol, ds.param.ori_x,
                                  ds.param.ori_y, dtype=np.float32,
                                  device=device)
    coarse = loop.prepare_coarse(ctx32, cfg)
    fr32 = loop.stack_frames(ds, dtype=np.float32, max_frames=2)
    state = loop.init_state(torch.float32, device)
    truth = synth.true_pose_px(scene)
    cases = []
    for f, last in ((0, None), (1, truth[1])):
        inp = tuple(torch.as_tensor(fr32[k][f], device=device)
                    for k in loop._FRAME_KEYS)
        fs = loop.featurize_stage(inp, ctx32, cfg)
        last_pose = state.last_pose if last is None else torch.tensor(
            [last[0], last[1], 0.0], dtype=torch.float32, device=device)
        cand = assoc.generate_candidates(
            fs.lines, fs.lines_mask, ctx32.lines, ctx32.lines_mask,
            loop.geo.c_round(fs.lidar_pos), last_pose, sh.max_candidates,
            cfg.match.ignore_scan_length, cfg.match.scan_to_map_diff,
            cfg.match.max_esti_dist)
        frame = "relock" if last is None else "tracking"
        for path in ("unpruned", "pruned"):
            cases.append(kernel_case(f"{frame}_{path}", cand, fs, ctx32, cfg,
                                     coarse, device, reps=200, card=repr(smi)))
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

    # --- 6. report -------------------------------------------------------
    main_case = cases[1]      # relock frame as the main path scores it
    kern = {
        "name": "score_partials", "route": "cuda",
        "source": "lsdtpu_torch/csrc/score.cu",
        "replaces": "lsdtpu/ops/score_pallas.py:54",
        "checked": True, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "ms_source": main_case["ms_source"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "cases": cases,
    }
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
