"""The port's command-line interface (counterpart of lsdtpu/cli.py).

Subcommands:
  run          offline dataset rollout (the Windows main program,
               LSD/main_on_windows.cpp:16-195) with an ATE summary;
               --mode legacy runs the ROS V2.2 global matcher
  prepare-map  build + cache map artifacts (mapCache + LSD lines)
  refine       rollout + offline pose-graph refinement + ATE compare
  profile      per-stage times of one frame, steady rollout time, and a
               torch.profiler trace
  batch        multi-sequence rollout over a lane axis (or --concat, one
               stream over sequences that share a map)
  serve        robot-fleet replay through the multi-session serving pool
  bench        headline throughput: the data1 rollout timed to value on
               the card, against the C++ reference or the numpy oracle
               (lsdtpu_torch/bench.py)

Example:
  python -m lsdtpu_torch.cli run --data DATASET_DIR
  lsdtpu-torch run --data DATASET_DIR --device cpu

The records and summaries carry the reference CLI's keys, names and
rounding.  Two differences from it:
  * --device {cuda,cpu} (default cuda) replaces --backend: asking for
    the card where there is none exits non-zero; nothing falls back to
    the CPU, bench included (a failed device probe exits non-zero).
  * --mapprep "torch" (the default) is the port's own map prep where the
    reference says "tpu"; "tpu-sharded" (the reference's name: the
    distance field and the wave LSD sharded over the ranks of the
    process group) and "oracle" (the port's copy of the numpy oracle,
    f64 on the host) are as in the reference.

Under torchrun (WORLD_SIZE > 1) every command starts the process group
first (runtime/distributed.initialize); without it the commands run at
world size 1.  batch --concat --temporal S rolls the stream as S
segments (runtime/temporal.py): the lanes of one batched rollout, split
over the ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from lsdtpu_torch import resolve_device, viz
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.eval import ate as eval_ate
from lsdtpu_torch.io import load_dataset
from lsdtpu_torch.io.refdump import dump_map_artifacts
from lsdtpu_torch.refine.pose_graph import (refine_trajectory,
                                            refine_trajectory_distributed)
from lsdtpu_torch.render import render_line_image
from lsdtpu_torch.runtime import distributed
from lsdtpu_torch.runtime.artifacts import prepare_map_cached
from lsdtpu_torch.runtime.batch import run_batch, stack_batch, stack_concat
from lsdtpu_torch.runtime.loop import (_FRAME_KEYS, featurize_stage,
                                       make_map_context, run_sequence,
                                       stack_frames)
from lsdtpu_torch.runtime.online import (LEGACY_Z_OCC_MAX_DIS,
                                         OnlineLocalizer, to_host)
from lsdtpu_torch.runtime.serving import SessionPool
from lsdtpu_torch.runtime.temporal import run_sequence_temporal
from lsdtpu_torch.runtime.trace import device_trace, stage_timings
from lsdtpu_torch.scan.featurize import ScanFeatures

# Config bundles (applied before --set, which can still override any
# field).  "faithful" is the do-nothing default: reference-exact
# semantics.
PRESETS = {
    "faithful": (),
    "robust": ("match.obstacle_tolerance=0.35", "match.coast_on_loss=5",
               "match.relock_margin=0.2"),
    "accuracy": ("faithful=false", "match.polish_pose=true"),
}

# Config fields where None is a meaningful value (--set path=none).
# Everything else rejects 'none' at once instead of storing a None that
# fails later with a context-free error.
OPTIONAL_FIELDS = frozenset({"match.obstacle_min_dist"})

def _add_cfg_args(p):
    p.add_argument("--set", action="append", default=[],
                   metavar="PATH=VALUE", dest="overrides",
                   help="config override, e.g. --set match.score_accept=2.5"
                        " --set faithful=false")
    p.add_argument("--preset", choices=sorted(PRESETS), default="faithful",
                   help="config bundle applied before --set overrides: "
                        "'faithful' (reference-exact, default), 'robust' "
                        "(obstacle tolerance + coast-on-loss + relock "
                        "margin), 'accuracy' (corrected odometry math + "
                        "sub-pixel pose polish)")


def _add_mapprep(p):
    p.add_argument("--mapprep", choices=("torch", "oracle", "tpu-sharded"),
                   default="torch",
                   help="map prep: 'torch', the port's own (on --device); "
                        "'tpu-sharded', the distance field and the wave LSD "
                        "sharded over the ranks of the process group (one "
                        "rank without torchrun); 'oracle', the numpy oracle "
                        "(reference semantics, f64 on the host)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="map-artifact cache directory (default "
                        "~/.cache/lsdtpu_torch; point at a temp dir for "
                        "hermetic runs)")


def _add_common(p):
    p.add_argument("--data", required=True, help="dataset directory")
    _add_mapprep(p)
    p.add_argument("--f64", action="store_true",
                   help="float64 parity mode")
    p.add_argument("--frames", type=int, default=None)
    _add_cfg_args(p)
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="dump run images (map+lines, mapCache, trajectory,"
                        " per-frame scan windows) - the reference's OpenCV"
                        " displays, main_on_windows.cpp:175-178")
    p.add_argument("--viz-frames", type=int, default=3,
                   help="number of per-frame scan images to dump")


def apply_overrides(cfg, pairs):
    """Dotted-path overrides on the frozen EngineConfig tree."""

    def coerce(path, old, s):
        if s.lower() in ("none", "null"):
            # explicit reset of an Optional field only (works even after
            # a prior --set gave it a float value)
            if old is None or path in OPTIONAL_FIELDS:
                return None
            raise ValueError(
                f"--set {path}: {s!r} is not valid for a "
                f"{type(old).__name__} field")
        if isinstance(old, bool):
            return s.lower() in ("1", "true", "yes")
        if old is None:  # e.g. match.obstacle_min_dist (None = cap)
            try:
                return float(s)
            except ValueError:
                raise ValueError(
                    f"--set {path}: cannot parse {s!r} as a float "
                    "(or 'none')") from None
        try:
            return type(old)(s)
        except (ValueError, TypeError):
            raise ValueError(
                f"--set {path}: cannot parse {s!r} as "
                f"{type(old).__name__}") from None

    def set_path(obj, path, value, full):
        head = path[0]
        old = getattr(obj, head)
        if len(path) == 1:
            return dataclasses.replace(
                obj, **{head: coerce(full, old, value)})
        return dataclasses.replace(
            obj, **{head: set_path(old, path[1:], value, full)})

    for pair in pairs:
        path, _, value = pair.partition("=")
        cfg = set_path(cfg, path.split("."), value, path)
    return cfg


def build_cfg(args):
    """Preset bundle first, then explicit --set overrides on top."""
    cfg = apply_overrides(DEFAULT,
                          PRESETS[getattr(args, "preset", "faithful")])
    return apply_overrides(cfg, args.overrides)


def _prepare(args, ds, cfg, z=None, growth=None):
    """(lines_info, map_cache) tensors on the device, cached on disk: the
    port's map prep (f32), or the oracle's arrays in its f64 (the map
    context then casts them once, as the reference CLI does)."""
    backend = getattr(args, "mapprep", "torch")
    return prepare_map_cached(
        ds.map_value, ds.param.resol,
        z_occ_max_dis=cfg.map.z_occ_max_dis if z is None else z,
        cache_dir=args.cache_dir, device=args.device,
        dtype=torch.float64 if backend == "oracle" else torch.float32,
        growth=cfg.lsd.growth if growth is None else growth,
        backend=backend)


def _context(args, ds, lines, cache, cfg, dtype):
    return make_map_context(lines, cache, ds.param.resol, ds.param.ori_x,
                            ds.param.ori_y, dtype=dtype,
                            cache_dtype=cfg.match.cache_dtype,
                            z_occ_max_dis=cfg.map.z_occ_max_dis,
                            device=args.device)


def _np(t):
    return t.detach().cpu().numpy()


def _score(sc):
    return round(sc, 4) if math.isfinite(sc) else None


def _dump_viz(args, ds, lines, cache, outs, cfg, fs_dump=(),
              refined_px=None):
    return viz.dump_run(
        args.viz, ds.map_value, _np(lines), _np(cache), outs,
        ds.param.resol, ds.param.ori_x, ds.param.ori_y,
        real_pos=ds.real_pos, scan_features=fs_dump,
        z_occ_max_dis=cfg.map.z_occ_max_dis, refined_px=refined_px)


def cmd_run(args) -> int:
    cfg = build_cfg(args)
    dtype = np.float64 if args.f64 else np.float32
    if args.mode == "legacy":
        return _run_legacy(args, cfg, dtype)
    ds = load_dataset(args.data)
    t0 = time.perf_counter()
    lines, cache = _prepare(args, ds, cfg)
    print(f"map: {len(lines)} lines, cache {tuple(cache.shape)} "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    ctx = _context(args, ds, lines, cache, cfg, dtype)
    frames = stack_frames(ds, dtype=dtype, max_frames=args.frames)
    t0 = time.perf_counter()
    outs = to_host(run_sequence(frames, ctx, cfg, device=args.device),
                   "cli.outputs")
    dt = time.perf_counter() - t0
    F = frames["ranges"].shape[0]
    poses, scores = outs["pose"], outs["score"]
    coasting, deferred = outs["coasting"], outs["relock_deferred"]
    for f in range(F):
        rec = {"frame": f + 1, "pose": [round(float(v), 3)
                                        for v in poses[f]],
               "score": _score(float(scores[f])),
               "n_candidates": int(outs["n_candidates"][f])}
        if coasting[f]:
            rec["coasting"] = True
        if deferred[f]:
            rec["relock_deferred"] = True
        print(json.dumps(rec))
    summary_flags = {}
    if coasting.any():
        summary_flags["coasted"] = int(coasting.sum())
    if deferred.any():
        summary_flags["relock_deferred"] = int(deferred.sum())
    summary = {"frames": F, "tracked": int(np.isfinite(scores).sum()),
               "wall_s": round(dt, 2),
               "scans_per_sec": round(F / dt, 1), **summary_flags}
    if ds.real_pos is not None:
        a = eval_ate.keyframe_ate(poses, ds.real_pos, ds.recorded_odom,
                                  ds.param.resol, ds.param.ori_x,
                                  ds.param.ori_y)
        if a.n > 0:   # a truncated --frames run may reach no keyframe
            summary["ate_rmse_m"] = round(a.rmse, 4)
            summary["ate_max_m"] = round(a.max, 4)
        summary["ate_keyframes"] = a.n
    if args.viz:
        fs_dump = []
        for f in range(min(args.viz_frames, F)):
            fi = tuple(torch.as_tensor(frames[k][f], device=args.device)
                       for k in _FRAME_KEYS)
            fs = featurize_stage(fi, ctx, cfg)
            fs_dump.append((f + 1, ScanFeatures(**{
                k.name: _np(getattr(fs, k.name))
                for k in dataclasses.fields(fs)})))
        summary["viz"] = _dump_viz(args, ds, lines, cache, outs, cfg,
                                   fs_dump)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _run_legacy(args, cfg, dtype) -> int:
    """ROS-generation loop: the global first-minimum matcher per frame."""
    ds = load_dataset(args.data)
    lines, cache = _prepare(args, ds, cfg, z=LEGACY_Z_OCC_MAX_DIS,
                            growth="wave")
    loc = OnlineLocalizer(cfg=cfg, mode="legacy", dtype=dtype,
                          device=args.device)
    loc.set_map_artifacts(lines, cache, ds.param.resol, ds.param.ori_x,
                          ds.param.ori_y)
    F = len(ds.frames) if args.frames is None else \
        min(args.frames, len(ds.frames))
    tracked = 0
    for f in range(F):
        fr = ds.frames[f]
        out = loc.push_scan(fr[:, 0], fr[:, 1])
        sc = float(out["score"])
        tracked += int(np.isfinite(sc))
        print(json.dumps({
            "frame": f + 1,
            "pose": [round(float(v), 3) for v in out["pose"]],
            "pose_world": [round(float(v), 3) for v in out["pose_world"]],
            "score": _score(sc)}))
    print(json.dumps({"frames": F, "tracked": tracked}), file=sys.stderr)
    return 0


def cmd_prepare_map(args) -> int:
    cfg = build_cfg(args)
    ds = load_dataset(args.data)
    t0 = time.perf_counter()
    lines, cache = _prepare(args, ds, cfg)
    dumped = None
    if args.dump:
        rows_, cols_ = ds.map_value.shape
        # default max_steps = max(rows, cols)+2: never truncates
        line_im = render_line_image(
            lines, torch.ones(len(lines), dtype=torch.bool,
                              device=lines.device), rows_, cols_)
        dumped = dump_map_artifacts(args.dump, _np(lines), _np(cache),
                                    _np(line_im))
    print(json.dumps({"lines": len(lines),
                      "cache_shape": list(cache.shape),
                      "seconds": round(time.perf_counter() - t0, 2),
                      **({"dumped": dumped} if dumped else {})}))
    return 0


def refine_inputs(outs, segments: int):
    """(meas, scores, scan_pose) float64 numpy arrays of a rollout's
    outputs for the pose-graph solve; with segments > 1, padded with
    zero-weight frames (NaN measurement, inf score, zero odometry) to the
    segment grid of refine_trajectory_distributed (F % segments == 0,
    F // segments >= 2)."""
    meas = outs["measurement"].astype(np.float64)
    scores = outs["score"].astype(np.float64)
    u = outs["scan_pose"].astype(np.float64)
    F = meas.shape[0]
    if segments > 1 and (F % segments or F // segments < 2):
        pad = (-F) % segments
        if F // segments < 2:
            pad = max(pad, 2 * segments - F)
            pad += (-(F + pad)) % segments
        meas = np.concatenate([meas, np.full((pad, 3), np.nan)])
        scores = np.concatenate([scores, np.full((pad,), np.inf)])
        u = np.concatenate([u, np.zeros((pad, 3))])
    return meas, scores, u


def cmd_refine(args) -> int:
    """Rollout + offline batch pose-graph refinement + ATE compare."""
    cfg = build_cfg(args)
    dtype = np.float64 if args.f64 else np.float32
    ds = load_dataset(args.data)
    lines, cache = _prepare(args, ds, cfg)
    ctx = _context(args, ds, lines, cache, cfg, dtype)
    frames = stack_frames(ds, dtype=dtype, max_frames=args.frames)
    outs = to_host(run_sequence(frames, ctx, cfg, device=args.device),
                   "cli.outputs")
    F = outs["pose"].shape[0]
    segments = args.segments
    meas, scores, u = refine_inputs(outs, segments)
    if segments > 1:
        refined, info = refine_trajectory_distributed(
            meas, scores, u, n_segments=segments, device=args.device)
    else:
        refined, info = refine_trajectory(meas, scores, u,
                                          device=args.device)
    refined = _np(refined)[:F]
    rec = {"frames": F, "n_measured": int(info["n_measured"]),
           "segments": segments}
    if ds.real_pos is not None:
        for name, poses in (("online", outs["pose"]), ("refined", refined)):
            a = eval_ate.keyframe_ate(poses, ds.real_pos,
                                      ds.recorded_odom, ds.param.resol,
                                      ds.param.ori_x, ds.param.ori_y)
            rec[f"ate_{name}_rmse_m"] = round(a.rmse, 4)
    if args.viz:
        rec["viz"] = _dump_viz(args, ds, lines, cache, outs, cfg,
                               refined_px=refined)
    print(json.dumps(rec))
    return 0


def cmd_bench(args) -> int:
    from lsdtpu_torch import bench
    return bench.main(device=args.device)


def cmd_profile(args) -> int:
    """Observability: per-stage wall times of one frame
    (runtime/trace.py harness), the rollout's first and steady times, and
    an optional torch.profiler trace - where the reference has only a
    run-level clock() (main_on_windows.cpp:17-18, 189-190)."""
    cfg = build_cfg(args)
    dtype = np.float64 if args.f64 else np.float32
    ds = load_dataset(args.data)
    lines, cache = _prepare(args, ds, cfg)
    ctx = _context(args, ds, lines, cache, cfg, dtype)
    frames = stack_frames(ds, dtype=dtype, max_frames=args.frames)
    F = frames["ranges"].shape[0]
    f = min(max(args.frame, 0), F - 1)
    fi = tuple(frames[k][f] for k in _FRAME_KEYS)
    st = stage_timings(fi, ctx, cfg, repeats=args.repeats,
                       device=args.device)
    print(json.dumps({"per_stage_ms": {k: round(v, 4)
                                       for k, v in st.items()},
                      "frame": f,
                      "note": "stages timed separately to value, incl. "
                              "launch overhead; relative costs only"}))
    with device_trace(args.trace):
        # time to value: the poses are read on the host
        t0 = time.perf_counter()
        _np(run_sequence(frames, ctx, cfg, device=args.device)["pose"])
        t_first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            _np(run_sequence(frames, ctx, cfg, device=args.device)["pose"])
            best = min(best, time.perf_counter() - t0)
    rec = {"frames": F, "compile_plus_first_s": round(t_first, 2),
           "steady_ms": round(best * 1e3, 3),
           "scans_per_sec": round(F / best, 1)}
    if args.trace:
        rec["trace_dir"] = args.trace
    print(json.dumps(rec))
    return 0


def cmd_batch(args) -> int:
    cfg = build_cfg(args)
    if args.temporal > 1 and not args.concat:
        print("--temporal requires --concat (the segment-parallel "
              "replay runs over one concatenated stream)", file=sys.stderr)
        return 2
    dss = [load_dataset(p) for p in args.data]
    arts = [_prepare(args, d, cfg) for d in dss]
    if args.concat:
        # corpus replay: one frame loop over all sequences (they must
        # share the map; each equals its standalone rollout)
        for d in dss[1:]:
            if not np.array_equal(d.map_value, dss[0].map_value):
                print("--concat needs all sequences on one map",
                      file=sys.stderr)
                return 2
        ctx = _context(args, dss[0], *arts[0], cfg, np.float32)
        frames, bounds = stack_concat(dss)
        t0 = time.perf_counter()
        if args.temporal > 1:
            # segment-parallel replay: S cold-started segments as lanes,
            # split over the ranks (px-level warmup tolerance against the
            # sequential chain)
            sc = run_sequence_temporal(frames, ctx, cfg=cfg,
                                       n_segments=args.temporal,
                                       device=args.device)["score"]
        else:
            sc = _np(run_sequence(frames, ctx, cfg, device=args.device)
                     ["score"])
        dt = time.perf_counter() - t0
        for b in range(len(dss)):
            lo, hi = bounds[b], bounds[b + 1]
            print(json.dumps({
                "seq": args.data[b], "frames": int(hi - lo),
                "tracked": int(np.isfinite(sc[lo:hi]).sum())}))
        total = int(bounds[-1])
    else:
        frames, ctxs, lens = stack_batch(dss, arts, cfg,
                                         cache_dtype=cfg.match.cache_dtype,
                                         device=args.device)
        t0 = time.perf_counter()
        sc = _np(run_batch(frames, ctxs, cfg, device=args.device)["score"])
        dt = time.perf_counter() - t0
        total = int(lens.sum())
        for b, n in enumerate(lens):
            print(json.dumps({
                "seq": args.data[b], "frames": int(n),
                "tracked": int(np.isfinite(sc[b][:n]).sum())}))
    print(json.dumps({"total_scans": total, "wall_s": round(dt, 2),
                      "scans_per_sec": round(total / dt, 1)}),
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Fleet replay through the multi-session serving pool: one robot per
    dataset, every tick one batched step for all robots."""
    cfg = build_cfg(args)
    dss = [load_dataset(p) for p in args.data]
    arts = [_prepare(args, d, cfg) for d in dss]
    H = max(a[1].shape[0] for a in arts)
    W = max(a[1].shape[1] for a in arts)
    pool = SessionPool(capacity=len(dss), canvas_hw=(H, W), cfg=cfg,
                       device=args.device)
    for i, (ds, (lines, cache)) in enumerate(zip(dss, arts)):
        pool.open_session(f"robot{i}", lines, cache, ds.param.resol,
                          ds.param.ori_x, ds.param.ori_y)
    F = max(len(ds.frames) for ds in dss)
    if args.frames is not None:
        F = min(F, args.frames)
    poses = [[] for _ in dss]
    scores = [[] for _ in dss]
    n_scans = 0
    t0 = time.perf_counter()
    for f in range(F):
        for i, ds in enumerate(dss):
            # stack_frames' guard: a dataset can have fewer odometry rows
            # than lidar frames
            if f < len(ds.frames) and f + 1 < ds.odom.shape[0]:
                fr = ds.frames[f]
                pool.submit_scan(f"robot{i}", fr[:, 0], fr[:, 1],
                                 ds.odom[f + 1])
                n_scans += 1
        res = pool.step()
        for i in range(len(dss)):
            out = res.get(f"robot{i}")
            if out is not None:
                poses[i].append(out["pose"])
                scores[i].append(float(out["score"]))
    dt = time.perf_counter() - t0
    for i, ds in enumerate(dss):
        rec = {"robot": i, "seq": args.data[i], "frames": len(poses[i]),
               "tracked": int(np.isfinite(scores[i]).sum())}
        if ds.real_pos is not None and poses[i]:
            a = eval_ate.keyframe_ate(
                np.stack(poses[i]), ds.real_pos, ds.recorded_odom,
                ds.param.resol, ds.param.ori_x, ds.param.ori_y)
            if np.isfinite(a.rmse):
                rec["ate_rmse_m"] = round(a.rmse, 4)
        print(json.dumps(rec))
    print(json.dumps({"robots": len(dss), "ticks": F,
                      "total_scans": n_scans, "wall_s": round(dt, 2),
                      "scans_per_sec": round(n_scans / dt, 1)}),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lsdtpu-torch",
        description="The PyTorch/CUDA port's commands.  --device cuda (the "
                    "default) runs on the card and exits non-zero where "
                    "there is none; --device cpu runs the plain PyTorch "
                    "path.  --mapprep torch is the port's own map prep "
                    "(the reference's tpu); tpu-sharded and oracle are the "
                    "reference's.  Under torchrun the commands start the "
                    "process group first.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs: 'cuda' (default; exits "
                         "non-zero without a card, never falls back) or "
                         "'cpu' (the plain PyTorch path); replaces the "
                         "reference CLI's --backend")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="offline dataset rollout")
    _add_common(p)
    p.add_argument("--mode", choices=("tracking", "legacy"),
                   default="tracking",
                   help="tracking = Windows V2.6 pipeline (HMM+UKF); "
                        "legacy = ROS V2.2 global matcher")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("prepare-map", help="build + cache map artifacts")
    _add_common(p)
    p.add_argument("--dump", default=None, metavar="DIR",
                   help="also write the artifacts in the C++ reference's "
                        "text formats (MaplinesInfo.txt, mapCache.txt, "
                        "MaplineIm.txt) for interop")
    p.set_defaults(fn=cmd_prepare_map)

    p = sub.add_parser("refine", help="offline pose-graph smoothing")
    _add_common(p)
    p.add_argument("--segments", type=int, default=1,
                   help=">1 uses the segment-parallel Schur solver")
    p.set_defaults(fn=cmd_refine)

    p = sub.add_parser(
        "bench", help="headline throughput benchmark: the data1 rollout "
                      "timed to value (median of 5) on --device, one JSON "
                      "line; a failed device probe exits non-zero, never "
                      "falls back to the CPU (lsdtpu_torch/bench.py)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("profile", help="per-stage timing + device trace")
    _add_common(p)
    p.add_argument("--frame", type=int, default=5,
                   help="frame index for the per-stage harness")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace "
                        "(DIR/trace.json; chrome://tracing or Perfetto)")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("batch", help="batched multi-sequence rollout")
    p.add_argument("--data", nargs="+", required=True)
    _add_mapprep(p)
    p.add_argument("--concat", action="store_true",
                   help="corpus replay: ONE frame loop over all sequences "
                        "(must share the map) instead of a lane batch")
    p.add_argument("--temporal", type=int, default=1, metavar="S",
                   help="with --concat: segment-parallel replay of the "
                        "stream as S segments (the lanes of one batched "
                        "rollout, split over the ranks of the process "
                        "group)")
    _add_cfg_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("serve", help="robot-fleet replay through the "
                                     "multi-session serving pool")
    p.add_argument("--data", nargs="+", required=True,
                   help="one dataset directory per robot")
    _add_mapprep(p)
    p.add_argument("--frames", type=int, default=None)
    _add_cfg_args(p)
    p.set_defaults(fn=cmd_serve)

    # accept --device after the subcommand too (`lsdtpu-torch run
    # --device cpu`): SUPPRESS keeps the main parser's value unless given
    for sp in sub.choices.values():
        sp.add_argument("--device", choices=("cuda", "cpu"),
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)

    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"lsdtpu-torch: {e}", file=sys.stderr)
        return 2
    # under torchrun: the process group first (world size 1: nothing)
    distributed.initialize(device=args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
