"""Per-frame localization step and full-sequence rollout on tensors
(counterpart of lsdtpu/runtime/loop.py).

Reference: the main loop LSD/main_on_windows.cpp:105-185.  A frame is
scan featurization, candidate generation, scoring (the CalcScore kernel
on the card), fusion, the main loop's state machine and the UKF.  A
sequence is a Python loop over frames of static-shape tensors sized by
ShapeConfig; everything stays on the device, and the host syncs only on
the RDP fixpoint test and the pruning gate's live-count read.

The reference package's execution strategies ``prefeaturize`` and
``scan_unroll`` (which give identical outputs there) do not apply to a
frame loop and are ignored.  ``polish_pose`` and the tp/mp sharding
arguments are not ported yet and raise NotImplementedError.

Faithful-mode quirks (config.faithful):
  * odometry rotation bug ScanPose.y = ty*sind(th) + ty*cosd(th)
    (main_on_windows.cpp:151);
  * the is_offset 360-degree angle fix triggered on frame 1
    (main_on_windows.cpp:165-172).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.filter import ukf as fukf
from lsdtpu_torch.match import associate as assoc
from lsdtpu_torch.scan.featurize import featurize


@dataclasses.dataclass
class MapContext:
    """Per-map static inputs of the rollout.  rows/cols are the true map
    dims (the in-map test, myFA.cpp:372, uses the real extent)."""

    lines: torch.Tensor       # (M, 10)
    lines_mask: torch.Tensor  # (M,) bool
    cache: torch.Tensor       # (H, W) distance field (meters, capped)
    rows: int                 # true height
    cols: int                 # true width
    resol: torch.Tensor       # () scalars of the working dtype
    ori_x: torch.Tensor
    ori_y: torch.Tensor


@dataclasses.dataclass
class TrackState:
    """Main-loop + filter carry (the reference's main()-local state)."""

    kalman_x: torch.Tensor    # (9,)
    kalman_P: torch.Tensor    # (9, 9)
    last_pose: torch.Tensor   # (3,)
    ang_sum: torch.Tensor     # () running sum of angRotate
    ang_cnt: torch.Tensor     # () int32
    is_offset: torch.Tensor   # () bool
    frame: torch.Tensor       # () int32, 1-based after the first step
    lost_streak: torch.Tensor  # () int32 consecutive no-candidate frames


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def init_state(dtype=torch.float32, device="cuda") -> TrackState:
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    return TrackState(
        kalman_x=torch.as_tensor(fukf.RESET_X, dtype=dt, device=dev),
        kalman_P=torch.as_tensor(fukf.RESET_P, dtype=dt, device=dev),
        last_pose=torch.tensor([-1.0, -1.0, 0.0], dtype=dt, device=dev),
        ang_sum=torch.zeros((), dtype=dt, device=dev),
        ang_cnt=torch.zeros((), dtype=torch.int32, device=dev),
        is_offset=torch.zeros((), dtype=torch.bool, device=dev),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        lost_streak=torch.zeros((), dtype=torch.int32, device=dev))


def reset_carry(carry: TrackState, fr: dict) -> TrackState:
    """Corpus-replay re-initialization: a True "reset" flag marks the
    first frame of a concatenated sequence, and the carry is replaced by
    the initial state."""
    if "reset" not in fr:
        return carry
    init = init_state(fr["ranges"].dtype, fr["ranges"].device)
    return TrackState(*(
        torch.where(fr["reset"], getattr(init, f.name), getattr(carry, f.name))
        for f in dataclasses.fields(TrackState)))


def featurize_stage(frame_inputs, ctx: MapContext,
                    cfg: EngineConfig = DEFAULT):
    """Scan featurization only (L3 of the reference).
    frame_inputs: (ranges, angles, valid, n, odom_prev, odom_cur)."""
    ranges, angles, valid, n, _op, _oc = frame_inputs
    sh = cfg.shapes
    return featurize(ranges, angles, valid, n, ctx.resol, ctx.ori_x,
                     ctx.ori_y,
                     least_point=cfg.rdp.least_point,
                     thre_line=cfg.rdp.thre_line,
                     least_dist=cfg.rdp.least_dist,
                     max_lines=sh.max_scan_lines,
                     max_pixels=sh.max_scan_pixels,
                     max_steps=sh.max_scan_steps)


def localization_step(state: TrackState, frame_inputs, ctx: MapContext,
                      cfg: EngineConfig = DEFAULT,
                      tp_axis: Optional[str] = None,
                      mp_axis: Optional[str] = None,
                      coarse=None) -> Tuple[TrackState, dict]:
    """One frame: featurize + associate + fuse + UKF + state update.

    frame_inputs: (ranges (N,), angles (N,), valid (N,), n (),
    odom_prev (3,), odom_cur (3,)) tensors on the context's device.
    coarse: the per-map pruning field (prepare_coarse) or None."""
    fs = featurize_stage(frame_inputs, ctx, cfg)
    return match_stage(state, fs, frame_inputs, ctx, cfg,
                       tp_axis=tp_axis, mp_axis=mp_axis, coarse=coarse)


def prepare_coarse(ctx: MapContext, cfg: EngineConfig = DEFAULT):
    """The per-map pruning field, or None when pruning is off; computed
    once per rollout."""
    if not cfg.match.prune:
        return None
    return assoc.coarse_field(ctx.cache, cfg.match.prune_block)


def match_stage(state: TrackState, fs, frame_inputs, ctx: MapContext,
                cfg: EngineConfig = DEFAULT,
                tp_axis: Optional[str] = None,
                mp_axis: Optional[str] = None,
                coarse=None, cand=None) -> Tuple[TrackState, dict]:
    """Association + fusion + UKF + tracking state (L4/L5 of the
    reference) on precomputed ScanFeatures.  cand: optional
    pre-generated Candidates for this (state, fs) pair."""
    if tp_axis is not None or mp_axis is not None:
        raise NotImplementedError("tp/mp sharding is not ported yet")
    if cfg.match.polish_pose:
        raise NotImplementedError("match.polish_pose is not ported yet")
    ranges, angles, valid, n, odom_prev, odom_cur = frame_inputs
    sh = cfg.shapes
    dt = ranges.dtype
    dev = ranges.device

    # --- ScanPose from odometry (main_on_windows.cpp:132-153) ---
    is_first = torch.abs(state.kalman_x[0] + 1) < 1e-4
    theta = state.ang_sum / state.ang_cnt.clamp(min=1).to(dt)
    tx = (odom_cur[0] - odom_prev[0]) / ctx.resol
    ty = (odom_cur[1] - odom_prev[1]) / ctx.resol
    tang = geo.atand(odom_cur[2] - odom_prev[2])
    sp_x = tx * geo.cosd(theta) - ty * geo.sind(theta)
    if cfg.faithful:
        sp_y = ty * geo.sind(theta) + ty * geo.cosd(theta)  # reference bug
    else:
        sp_y = tx * geo.sind(theta) + ty * geo.cosd(theta)
    scan_pose = torch.where(is_first, torch.zeros(3, dtype=dt, device=dev),
                            torch.stack([sp_x, sp_y, tang]))

    # --- association (trans2FA rounds the lidar pose, :229-230) ---
    lidar_pose = geo.c_round(fs.lidar_pos)
    if cand is None:
        cand = assoc.generate_candidates(
            fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
            lidar_pose, state.last_pose,
            max_candidates=sh.max_candidates,
            ignore_scan_length=cfg.match.ignore_scan_length,
            scan_to_map_diff=cfg.match.scan_to_map_diff,
            max_esti_dist=cfg.match.max_esti_dist)
    scores = assoc.score_candidates(
        cand, fs.pixels, fs.pixels_mask, ctx.cache,
        rows=ctx.rows, cols=ctx.cols,
        z_occ_max_dis=cfg.map.z_occ_max_dis,
        max_dist_penalty=cfg.match.max_dist_penalty,
        valid_ratio=cfg.match.valid_ratio,
        dynamic_chunks=cfg.match.score_dynamic_chunks,
        obstacle_tolerance=cfg.match.obstacle_tolerance,
        obstacle_min_dist=cfg.match.obstacle_min_dist,
        coarse=coarse if cfg.match.prune else None,
        prune_accept=cfg.match.score_accept,
        prune_block=cfg.match.prune_block,
        prune_group=cfg.match.prune_group,
        prune_min_live=cfg.match.prune_min_live,
        window=cfg.match.score_window)
    # faithful: a perfect (score 0) candidate NaN-poisons the fused pose
    # exactly like the reference's inf weight (myFA.cpp:161)
    pose_w, fused_score, pose_min, min_score, n_acc = assoc.fuse(
        cand, scores, cfg.match.score_accept,
        score_floor=0.0 if cfg.faithful else 1e-6)

    # --- three-way outcome (myFA.cpp:69-175) ---
    lost = n_acc == 0
    # the first-frame branch tolerates |x+1| < 1e-4 (myFA.cpp:99), unlike
    # the gate's exact == -1 escape (myFA.cpp:330)
    hmm_first = torch.abs(state.last_pose[0] + 1) < 1e-4

    if cfg.match.relock_margin > 0.0:
        ambig = assoc.relock_ambiguity(
            cand, scores, pose_min, min_score,
            min_dist=cfg.match.max_esti_dist,
            margin=cfg.match.relock_margin,
            score_accept=cfg.match.score_accept)
        # a deferred relock behaves like a lost frame: the chain stays at
        # the sentinel and retries globally next frame
        deferred = hmm_first & ~lost & ambig
        lost = lost | deferred
    else:
        deferred = torch.zeros((), dtype=torch.bool, device=dev)

    ukf_x, ukf_P = fukf.ukf_step(state.kalman_x, state.kalman_P,
                                 scan_pose, pose_w,
                                 alpha=cfg.filter.alpha,
                                 beta=cfg.filter.beta,
                                 kappa=cfg.filter.kappa,
                                 dt_step=cfg.filter.dt)
    first_x = torch.cat([pose_min, state.kalman_x[3:]])
    reset_x = torch.as_tensor(fukf.RESET_X, dtype=dt, device=dev)
    reset_P = torch.as_tensor(fukf.RESET_P, dtype=dt, device=dev)
    new_x = torch.where(lost, reset_x,
                        torch.where(hmm_first, first_x, ukf_x))
    new_P = torch.where(lost, reset_P,
                        torch.where(hmm_first, state.kalman_P, ukf_P))
    out_score = torch.where(lost, torch.inf,
                            torch.where(hmm_first, min_score, fused_score))

    # --- coast-on-loss (opt-in; no reference equivalent): up to C
    # consecutive lost frames dead-reckon on the rotated odometry delta
    # instead of the reference's global reset (myFA.cpp:69-89)
    streak = torch.where(lost, state.lost_streak + 1,
                         torch.zeros((), dtype=torch.int32, device=dev))
    if cfg.match.coast_on_loss > 0:
        coast = lost & ~is_first & (streak <= cfg.match.coast_on_loss)
        coast_x = torch.cat([state.kalman_x[:3] + scan_pose,
                             state.kalman_x[3:]])
        coast_P = state.kalman_P + torch.as_tensor(
            fukf.process_noise(), dtype=dt, device=dev)
        new_x = torch.where(coast, coast_x, new_x)
        new_P = torch.where(coast, coast_P, new_P)
    else:
        coast = torch.zeros((), dtype=torch.bool, device=dev)

    # --- angRotate bookkeeping (main_on_windows.cpp:165-172) ---
    frame = state.frame + 1
    ang_diff = new_x[2] - geo.atand(odom_cur[2])
    is_offset = state.is_offset | ((torch.abs(ang_diff) > 90) & (frame == 1))
    ang_diff = torch.where(is_offset & (ang_diff < 0), ang_diff + 360,
                           ang_diff)

    new_state = TrackState(
        kalman_x=new_x, kalman_P=new_P, last_pose=new_x[:3],
        ang_sum=state.ang_sum + ang_diff, ang_cnt=state.ang_cnt + 1,
        is_offset=is_offset, frame=frame, lost_streak=streak)
    outputs = {
        "pose": new_x[:3],
        "score": out_score,
        "n_candidates": n_acc,
        "n_scan_lines": fs.lines_mask.sum(),
        "candidate_overflow": (cand.count > cand.mask.shape[0]) | fs.overflow,
        "coasting": coast,
        "relock_deferred": deferred,
        # the FA measurement (weighted-mean pose) and the rotated
        # odometry delta fed to the filter
        "measurement": torch.where(lost, torch.nan, pose_w),
        "scan_pose": scan_pose,
    }
    return new_state, outputs


_FRAME_KEYS = ("ranges", "angles", "valid", "n", "odom_prev", "odom_cur")


def run_sequence(frames, ctx: MapContext, cfg: EngineConfig = DEFAULT,
                 device="cuda"):
    """Whole-sequence rollout: a Python loop over frames.

    frames: dict of stacked per-frame inputs with a leading frame axis
    (numpy arrays or tensors): ranges (F, N), angles (F, N), valid
    (F, N), n (F,), odom_prev (F, 3), odom_cur (F, 3), optional reset
    (F,).  ctx must live on ``device``.  Returns a dict of stacked
    per-frame output tensors on the device (pose (F, 3), score (F,),
    ...).  On the card the caller keeps
    torch.backends.cuda.matmul.allow_tf32 False (PyTorch's default):
    ukf_step raises otherwise."""
    dev = resolve_device(device)
    if ctx.cache.device.type != dev.type:
        raise ValueError(f"ctx lives on {ctx.cache.device}, not {dev}")
    fr = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                             device=dev) for k, v in frames.items()}
    state = init_state(fr["ranges"].dtype, dev)
    coarse = prepare_coarse(ctx, cfg)
    outs = []
    for f in range(fr["ranges"].shape[0]):
        fr_f = {k: v[f] for k, v in fr.items()}
        state = reset_carry(state, fr_f)
        state, out = localization_step(
            state, tuple(fr_f[k] for k in _FRAME_KEYS), ctx, cfg,
            coarse=coarse)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def stack_frames(ds, dtype=np.float32, points_per_scan: int = 360,
                 max_frames: Optional[int] = None) -> dict:
    """Host-side: pad + stack a Dataset's frames for run_sequence."""
    F = min(len(ds.frames), ds.odom.shape[0] - 1)
    if max_frames is not None:
        F = min(F, max_frames)
    N = points_per_scan
    ranges = np.zeros((F, N), dtype)
    angles = np.zeros((F, N), dtype)
    valid = np.zeros((F, N), bool)
    counts = np.zeros((F,), np.int32)
    for f in range(F):
        fr = ds.frames[f]
        k = min(len(fr), N)
        ranges[f, :k] = fr[:k, 0]
        angles[f, :k] = fr[:k, 1]
        valid[f, :k] = True
        counts[f] = k
    odom = ds.odom.astype(dtype)
    return {
        "ranges": ranges, "angles": angles, "valid": valid, "n": counts,
        "odom_prev": odom[0:F], "odom_cur": odom[1:F + 1],
    }


def make_map_context(map_lines, map_cache, resol: float, ori_x: float,
                     ori_y: float, max_map_lines: Optional[int] = None,
                     dtype=np.float32, cache_dtype: str = "f32",
                     z_occ_max_dis: float = 1.0,
                     device="cuda") -> MapContext:
    """Pad map artifacts into a MapContext on ``device``.

    map_lines: (k, 10) linesInfo rows; map_cache: (H, W) field (numpy
    or tensor).  max_map_lines None sizes the pad to the line count
    rounded up to a multiple of 64 (min 64); padding never passes the
    gates.  cache_dtype: "f32" (the float field at ``dtype``)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    map_lines = np.asarray(map_lines)
    k = int(map_lines.shape[0])
    M = max(64, -(-k // 64) * 64) if max_map_lines is None else max_map_lines
    if k > M:
        raise ValueError(f"map has {k} lines > max_map_lines={M}; "
                         "raise the cap (or pass max_map_lines=None "
                         "to auto-size)")
    lines = torch.zeros((M, 10), dtype=dt, device=dev)
    lines[:k] = torch.as_tensor(map_lines, device=dev).to(dt)
    mask = torch.arange(M, device=dev) < k
    cache = torch.as_tensor(map_cache, device=dev)
    return MapContext(
        lines=lines, lines_mask=mask,
        cache=assoc.quantize_cache(cache, cache_dtype, z_occ_max_dis,
                                   float_dtype=dt).contiguous(),
        rows=int(cache.shape[0]), cols=int(cache.shape[1]),
        resol=torch.tensor(resol, dtype=dt, device=dev),
        ori_x=torch.tensor(ori_x, dtype=dt, device=dev),
        ori_y=torch.tensor(ori_y, dtype=dt, device=dev))
