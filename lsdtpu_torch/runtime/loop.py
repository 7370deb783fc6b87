"""Per-frame localization step and full-sequence rollout on tensors
(counterpart of lsdtpu/runtime/loop.py).

Reference: the main loop LSD/main_on_windows.cpp:105-185.  A frame is
scan featurization, candidate generation, scoring (the CalcScore kernel
on the card), fusion, the main loop's state machine and the UKF.  A
sequence is a Python loop over frames of static-shape tensors sized by
ShapeConfig; everything stays on the device, and the host syncs only on
the RDP fixpoint test, the pruning gate's live-count read and, with
match.score_window, the windowed scorer's fits decision (one read).

The step takes leading lane axes ``...``: none for one robot
(run_sequence, OnlineLocalizer), (B,) for B robots at once
(runtime/batch.py, runtime/serving.py), with a batched MapContext
(lines (B, M, 10), the (B, H, W) canvas, rows/cols (B,) int32 tensors,
resol/ori (B,)) and a TrackState of (B, ...) tensors.  Each lane's
reductions run along its own axes, never across lanes; a batch runs
under ``batched_cfg`` (no pruning-gate or window host read) and scores
all lanes in one CalcScore launch.

The reference package's execution strategies (``prefeaturize``,
``scan_unroll``) are rollout's arguments, which run_sequence and
runtime/batch.run_batch read from the config as the reference's
run_sequence and run_batch do; the outputs are the plain loop's bit for
bit.  ``match.polish_pose`` polishes both measurement paths after fusion
(match/polish.py).

The tp/mp arguments (runtime/collectives.Axis, one per rank of the
sharded runners in runtime/shard.py) shard the step over ranks: with
``tp_axis`` each rank holds a block of the map lines, its candidates
are fused with one psum (match/associate.fuse) and the overflow flag
is a pmax; with ``mp_axis`` each rank holds a row block of the field,
scores every candidate unpruned over it, and the four partials are
psummed.  Both default to ``Axis.none()``; a one-rank axis is the
unsharded step (one rank of an mp mesh holds the whole field, so it
scores pruned and may polish).

Faithful-mode quirks (config.faithful):
  * odometry rotation bug ScanPose.y = ty*sind(th) + ty*cosd(th)
    (main_on_windows.cpp:151);
  * the is_offset 360-degree angle fix triggered on frame 1
    (main_on_windows.cpp:165-172).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.filter import ukf as fukf
from lsdtpu_torch.match import associate as assoc
from lsdtpu_torch.match import polish
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.collectives import Axis
from lsdtpu_torch.scan.featurize import ScanFeatures, featurize


@dataclasses.dataclass
class MapContext:
    """Per-map static inputs of the rollout.  rows/cols are the true map
    dims (the in-map test, myFA.cpp:372, uses the real extent).  A
    batched context has a leading lane axis on every tensor, and
    rows/cols are (B,) int32 tensors on the device."""

    lines: torch.Tensor       # (M, 10)
    lines_mask: torch.Tensor  # (M,) bool
    cache: torch.Tensor       # (H, W) distance field (meters, capped)
    rows: Union[int, torch.Tensor]   # true height
    cols: Union[int, torch.Tensor]   # true width
    resol: torch.Tensor       # () scalars of the working dtype
    ori_x: torch.Tensor
    ori_y: torch.Tensor


@dataclasses.dataclass
class TrackState:
    """Main-loop + filter carry (the reference's main()-local state);
    a batch's fields carry a leading lane axis."""

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


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy dtype."""
    return np.dtype(str(torch_dtype(dtype)).split(".")[1])


def init_state(dtype=torch.float32, device="cuda",
               lanes: Optional[int] = None) -> TrackState:
    """The initial carry; with ``lanes``, one per lane ((B, ...))."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    st = TrackState(
        kalman_x=torch.as_tensor(fukf.RESET_X, dtype=dt, device=dev),
        kalman_P=torch.as_tensor(fukf.RESET_P, dtype=dt, device=dev),
        last_pose=torch.tensor([-1.0, -1.0, 0.0], dtype=dt, device=dev),
        ang_sum=torch.zeros((), dtype=dt, device=dev),
        ang_cnt=torch.zeros((), dtype=torch.int32, device=dev),
        is_offset=torch.zeros((), dtype=torch.bool, device=dev),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        lost_streak=torch.zeros((), dtype=torch.int32, device=dev))
    if lanes is None:
        return st
    return TrackState(*(
        getattr(st, f.name).expand((lanes,) + getattr(st, f.name).shape)
        .clone() for f in dataclasses.fields(TrackState)))


def reset_carry(carry: TrackState, fr: dict) -> TrackState:
    """Corpus-replay re-initialization: a True "reset" flag marks the
    first frame of a concatenated sequence, and the carry (of each lane
    whose flag is set) is replaced by the initial state."""
    if "reset" not in fr:
        return carry
    init = init_state(fr["ranges"].dtype, fr["ranges"].device)
    return TrackState(*(
        geo.lane_where(fr["reset"], getattr(init, f.name),
                       getattr(carry, f.name))
        for f in dataclasses.fields(TrackState)))


def featurize_stage(frame_inputs, ctx: MapContext,
                    cfg: EngineConfig = DEFAULT):
    """Scan featurization only (L3 of the reference).
    frame_inputs: (ranges, angles, valid, n, odom_prev, odom_cur)."""
    ranges, angles, valid, n, _op, _oc = frame_inputs
    sh = cfg.shapes
    with trace.span("step.featurize"):
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
                      tp_axis: Axis = Axis.none(),
                      mp_axis: Axis = Axis.none(),
                      coarse=None, relock: bool = False
                      ) -> Tuple[TrackState, dict]:
    """One frame: featurize + associate + fuse + UKF + state update.

    frame_inputs: (ranges (N,), angles (N,), valid (N,), n (),
    odom_prev (3,), odom_cur (3,)) tensors on the context's device.
    coarse: the per-map pruning field (prepare_coarse) or None.
    relock: the lanes may hold a relock that overflows
    shapes.max_candidates (match_stage)."""
    fs = featurize_stage(frame_inputs, ctx, cfg)
    return match_stage(state, fs, frame_inputs, ctx, cfg,
                       tp_axis=tp_axis, mp_axis=mp_axis, coarse=coarse,
                       relock=relock)


def prepare_coarse(ctx: MapContext, cfg: EngineConfig = DEFAULT):
    """The per-map pruning field (one per lane of a batched context), or
    None when pruning is off; computed once per rollout."""
    if not cfg.match.prune:
        return None
    return assoc.coarse_field(ctx.cache, cfg.match.prune_block)


def batched_cfg(cfg: EngineConfig) -> EngineConfig:
    """The config of a step over a lane axis (batched rollouts, the
    serving pool), as the reference package's vmapped_cfg: the pruning
    gate (prune_min_live, a host read of the live count) and the
    windowed scorer (score_window, a host read of the fits decision)
    decide per frame, not per lane, so a batch always takes the pruned
    path and never the window.  Outputs are identical either way."""
    changes = {}
    if cfg.match.prune and cfg.match.prune_min_live != 0:
        changes["prune_min_live"] = 0
    if cfg.match.score_window:
        changes["score_window"] = 0
    if not changes:
        return cfg
    return dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, **changes))


def match_stage(state: TrackState, fs, frame_inputs, ctx: MapContext,
                cfg: EngineConfig = DEFAULT,
                tp_axis: Axis = Axis.none(),
                mp_axis: Axis = Axis.none(),
                coarse=None, cand=None, relock: bool = False
                ) -> Tuple[TrackState, dict]:
    """Association + fusion + UKF + tracking state (L4/L5 of the
    reference) on precomputed ScanFeatures.  cand: optional
    pre-generated Candidates for this (state, fs) pair.  tp_axis: ctx
    holds this rank's block of the map lines; mp_axis: ctx.cache holds
    this rank's row block of the field (module docstring).

    relock (a serving pool's tick that carries a relock lane): the
    candidates are compacted into shapes.relock_candidates slots, and a
    relock lane whose gated count passes shapes.max_candidates is
    scored, fused and flagged over all of them; every other lane keeps
    its first max_candidates, so its outputs are those of the step
    without ``relock`` bit for bit."""
    if cfg.match.polish_pose and mp_axis.size > 1:
        raise ValueError(
            "match.polish_pose requires a full-field cache view and is "
            "not supported under map-block (mp) sharding; disable the "
            "polish or use a (dp, tp) mesh")
    with trace.span("step.match"):
        return _match(state, fs, frame_inputs, ctx, cfg, tp_axis, mp_axis,
                      coarse, cand, relock)


def _match(state: TrackState, fs, frame_inputs, ctx: MapContext,
           cfg: EngineConfig, tp_axis: Axis, mp_axis: Axis, coarse,
           cand, relock: bool) -> Tuple[TrackState, dict]:
    """match_stage's body, one span a stage."""
    ranges, angles, valid, n, odom_prev, odom_cur = frame_inputs
    lanes = tuple(ranges.shape[:-1])
    sh = cfg.shapes
    dt = ranges.dtype
    dev = ranges.device
    where = geo.lane_where

    with trace.span("match.candidates"):
        # --- ScanPose from odometry (main_on_windows.cpp:132-153) ---
        is_first = torch.abs(state.kalman_x[..., 0] + 1) < 1e-4
        theta = state.ang_sum / state.ang_cnt.clamp(min=1).to(dt)
        tx = (odom_cur[..., 0] - odom_prev[..., 0]) / ctx.resol
        ty = (odom_cur[..., 1] - odom_prev[..., 1]) / ctx.resol
        tang = geo.atand(odom_cur[..., 2] - odom_prev[..., 2])
        sp_x = tx * geo.cosd(theta) - ty * geo.sind(theta)
        if cfg.faithful:
            sp_y = ty * geo.sind(theta) + ty * geo.cosd(theta)  # reference bug
        else:
            sp_y = tx * geo.sind(theta) + ty * geo.cosd(theta)
        scan_pose = where(is_first, torch.zeros(3, dtype=dt, device=dev),
                          torch.stack([sp_x, sp_y, tang], -1))

        # --- association (trans2FA rounds the lidar pose, :229-230) ---
        lidar_pose = geo.c_round(fs.lidar_pos)
        scan_radius = None
        if cfg.match.score_window:
            # the windowed scorer's coverage bound: the largest live-pixel
            # distance from the rounded lidar pose (the rigid-transform base)
            pdx = fs.pixels[..., 0].to(dt) - lidar_pose[..., 0, None]
            pdy = fs.pixels[..., 1].to(dt) - lidar_pose[..., 1, None]
            scan_radius = torch.where(fs.pixels_mask,
                                      geo.sqrt(pdx * pdx + pdy * pdy),
                                      0.0).amax(-1)
        wide = cand is None and relock and \
            sh.relock_candidates > sh.max_candidates
        if cand is None:
            cand = assoc.generate_candidates(
                fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
                lidar_pose, state.last_pose,
                max_candidates=sh.relock_candidates if wide
                else sh.max_candidates,
                ignore_scan_length=cfg.match.ignore_scan_length,
                scan_to_map_diff=cfg.match.scan_to_map_diff,
                max_esti_dist=cfg.match.max_esti_dist)
        if wide:
            # the relock lanes past max_candidates take the whole buffer;
            # the others keep its first max_candidates slots
            widen = (state.last_pose[..., 0] == -1) & \
                (cand.count > sh.max_candidates)
            cand = assoc.keep_head(cand, sh.max_candidates, widen)
    with trace.span("match.score"):
        if mp_axis.size > 1:
            # map-block sharding: this rank owns rows [row0, row0 + block_h)
            # of the field; the psum of the additive partials is the whole
            # field's (one lane-batched launch a frame per rank).  One rank
            # holds the whole field and takes the pruned scorer below, whose
            # scores are the same.
            parts = assoc.score_candidates_partial(
                cand, fs.pixels, fs.pixels_mask, ctx.cache,
                mp_axis.index * ctx.cache.shape[-2], ctx.rows, ctx.cols,
                z_occ_max_dis=cfg.map.z_occ_max_dis,
                max_dist_penalty=cfg.match.max_dist_penalty,
                obstacle_min_dist=cfg.match.obstacle_min_dist)
            sum_d, n_valid, sum_far, n_far = (mp_axis.psum(p) for p in parts)
            scores = assoc.finalize_scores(
                cand, sum_d, n_valid, fs.pixels_mask.sum(-1).to(dt),
                sum_far=sum_far, n_far=n_far,
                max_dist_penalty=cfg.match.max_dist_penalty,
                valid_ratio=cfg.match.valid_ratio,
                obstacle_tolerance=cfg.match.obstacle_tolerance)
        else:
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
                window=cfg.match.score_window,
                window_center=state.last_pose[..., :2],
                scan_radius=scan_radius,
                window_gate=cfg.match.max_esti_dist)
    with trace.span("match.fuse"):
        # faithful: a perfect (score 0) candidate NaN-poisons the fused pose
        # exactly like the reference's inf weight (myFA.cpp:161)
        fused = assoc.fuse(cand, scores, cfg.match.score_accept,
                           axis_name=tp_axis,
                           score_floor=0.0 if cfg.faithful else 1e-6)
        if wide:
            # the lanes that keep the head fuse over it alone, in the
            # shapes of the step without ``relock``
            K = sh.max_candidates
            head = assoc.fuse(assoc.head(cand, K),
                              scores[..., :K].contiguous(),
                              cfg.match.score_accept, axis_name=tp_axis,
                              score_floor=0.0 if cfg.faithful else 1e-6)
            fused = tuple(where(widen, a, b) for a, b in zip(fused, head))
        pose_w, fused_score, pose_min, min_score, n_acc = fused
        if cfg.match.polish_pose:
            # sub-pixel Gauss-Newton polish of both measurement paths
            # (tracking weighted mean + first-frame argmin) against the
            # bilinear distance field
            pose_w, _, _ = polish.polish_pose(
                pose_w, lidar_pose, fs.pixels, fs.pixels_mask, ctx.cache,
                rows=ctx.rows, cols=ctx.cols, iters=cfg.match.polish_iters,
                max_total_px=cfg.match.polish_max_px)
            pose_min, _, _ = polish.polish_pose(
                pose_min, lidar_pose, fs.pixels, fs.pixels_mask, ctx.cache,
                rows=ctx.rows, cols=ctx.cols, iters=cfg.match.polish_iters,
                max_total_px=cfg.match.polish_max_px)

    with trace.span("match.gate"):
        # --- three-way outcome (myFA.cpp:69-175) ---
        lost = n_acc == 0
        # the first-frame branch tolerates |x+1| < 1e-4 (myFA.cpp:99), unlike
        # the gate's exact == -1 escape (myFA.cpp:330)
        hmm_first = torch.abs(state.last_pose[..., 0] + 1) < 1e-4

        if cfg.match.relock_margin > 0.0:
            ambig = assoc.relock_ambiguity(
                cand, scores, pose_min, min_score,
                min_dist=cfg.match.max_esti_dist,
                margin=cfg.match.relock_margin,
                score_accept=cfg.match.score_accept, axis_name=tp_axis)
            # a deferred relock behaves like a lost frame: the chain stays at
            # the sentinel and retries globally next frame
            deferred = hmm_first & ~lost & ambig
            lost = lost | deferred
        else:
            deferred = torch.zeros(lanes, dtype=torch.bool, device=dev)

    with trace.span("match.ukf"):
        ukf_x, ukf_P = fukf.ukf_step(state.kalman_x, state.kalman_P,
                                     scan_pose, pose_w,
                                     alpha=cfg.filter.alpha,
                                     beta=cfg.filter.beta,
                                     kappa=cfg.filter.kappa,
                                     dt_step=cfg.filter.dt)
        first_x = torch.cat([pose_min, state.kalman_x[..., 3:]], -1)
        reset_x = torch.as_tensor(fukf.RESET_X, dtype=dt, device=dev)
        reset_P = torch.as_tensor(fukf.RESET_P, dtype=dt, device=dev)
        new_x = where(lost, reset_x, where(hmm_first, first_x, ukf_x))
        new_P = where(lost, reset_P, where(hmm_first, state.kalman_P, ukf_P))
        out_score = torch.where(lost, torch.inf,
                                torch.where(hmm_first, min_score, fused_score))

        # --- coast-on-loss (opt-in; no reference equivalent): up to C
        # consecutive lost frames dead-reckon on the rotated odometry delta
        # instead of the reference's global reset (myFA.cpp:69-89)
        streak = torch.where(lost, state.lost_streak + 1,
                             torch.zeros_like(state.lost_streak))
        if cfg.match.coast_on_loss > 0:
            coast = lost & ~is_first & (streak <= cfg.match.coast_on_loss)
            coast_x = torch.cat([state.kalman_x[..., :3] + scan_pose,
                                 state.kalman_x[..., 3:]], -1)
            coast_P = state.kalman_P + torch.as_tensor(
                fukf.process_noise(), dtype=dt, device=dev)
            new_x = where(coast, coast_x, new_x)
            new_P = where(coast, coast_P, new_P)
        else:
            coast = torch.zeros(lanes, dtype=torch.bool, device=dev)

        # --- angRotate bookkeeping (main_on_windows.cpp:165-172) ---
        frame = state.frame + 1
        ang_diff = new_x[..., 2] - geo.atand(odom_cur[..., 2])
        is_offset = state.is_offset | ((torch.abs(ang_diff) > 90) &
                                       (frame == 1))
        ang_diff = torch.where(is_offset & (ang_diff < 0), ang_diff + 360,
                               ang_diff)

        new_state = TrackState(
            kalman_x=new_x, kalman_P=new_P, last_pose=new_x[..., :3],
            ang_sum=state.ang_sum + ang_diff, ang_cnt=state.ang_cnt + 1,
            is_offset=is_offset, frame=frame, lost_streak=streak)
        cap = cand.mask.shape[-1]
        if wide:
            cap = torch.where(widen, cap, sh.max_candidates)
        overflow = (cand.count > cap) | fs.overflow
        # candidate counts are per map-line block; an overflow on any rank is
        # every rank's
        overflow = tp_axis.pmax(overflow)
        outputs = {
            "pose": new_x[..., :3],
            "score": out_score,
            "n_candidates": n_acc,
            "n_scan_lines": fs.lines_mask.sum(-1),
            "candidate_overflow": overflow,
            "coasting": coast,
            "relock_deferred": deferred,
            # the FA measurement (weighted-mean pose) and the rotated
            # odometry delta fed to the filter
            "measurement": where(lost, torch.nan, pose_w),
            "scan_pose": scan_pose,
        }
    return new_state, outputs


_FRAME_KEYS = ("ranges", "angles", "valid", "n", "odom_prev", "odom_cur")


def rollout(fr: dict, ctx: MapContext, cfg: EngineConfig,
            lanes: Optional[int] = None, tp_axis: Axis = Axis.none(),
            mp_axis: Axis = Axis.none(), prefeaturize: bool = False,
            unroll: int = 1, batch_featurize: bool = True,
            call=None) -> dict:
    """The frame loop over tensors on the context's device: fr holds the
    stacked frames with the frame axis first ((F, ...), or (F, B, ...)
    for ``lanes`` = B).  Returns the stacked outputs, frame axis first.
    tp_axis/mp_axis: this rank's shard of a sharded rollout (mp scores
    unpruned: the pruning field needs the whole field).

    The execution strategy (``strategy(cfg)``; the defaults are the
    plain loop): ``prefeaturize`` featurizes all F frames in one call
    before the loop, the frame axis a lane axis ahead of the batch's;
    ``unroll`` = k > 1 with ``batch_featurize`` featurizes each block of
    k frames in one call, the last block padded by repeating its last
    frame so that every call has one shape (the padding's features are
    dropped and never reach the carry).  Without ``batch_featurize``
    the k frames are featurized one by one, which in a frame loop is the
    plain loop, as is k >= F (the reference's plain scan).  Featurize
    reads no carry, so moving it ahead of a frame's matching is safe: a
    reset flag inside a block still resets the carry at its own frame,
    and each lane of a featurize call is featurized on its own, so every
    output is the plain loop's bit for bit.

    Each frame is a tracer span, ``batch.frame`` over lanes and
    ``rollout.frame`` without, whose request is (``call``, frame)."""
    F = fr["ranges"].shape[0]
    if prefeaturize:
        block = F
    elif batch_featurize and 1 < unroll < F:
        block = unroll
    else:
        block = 1
    state = init_state(fr["ranges"].dtype, fr["ranges"].device, lanes)
    coarse = None if mp_axis.size > 1 else prepare_coarse(ctx, cfg)
    outs = []
    frame_span = "batch.frame" if lanes is not None else "rollout.frame"
    for s in range(0, F, block):
        if block > 1:
            fs_block = featurize_stage(
                tuple(_edge_pad(fr[k][s:s + block], block)
                      for k in _FRAME_KEYS), ctx, cfg)
        for f in range(s, min(s + block, F)):
            with trace.span(frame_span, (call, f)):
                fr_f = {k: v[f] for k, v in fr.items()}
                state = reset_carry(state, fr_f)
                inputs = tuple(fr_f[k] for k in _FRAME_KEYS)
                if block > 1:
                    fs = ScanFeatures(*(
                        getattr(fs_block, fld.name)[f - s]
                        for fld in dataclasses.fields(fs_block)))
                else:
                    fs = featurize_stage(inputs, ctx, cfg)
                state, out = match_stage(state, fs, inputs, ctx, cfg,
                                         tp_axis=tp_axis, mp_axis=mp_axis,
                                         coarse=coarse)
            outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _edge_pad(x, size: int):
    """x (n, ...) padded to ``size`` along its first axis by repeating
    its last row (a real frame, which featurize takes as any other)."""
    pad = size - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def strategy(cfg: EngineConfig) -> dict:
    """rollout's execution-strategy arguments from the config's
    prefeaturize, scan_unroll and scan_unroll_batch_featurize."""
    return dict(prefeaturize=cfg.prefeaturize, unroll=cfg.scan_unroll,
                batch_featurize=cfg.scan_unroll_batch_featurize)


def to_device(frames: dict, dev) -> dict:
    """Stacked frames (numpy arrays or tensors) as tensors on dev."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=dev)
            for k, v in frames.items()}


def run_sequence(frames, ctx: MapContext, cfg: EngineConfig = DEFAULT,
                 device="cuda"):
    """Whole-sequence rollout: a Python loop over frames, under the
    config's execution strategy (rollout).

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
    return rollout(to_device(frames, dev), ctx, cfg, **strategy(cfg))


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
    arrays or tensors, e.g. mapprep.prepare_map's artifacts).
    max_map_lines None sizes the pad to the line count rounded up to a
    multiple of 64 (min 64); padding never passes the gates.
    cache_dtype: "f32" (the float field at ``dtype``), "bf16", "u16" or
    "u8" (compressed fields, match/associate.quantize_cache;
    z_occ_max_dis is the fixed-point scale and must be the cap the field
    was built with)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    map_lines = torch.as_tensor(map_lines)
    k = int(map_lines.shape[0])
    M = max(64, -(-k // 64) * 64) if max_map_lines is None else max_map_lines
    if k > M:
        raise ValueError(f"map has {k} lines > max_map_lines={M}; "
                         "raise the cap (or pass max_map_lines=None "
                         "to auto-size)")
    lines = torch.zeros((M, 10), dtype=dt, device=dev)
    lines[:k] = map_lines.to(dev, dt)
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
