"""Intra-sequence temporal parallelism: one long trajectory cut into S
overlapping segments that roll at once (counterpart of
lsdtpu/runtime/temporal.py).

The reference rolls a trajectory strictly in order: each frame's HMM
gate and UKF depend on the previous frame (LSD/myFA.cpp:13-184).  For
offline replay that chain is not a hard dependency, because the engine
defines a legal cold start at any frame: from the (-1, -1) sentinel the
first frame relocalizes globally (myFA.cpp:96-108, :330).  So the
sequence is cut into S segments, each rolled from a cold start, with a
short overlap ("warmup") absorbed before each cut:

  * segment 0 processes frames [0, L + W) and keeps [0, L);
  * segment s > 0 processes [sL - W, sL + L) and keeps [sL, sL + L).

Within the warmup the chain relocks and the UKF contracts onto the
sequential chain; the residual differences are the reference package's
(its module docstring): the running mean angle offset restarts per
segment, and the faithful is_offset fix can only trigger in segment 0.

On one card the S segments are the lanes of one batched rollout
(runtime/batch.py: one lane-batched CalcScore launch a frame), which is
how a single long replay fills the card; over a 1-D mesh of ranks each
rank rolls S/n of them as its lanes and one all_gather brings every
segment to every rank before the stitch.  ``reconcile_temporal`` feeds
the stitched measurements to the pose-graph solver
(refine/pose_graph.refine_trajectory).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.runtime.collectives import Axis, gather_lanes, rank_slice
from lsdtpu_torch.runtime.distributed import DP_AXIS
from lsdtpu_torch.runtime.loop import (MapContext, batched_cfg, rollout,
                                       to_device)


def make_mesh_sp(n_devices: Optional[int] = None, device="cuda"):
    """1-D (dp,) mesh over the ranks: the segment axis of a split
    trajectory."""
    from lsdtpu_torch.runtime.shard import make_mesh_1d
    return make_mesh_1d(n_devices, device)


def split_frames_temporal(frames, n_segments: int, warmup: int
                          ) -> Tuple[dict, int, int]:
    """Host-side: cut a (F, ...) frame stream (numpy arrays) into an
    (S, L + W, ...) overlapping segment stack.

    Tail padding uses dead frames (n = 0, valid False, the last odometry
    repeated, so a zero delta); their outputs land outside every keep
    window.  Returns (stack, L, F)."""
    frames = {k: np.asarray(v) for k, v in frames.items()}
    F = frames["ranges"].shape[0]
    S = n_segments
    if S < 1:
        raise ValueError(f"n_segments={S} must be >= 1")
    L = -(-F // S)
    if warmup >= L and S > 1:
        raise ValueError(
            f"warmup={warmup} >= segment length {L} (F={F}, S={S}): "
            "every frame would be warmup; use fewer segments")
    Fp = max(S * L, L + warmup)

    def pad(a):
        n = Fp - a.shape[0]
        if n == 0:
            return a.copy()
        return np.concatenate([a, np.zeros((n,) + a.shape[1:], a.dtype)])

    padded = {k: pad(v) for k, v in frames.items()}
    if F < Fp:
        # dead tail: both odometry inputs pinned to the last cumulative
        # odometry, so every dead frame's delta is exactly zero
        for k in ("odom_prev", "odom_cur"):
            padded[k][F:] = padded["odom_cur"][F - 1]
    starts = [0] + [s * L - warmup for s in range(1, S)]
    stack = {k: np.stack([v[st:st + L + warmup] for st in starts])
             for k, v in padded.items()}
    return stack, L, F


def lane_context(ctx: MapContext, lanes: int) -> MapContext:
    """A single-map context as a batched one of ``lanes`` lanes (each lane
    its own copy of the field, as the lane-batched kernel takes them)."""
    def rep(t):
        return t.expand((lanes,) + tuple(t.shape)).contiguous()

    dev = ctx.cache.device
    cache = ctx.cache
    if cache.dtype == torch.uint16:
        cache = rep(cache.view(torch.int16)).view(torch.uint16)
    else:
        cache = rep(cache)
    return MapContext(
        lines=rep(ctx.lines), lines_mask=rep(ctx.lines_mask), cache=cache,
        rows=torch.full((lanes,), int(ctx.rows), dtype=torch.int32,
                        device=dev),
        cols=torch.full((lanes,), int(ctx.cols), dtype=torch.int32,
                        device=dev),
        resol=rep(ctx.resol), ori_x=rep(ctx.ori_x), ori_y=rep(ctx.ori_y))


def run_sequence_temporal(frames, ctx: MapContext, mesh=None,
                          cfg: EngineConfig = DEFAULT, warmup: int = 24,
                          n_segments: Optional[int] = None, device="cuda"):
    """Segment-parallel rollout of one long (possibly concatenated,
    "reset"-flagged) frame stream.  frames: (F, ...) numpy arrays
    (stack_frames / stack_concat); ctx: a single MapContext on
    ``device``; mesh: a 1-D mesh (make_mesh_sp), None for the ranks of
    the default group (one rank: all segments on this card).  Returns
    the (F, ...) outputs of run_sequence's keys as numpy arrays, the same
    on every rank.

    n_segments defaults to the mesh size and must be a multiple of it:
    each rank rolls n_segments / n of them as the lanes of one batched
    rollout.  warmup frames of overlap are re-processed before every cut
    and discarded (module docstring).  The plain frame loop: cfg's
    prefeaturize and scan_unroll are ignored, as in the reference."""
    dev = resolve_device(device)
    if ctx.cache.device.type != dev.type:
        raise ValueError(f"ctx lives on {ctx.cache.device}, not {dev}")
    if mesh is None:
        mesh = make_mesh_sp(device=dev)
    axis = Axis.of(mesh, DP_AXIS)
    S = axis.size if n_segments is None else n_segments
    if S % axis.size:
        raise ValueError(f"n_segments={S} not a multiple of {axis.size} "
                         "mesh ranks")
    stack, L, F = split_frames_temporal(frames, S, warmup)
    mine = rank_slice(S, axis)
    fr = to_device({k: np.ascontiguousarray(np.swapaxes(v[mine], 0, 1))
                    for k, v in stack.items()}, dev)
    lanes = mine.stop - mine.start
    outs = rollout(fr, lane_context(ctx, lanes), batched_cfg(cfg),
                   lanes=lanes)
    outs = gather_lanes(axis, {k: v.transpose(0, 1).contiguous()
                               for k, v in outs.items()})
    host = {k: v.cpu().numpy() for k, v in outs.items()}

    def stitch(a):
        parts = [a[0][:L]] + [a[s][warmup:warmup + L] for s in range(1, S)]
        return np.concatenate(parts)[:F]

    return {k: stitch(v) for k, v in host.items()}


def reconcile_temporal(outs, odom_weight=(4.0, 4.0, 4.0), device="cuda"):
    """Joint smoothing of a stitched temporal rollout: the per-frame
    measurements and rotated odometry deltas go to the block-tridiagonal
    chain solver (refine/pose_graph.refine_trajectory), which reconciles
    the segment boundaries.  Returns (refined (F, 3) poses, info), numpy."""
    from lsdtpu_torch.refine.pose_graph import refine_trajectory
    meas = np.asarray(outs["measurement"], np.float64)
    scores = np.asarray(outs["score"], np.float64)
    u = np.asarray(outs["scan_pose"], np.float64)
    refined, info = refine_trajectory(meas, scores, u,
                                      odom_weight=odom_weight, device=device)
    return refined.cpu().numpy(), {k: v.cpu().numpy()
                                   for k, v in info.items()}
