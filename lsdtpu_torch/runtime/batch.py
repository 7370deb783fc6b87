"""Batched multi-sequence localization (counterpart of
lsdtpu/runtime/batch.py).

Independent sequences, each with its own map, run as one frame loop over
a leading lane axis of B lanes: every stage of the step (featurize,
candidates, the pruning bound, fusion, the UKF) runs once per frame on
(B, ...) tensors, and one launch of the lane-batched CalcScore kernel
(ops/score.py:score_partials_batched) scores every lane's candidates.
This is the port's counterpart of the reference package's jax.vmap:
a frame's ~1200 small device operations are issued once for all B
lanes instead of once per lane.

All sequences in a batch share static shapes: frames are padded to the
longest sequence (padding frames carry n = 0 and produce the reset
state, which is harmless because each sequence's outputs are cut back
to its true length on the host), maps are padded to a common (H, W)
canvas with each field's own cap value, and each lane keeps its true
map extent (rows/cols, (B,) tensors) for the in-map test.  The step
runs under loop.batched_cfg: the pruning gate and the window, which
decide with a host read per frame, are off (outputs are identical
either way).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.match.associate import quantize_cache
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.loop import (MapContext, batched_cfg, rollout,
                                       stack_frames, strategy, to_device,
                                       torch_dtype)

_calls = itertools.count()      # run_batch calls: the tracer's requests


def run_batch(frames, ctxs: MapContext, cfg: EngineConfig = DEFAULT,
              device="cuda"):
    """frames: dict of (B, F, ...) stacked inputs (numpy arrays or
    tensors; stack_batch's first output); ctxs: a batched MapContext on
    ``device`` (stack_batch's second output).  Returns the outputs as
    (B, F, ...) tensors on the device, under the config's execution
    strategy (loop.rollout: with prefeaturize one featurize call over
    the (F, B) frames).  On the card the caller keeps
    torch.backends.cuda.matmul.allow_tf32 False, as for run_sequence."""
    dev = resolve_device(device)
    if ctxs.cache.device.type != dev.type:
        raise ValueError(f"ctxs live on {ctxs.cache.device}, not {dev}")
    if ctxs.cache.dim() != 3:
        raise ValueError("ctxs must be a batched MapContext (stack_batch)")
    call = next(_calls)
    with trace.span("batch.run", call):
        with trace.span("batch.upload"):
            fr = {k: v.transpose(0, 1).contiguous()
                  for k, v in to_device(frames, dev).items()}
        B = ctxs.cache.shape[0]
        if fr["ranges"].shape[1] != B:
            raise ValueError(f"frames have {fr['ranges'].shape[1]} lanes, "
                             f"ctxs {B}")
        outs = rollout(fr, ctxs, batched_cfg(cfg), lanes=B, call=call,
                       **strategy(cfg))
        return {k: v.transpose(0, 1) for k, v in outs.items()}


def batch_context(map_arts: Sequence, params: Sequence,
                  cfg: EngineConfig = DEFAULT, dtype=np.float32,
                  cache_dtype: str = "f32", device="cuda") -> MapContext:
    """A batched MapContext on ``device`` from per-lane map artifacts:
    map_arts (lines_info (k, 10), map_cache (h, w)) and params (resol,
    ori_x, ori_y), one of each per lane.  Lines are padded to
    cfg.shapes.max_map_lines, and each field to the common canvas with
    its own max, so out-of-map reads behave like far cells (the
    reference package's stack_batch)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    B = len(map_arts)
    fields = [np.asarray(torch.as_tensor(a[1]).cpu()) for a in map_arts]
    H = max(f.shape[0] for f in fields)
    W = max(f.shape[1] for f in fields)
    M = cfg.shapes.max_map_lines
    lines = np.zeros((B, M, 10), np.float64)
    mask = np.zeros((B, M), bool)
    cache = np.zeros((B, H, W), np.float32 if dt == torch.float32
                     else np.float64)
    for i, ((li, _), ca) in enumerate(zip(map_arts, fields)):
        li = np.asarray(torch.as_tensor(li).cpu(), np.float64)
        k = len(li)
        if k > M:
            # caps are never silent (ShapeConfig contract)
            raise ValueError(f"map {i} has {k} lines > "
                             f"shapes.max_map_lines={M}; raise the cap")
        lines[i, :k] = li
        mask[i, :k] = True
        cache[i] = np.pad(ca, ((0, H - ca.shape[0]), (0, W - ca.shape[1])),
                          constant_values=ca.max())
    t = torch.as_tensor
    return MapContext(
        lines=t(lines, device=dev).to(dt), lines_mask=t(mask, device=dev),
        cache=quantize_cache(t(cache, device=dev), cache_dtype,
                             cfg.map.z_occ_max_dis,
                             float_dtype=dt).contiguous(),
        rows=t([f.shape[0] for f in fields], dtype=torch.int32, device=dev),
        cols=t([f.shape[1] for f in fields], dtype=torch.int32, device=dev),
        resol=t([p[0] for p in params], dtype=dt, device=dev),
        ori_x=t([p[1] for p in params], dtype=dt, device=dev),
        ori_y=t([p[2] for p in params], dtype=dt, device=dev))


def stack_batch(datasets: Sequence, map_arts: Sequence,
                cfg: EngineConfig = DEFAULT, dtype=np.float32,
                max_frames: Optional[int] = None, cache_dtype: str = "f32",
                device="cuda"):
    """Host-side: pad sequences and maps to common shapes.

    datasets: io.Dataset per lane; map_arts: (lines_info, map_cache) per
    lane (e.g. mapprep.prepare_map's artifacts).  cache_dtype: the field
    storage (match/associate.quantize_cache).  Returns (frames dict of
    (B, F, ...) numpy arrays, batched MapContext on ``device``,
    true_lengths)."""
    fs = [stack_frames(ds, dtype=dtype, max_frames=max_frames)
          for ds in datasets]
    F = max(f["ranges"].shape[0] for f in fs)
    lens = np.array([f["ranges"].shape[0] for f in fs])

    def pad(v):
        return np.pad(v, [(0, F - v.shape[0])] + [(0, 0)] * (v.ndim - 1))

    frames = {k: np.stack([pad(f[k]) for f in fs]) for k in fs[0]}
    params = [(d.param.resol, d.param.ori_x, d.param.ori_y)
              for d in datasets]
    return frames, batch_context(map_arts, params, cfg, dtype, cache_dtype,
                                 device), lens


def stack_concat(datasets: Sequence, dtype=np.float32,
                 max_frames: Optional[int] = None):
    """Corpus replay: concatenate sequences SHARING ONE MAP into a
    single frame stream with per-sequence reset flags; run_sequence
    re-initializes the carry at each flag, so every sequence's outputs
    are bitwise those of its standalone rollout.

    Returns (frames dict with "reset", bounds): outputs split back as
    outs[k][bounds[i]:bounds[i+1]] for sequence i."""
    fs = [stack_frames(ds, dtype=dtype, max_frames=max_frames)
          for ds in datasets]
    lens = [f["ranges"].shape[0] for f in fs]
    frames = {k: np.concatenate([f[k] for f in fs]) for k in fs[0]}
    reset = np.zeros((sum(lens),), bool)
    reset[np.cumsum([0] + lens[:-1])] = True
    frames["reset"] = reset
    return frames, np.cumsum([0] + lens)
