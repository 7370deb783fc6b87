"""Observability: per-stage timing, device profiling, structured logs
(counterpart of lsdtpu/runtime/trace.py).

The reference's only instrumentation is a run-level clock() and
per-frame printfs (LSD/main_on_windows.cpp:17-18,189-190;
LSD/myFA.cpp:106,173).  Here: a per-stage timing harness over the
frame's stage functions, a torch.profiler scope that writes a Chrome
trace of the host and the card, and structured per-frame JSONL records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import IO, Optional

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.filter import ukf as fukf
from lsdtpu_torch.geometry import c_round
from lsdtpu_torch.match import associate as assoc
from lsdtpu_torch.runtime.loop import MapContext
from lsdtpu_torch.scan.featurize import featurize

TRACE_FILE = "trace.json"


def _first_leaf(r) -> torch.Tensor:
    """The first tensor of a stage's result (a tensor, a tuple of them or
    a dataclass of them)."""
    if dataclasses.is_dataclass(r):
        r = getattr(r, dataclasses.fields(r)[0].name)
    elif isinstance(r, (tuple, list)):
        r = r[0]
    return r


def stage_timings(frame_inputs, ctx: MapContext,
                  cfg: EngineConfig = DEFAULT, repeats: int = 10,
                  device="cuda") -> dict:
    """Per-stage wall times (ms) of one frame: featurize, candidate
    generation, scoring, fusion, UKF (keys ``featurize_ms``,
    ``candidates_ms``, ``score_ms``, ``fuse_ms``, ``ukf_ms``).

    frame_inputs: (ranges, angles, valid, n, odom_prev, odom_cur) of one
    frame (numpy arrays or tensors); ctx lives on ``device``.  Each stage
    runs once to warm up, then ``repeats`` times, each repeat timed TO
    VALUE: it ends with torch.cuda.synchronize() on the card and reads
    one leaf of the result on the host.  The numbers include the launch
    overhead of each stage's small operations: they expose the relative
    stage costs."""
    dev = resolve_device(device)
    ranges, angles, valid, n, _op, _oc = (torch.as_tensor(x, device=dev)
                                          for x in frame_inputs)
    sh = cfg.shapes
    out = {}

    def to_value(r):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _first_leaf(r).cpu()

    def timed(name, f, *args):
        r = f(*args)
        to_value(r)                           # warm-up (kernel builds)
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = f(*args)
            to_value(r)
        out[name] = (time.perf_counter() - t0) / repeats * 1e3
        return r

    fs = timed("featurize_ms", lambda *a: featurize(
        *a, least_point=cfg.rdp.least_point, thre_line=cfg.rdp.thre_line,
        least_dist=cfg.rdp.least_dist, max_lines=sh.max_scan_lines,
        max_pixels=sh.max_scan_pixels, max_steps=sh.max_scan_steps),
        ranges, angles, valid, n, ctx.resol, ctx.ori_x, ctx.ori_y)

    dt = ranges.dtype
    last_pose = torch.tensor([-1.0, -1.0, 0.0], dtype=dt, device=dev)
    lidar_pose = c_round(fs.lidar_pos)
    cand = timed("candidates_ms", lambda *a: assoc.generate_candidates(
        *a, max_candidates=sh.max_candidates,
        ignore_scan_length=cfg.match.ignore_scan_length,
        scan_to_map_diff=cfg.match.scan_to_map_diff,
        max_esti_dist=cfg.match.max_esti_dist),
        fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask, lidar_pose,
        last_pose)

    scores = timed("score_ms", lambda *a: assoc.score_candidates(
        *a, rows=ctx.rows, cols=ctx.cols,
        z_occ_max_dis=cfg.map.z_occ_max_dis,
        max_dist_penalty=cfg.match.max_dist_penalty,
        valid_ratio=cfg.match.valid_ratio),
        cand, fs.pixels, fs.pixels_mask, ctx.cache)

    timed("fuse_ms", assoc.fuse, cand, scores)
    timed("ukf_ms", fukf.ukf_step,
          torch.as_tensor(fukf.RESET_X, dtype=dt, device=dev),
          torch.as_tensor(fukf.RESET_P, dtype=dt, device=dev),
          torch.zeros(3, dtype=dt, device=dev),
          torch.zeros(3, dtype=dt, device=dev))
    return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler scope over the host and, where there is one, the
    card; writes a Chrome trace (``log_dir/trace.json``, open it in
    chrome://tracing or Perfetto) when the scope ends.  A no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class FrameLog:
    """Structured per-frame JSONL records (pose, score, gate counts)."""

    def __init__(self, fh: IO[str]):
        self._fh = fh
        self.n = 0

    def write_rollout(self, outs: dict, n_frames: Optional[int] = None,
                      seq: str = "") -> int:
        """outs: run_sequence's outputs (tensors or numpy arrays)."""
        host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v))
                for k, v in outs.items()
                if k in ("pose", "score", "n_candidates", "n_scan_lines")}
        poses, scores = host["pose"], host["score"]
        ncand, nlines = host["n_candidates"], host["n_scan_lines"]
        F = n_frames if n_frames is not None else poses.shape[0]
        for f in range(F):
            sc = float(scores[f])
            rec = {"seq": seq, "frame": f + 1,
                   "pose": [float(v) for v in poses[f]],
                   "score": sc if np.isfinite(sc) else None,
                   "n_candidates": int(ncand[f]),
                   "n_scan_lines": int(nlines[f]),
                   "tracking": bool(np.isfinite(scores[f]))}
            self._fh.write(json.dumps(rec) + "\n")
            self.n += 1
        self._fh.flush()
        return F
