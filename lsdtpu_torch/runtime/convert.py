"""Carry state between the reference package and the port.

The system has no model weights: its state is the map context (lines,
distance field, map geometry) and the track carry (filter state and the
main loop's bookkeeping).  These functions take the fields of the
reference package's MapArtifacts / MapContext / TrackState as numpy
arrays (``np.asarray`` on each field) and build the port's, or give
the port's TrackState back as numpy arrays, so both packages can run
from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep.pipeline import MapArtifacts
from lsdtpu_torch.runtime.loop import MapContext, TrackState


def _tensor(a, dev):
    """A tensor on ``dev`` holding a copy of the array ``a`` (arrays from
    the reference package are read-only views)."""
    return torch.from_numpy(np.array(a)).to(dev)


_STATE_DTYPES = {"ang_cnt": torch.int32, "is_offset": torch.bool,
                 "frame": torch.int32, "lost_streak": torch.int32}


def map_context_from_numpy(lines, lines_mask, cache, rows, cols, resol,
                           ori_x, ori_y, device="cuda") -> MapContext:
    """A MapContext from the reference MapContext's fields as numpy
    arrays; float fields keep the dtype of ``lines``."""
    dev = resolve_device(device)
    lines = _tensor(lines, dev)
    dt = lines.dtype

    def scalar(v):
        return _tensor(v, dev).to(dt)

    return MapContext(
        lines=lines,
        lines_mask=_tensor(np.asarray(lines_mask, bool), dev),
        cache=_tensor(cache, dev).contiguous(),
        rows=int(np.asarray(rows)), cols=int(np.asarray(cols)),
        resol=scalar(resol), ori_x=scalar(ori_x), ori_y=scalar(ori_y))


def map_artifacts_from_numpy(lines_info, map_cache,
                             device="cuda") -> MapArtifacts:
    """The port's MapArtifacts from the reference MapArtifacts' fields
    (lines_info (n, 10), map_cache (H, W)) as numpy arrays."""
    dev = resolve_device(device)
    return MapArtifacts(lines_info=_tensor(lines_info, dev),
                        map_cache=_tensor(map_cache, dev).contiguous())


def track_state_from_numpy(kalman_x, kalman_P, last_pose, ang_sum, ang_cnt,
                           is_offset, frame, lost_streak,
                           device="cuda") -> TrackState:
    """A TrackState from the reference TrackState's fields as numpy
    arrays (floats keep the dtype of ``kalman_x``)."""
    dev = resolve_device(device)
    vals = dict(kalman_x=kalman_x, kalman_P=kalman_P, last_pose=last_pose,
                ang_sum=ang_sum, ang_cnt=ang_cnt, is_offset=is_offset,
                frame=frame, lost_streak=lost_streak)
    dt = _tensor(kalman_x, dev).dtype
    return TrackState(**{k: _tensor(v, dev).to(_STATE_DTYPES.get(k, dt))
                         for k, v in vals.items()})


def track_state_to_numpy(state: TrackState) -> dict:
    """The TrackState's fields as numpy arrays, in field order."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(TrackState)}
