"""Checkpoint / resume of the tracking session (counterpart of
lsdtpu/runtime/checkpoint.py, same file format).

The reference keeps all state in per-run RAM; a crash loses the filter
chain and relocalization restarts globally.  Here the per-sequence
carry (TrackState: kalman_x, kalman_P, last_pose, the angRotate
accumulators, the frame counter, the lost streak) and the session's
odometry anchor serialize to one npz, written atomically, so a
long-running localization service resumes mid-trajectory.  The format
is the reference package's: a file either package wrote resumes in the
other.  (The reference package's orbax variants need a JAX library and
have no counterpart here.)
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.runtime.convert import (track_state_from_numpy,
                                          track_state_to_numpy)
from lsdtpu_torch.runtime.loop import TrackState, numpy_dtype

_FIELDS = ("kalman_x", "kalman_P", "last_pose", "ang_sum", "ang_cnt",
           "is_offset", "frame", "lost_streak")
# fields added after round-1 checkpoints shipped: default when absent
_FIELD_DEFAULTS = {"lost_streak": np.zeros((), np.int32)}


def save_state(path: str, state: TrackState, prev_odom=None) -> None:
    """Atomic write (tmp + rename) of the tracking carry.

    prev_odom: the session's last-consumed odometry (the anchor the
    next scan's delta is computed against) - required for a faithful
    mid-trajectory resume of an OnlineLocalizer; omit only when
    checkpointing a bare TrackState whose caller tracks odometry
    itself."""
    arrs = track_state_to_numpy(state)
    if prev_odom is not None:
        arrs["prev_odom"] = (prev_odom.detach().cpu().numpy()
                             if torch.is_tensor(prev_odom)
                             else np.asarray(prev_odom))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrs)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, dtype=None, device="cuda") -> TrackState:
    """The TrackState of a checkpoint on ``device`` (load_session
    without the odometry anchor)."""
    return load_session(path, dtype, device)[0]


def load_session(path: str, dtype=None, device="cuda"):
    """Returns (TrackState on ``device``, prev_odom numpy array or
    None).  dtype (torch or numpy float type): the session dtype the
    float fields and prev_odom are cast to; None keeps the file's.
    ang_cnt, frame and lost_streak stay int32, is_offset bool."""
    dev = resolve_device(device)
    np_dt = None if dtype is None else numpy_dtype(dtype)
    with np.load(path) as z:
        kw = {}
        for f in _FIELDS:
            a = z[f] if f in z.files else _FIELD_DEFAULTS[f]
            if np_dt is not None and a.dtype.kind == "f":
                a = a.astype(np_dt)
            kw[f] = a
        prev = z["prev_odom"] if "prev_odom" in z.files else None
    if prev is not None and np_dt is not None:
        prev = prev.astype(np_dt)
    return track_state_from_numpy(**kw, device=dev), prev
