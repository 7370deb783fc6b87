"""Checkpoint / resume of the tracking session (counterpart of
lsdtpu/runtime/checkpoint.py, same file format).

The reference keeps all state in per-run RAM; a crash loses the filter
chain and relocalization restarts globally.  Here the per-sequence
carry (TrackState: kalman_x, kalman_P, last_pose, the angRotate
accumulators, the frame counter, the lost streak) and the session's
odometry anchor serialize to one npz, written atomically, so a
long-running localization service resumes mid-trajectory.  The format
is the reference package's: a file either package wrote resumes in the
other.

save_state_dcp / load_state_dcp stand for the reference package's
save_state_orbax / load_state_orbax: a checkpoint directory for
production deployments, written and read by every rank of a process
group, here through torch.distributed.checkpoint (DCP).  The two
formats cannot read each other: orbax writes tensorstore (OCDBT), DCP
its own .metadata and .distcp files.  The npz stays the format both
packages share.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import warnings

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


def _group() -> bool:
    """Whether a process group is running (every rank then takes part in
    a DCP save or load)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _dcp(fn, tree: dict, path: str, group: bool) -> None:
    """dcp.save or dcp.load of ``tree`` at ``path``: over the process
    group, or without one as a single process (whose warning DCP would
    print on every call)."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        fn(tree, checkpoint_id=path, no_dist=not group)


def save_state_dcp(path: str, state: TrackState) -> None:
    """Counterpart of the reference's save_state_orbax: the eight fields
    of ``state`` (a session's, or a batch's with its lane axis) as a DCP
    checkpoint directory at ``path``, replacing one that is there.

    It returns once the checkpoint is complete.  The new checkpoint is
    written whole into a sibling temporary directory, then swapped in,
    so the old one gives way only to a whole one; a failed write leaves
    the old checkpoint and no temporary directory.  Under a process
    group every rank calls it with the same ``path``: a state held
    alike on every rank is written once (DCP's deduplication), and rank
    0 writes the metadata and swaps the directory in."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    group = _group()
    rank0 = not group or dist.get_rank() == 0
    tmp = None
    if rank0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    if group:
        box = [tmp]
        dist.broadcast_object_list(box, src=0)
        tmp = box[0]
    err = None
    try:
        _dcp(dcp.save, {f: getattr(state, f) for f in _FIELDS}, tmp, group)
        if rank0:
            _swap_in(tmp, path)
    except BaseException as e:
        if rank0:
            shutil.rmtree(tmp, ignore_errors=True)
        err = e
    if group:
        # every rank returns, or raises, once rank 0's swap is done
        box = [None if err is None else repr(err)]
        dist.broadcast_object_list(box, src=0)
        if err is None and box[0] is not None:
            raise RuntimeError(f"save_state_dcp on rank 0: {box[0]}")
    if err is not None:
        raise err


def _swap_in(tmp: str, path: str) -> None:
    """Move the whole checkpoint ``tmp`` to ``path``; what was at
    ``path`` is moved aside first and removed after (put back if the
    move fails)."""
    old = None
    if os.path.lexists(path):
        old = tmp + ".old"
        os.replace(path, old)
    try:
        os.replace(tmp, path)
    except BaseException:
        if old is not None:
            os.replace(old, path)
        raise
    if old is not None:
        if os.path.isdir(old) and not os.path.islink(old):
            shutil.rmtree(old)
        else:
            os.unlink(old)


def load_state_dcp(path: str, device="cuda") -> TrackState:
    """Counterpart of the reference's load_state_orbax: the TrackState
    of a save_state_dcp checkpoint on ``device``, each field with the
    dtype and shape it was saved with (a batch's with its lane axis), as
    the checkpoint's own metadata gives them; a field the checkpoint
    lacks takes its default.  Under a process group every rank calls it
    and reads the whole state."""
    import torch.distributed.checkpoint as dcp
    dev = resolve_device(device)
    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    tree = {f: torch.empty(tuple(meta[f].size), dtype=meta[f].properties.dtype,
                           device=dev)
            for f in _FIELDS if f in meta}
    _dcp(dcp.load, tree, path, _group())
    return TrackState(**{
        f: tree[f] if f in tree else torch.from_numpy(
            _FIELD_DEFAULTS[f].copy()).to(dev)
        for f in _FIELDS})
