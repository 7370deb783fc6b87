"""Sharded batched rollouts over a (dp, tp) or (dp, mp) mesh of ranks
(counterpart of lsdtpu/runtime/shard.py).

The reference's only parallelism is a 30-thread pool fanning out
candidate scoring on one host (LSD/myFA.cpp:22-62).  As the reference
package does over its device mesh, the port shards two axes over the
ranks of a ``torch.distributed`` DeviceMesh:

  * **dp**: independent sequences, no communication: a rank rolls its
    B/dp sequences as the lanes of one batched rollout (runtime/batch.py,
    one lane-batched CalcScore launch a frame);
  * **tp**: the map-line axis of the candidate space.  Each rank gates
    and scores the hypotheses of its block of the map lines against the
    replicated scan, pruned as the unsharded path (the rank holds the
    whole field), and fusion reduces with one psum of (sum_w, sum_pose,
    n) a frame (match/associate.fuse), the first-frame argmin with a pmin
    and lowest-rank ownership;
  * **mp** (``run_batch_sharded_mapblocks``): the field's rows.  Each rank
    holds a row block of every lane's field, scores every candidate
    unpruned over it (the lane-batched kernel with ``row0``), and a psum
    of the four additive partials gives the whole field's scores.

Inputs are the host-replicated batch that stack_batch / stack_concat
build (every rank holds all of it, as in the reference's multi-controller
model); each rank pads it to the mesh, takes its shard and moves it to its
device (``local_batch``), and the outputs come back to every rank with
one all_gather over dp, so every rank returns what run_batch returns for
the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.runtime.collectives import Axis, gather_lanes, rank_slice
from lsdtpu_torch.runtime.distributed import (DP_AXIS, MP_AXIS, TP_AXIS,
                                              device_mesh, ensure_group)
from lsdtpu_torch.runtime.loop import MapContext, batched_cfg, rollout


def _world(device) -> int:
    ensure_group(device)
    return dist.get_world_size()


def make_mesh_1d(n_devices: Optional[int] = None, device="cuda",
                 name: str = DP_AXIS):
    """1-D mesh over every rank of the default group (the serving-pool,
    temporal-segment and map-prep-block meshes); n_devices, when given,
    must be the world size."""
    n = _world(device)
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: the process group has {n} "
                         "ranks (one mesh position a rank)")
    return device_mesh(device, (n,), (name,))


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device="cuda", inner: str = TP_AXIS):
    """(dp, tp) mesh over the ranks.  dp defaults to the largest
    power-of-two divisor <= sqrt(n), as the reference's; pass dp=1 for
    pure tensor parallelism or dp=n for pure data parallelism."""
    n = _world(device)
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: the process group has {n} "
                         "ranks (one mesh position a rank)")
    if dp is None:
        dp = 1
        while dp * 2 <= n // (dp * 2) and n % (dp * 2) == 0:
            dp *= 2
    elif n % dp != 0:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    return device_mesh(device, (dp, n // dp), (DP_AXIS, inner))


def make_mesh_mp(n_devices: Optional[int] = None, dp: Optional[int] = None,
                 device="cuda"):
    """(dp, mp) mesh for map-block sharding (the same split heuristic)."""
    return make_mesh(n_devices, dp, device, inner=MP_AXIS)


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _pad_to_mesh(frames: dict, ctxs: MapContext, n_dp: int, n_tp: int,
                 n_mp: int = 1):
    """Pad the batch axis to a multiple of dp (replicating the last
    sequence: the clones run on otherwise idle ranks and are cut off),
    the map-line axis to a multiple of tp (masked padding lines) and the
    field's rows to a multiple of mp (never read: each lane's rows bound
    its in-map test).  Returns (frames, ctxs, true B), tensors on the
    inputs' devices."""
    frames = {k: _as_tensor(v) for k, v in frames.items()}
    ctxs = MapContext(*(_as_tensor(getattr(ctxs, f.name))
                        for f in dataclasses.fields(MapContext)))
    if ctxs.cache.dtype == torch.uint16:
        # u16 codes through an int16 view: PyTorch has few uint16 kernels
        # (local_batch views the shard back)
        ctxs = dataclasses.replace(ctxs, cache=ctxs.cache.view(torch.int16))
    B = ctxs.lines.shape[0]
    bpad = (-B) % n_dp
    if bpad:
        def rep(a):
            return torch.cat([a, a[-1:].expand((bpad,) + a.shape[1:])])
        frames = {k: rep(v) for k, v in frames.items()}
        ctxs = MapContext(*(rep(getattr(ctxs, f.name))
                            for f in dataclasses.fields(MapContext)))
    mpad = (-ctxs.lines.shape[1]) % n_tp
    if mpad:
        ctxs = dataclasses.replace(
            ctxs, lines=torch.nn.functional.pad(ctxs.lines,
                                                (0, 0, 0, mpad)),
            lines_mask=torch.nn.functional.pad(ctxs.lines_mask, (0, mpad)))
    hpad = (-ctxs.cache.shape[1]) % n_mp
    if hpad:
        c = ctxs.cache
        pad = torch.zeros((c.shape[0], hpad, c.shape[2]), dtype=c.dtype,
                          device=c.device)
        ctxs = dataclasses.replace(ctxs, cache=torch.cat([c, pad], 1))
    return frames, ctxs, B


def local_batch(frames, ctxs: MapContext, mesh, kind: str, device="cuda"):
    """This rank's shard of a host-replicated batch on ``device``:
    (frames dict (B/dp, F, ...), MapContext (B/dp, ...), true B).  kind
    "tp": a block of the map lines; "mp": a row block of the fields."""
    dev = resolve_device(device)
    dp = Axis.of(mesh, DP_AXIS)
    inner = Axis.of(mesh, TP_AXIS if kind == "tp" else MP_AXIS)
    u16 = _as_tensor(ctxs.cache).dtype == torch.uint16
    frames, ctxs, B = _pad_to_mesh(
        frames, ctxs, dp.size, inner.size if kind == "tp" else 1,
        inner.size if kind == "mp" else 1)
    lanes = rank_slice(ctxs.lines.shape[0], dp)
    fr = {k: v[lanes].to(dev) for k, v in frames.items()}
    cx = MapContext(*(getattr(ctxs, f.name)[lanes]
                      for f in dataclasses.fields(MapContext)))
    if kind == "tp":
        m = rank_slice(cx.lines.shape[1], inner)
        cx = dataclasses.replace(cx, lines=cx.lines[:, m],
                                 lines_mask=cx.lines_mask[:, m])
    else:
        cx = dataclasses.replace(
            cx, cache=cx.cache[:, rank_slice(cx.cache.shape[1], inner)])
    cx = MapContext(*(getattr(cx, f.name).to(dev).contiguous()
                      for f in dataclasses.fields(MapContext)))
    cx = dataclasses.replace(
        cx, rows=cx.rows.to(torch.int32), cols=cx.cols.to(torch.int32),
        cache=cx.cache.view(torch.uint16) if u16 else cx.cache)
    return fr, cx, B


def _run(frames, ctxs, mesh, cfg, kind, device):
    fr, cx, B = local_batch(frames, ctxs, mesh, kind, device)
    axis = Axis.of(mesh, TP_AXIS if kind == "tp" else MP_AXIS)
    outs = rollout({k: v.transpose(0, 1).contiguous() for k, v in fr.items()},
                   cx, batched_cfg(cfg), lanes=cx.lines.shape[0],
                   **{f"{kind}_axis": axis})
    outs = {k: v.transpose(0, 1).contiguous() for k, v in outs.items()}
    return gather_lanes(Axis.of(mesh, DP_AXIS), outs, B)


def run_batch_sharded(frames, ctxs: MapContext, mesh,
                      cfg: EngineConfig = DEFAULT, device="cuda"):
    """Sharded batched rollout over a (dp, tp) mesh (make_mesh).

    frames: dict of (B, F, ...) stacked inputs (stack_batch's first
    output; with "reset" flags for a stack_concat stream lifted to B =
    1); ctxs: a batched MapContext (stack_batch's second output, any
    device), the same on every rank.  B and the map-line axis need not
    divide the mesh.  Returns the (B, F, ...) outputs as tensors on
    ``device``, the same on every rank.  The plain frame loop: cfg's
    prefeaturize and scan_unroll are ignored, as in the reference."""
    return _run(frames, ctxs, mesh, cfg, "tp", device)


def run_batch_sharded_mapblocks(frames, ctxs: MapContext, mesh,
                                cfg: EngineConfig = DEFAULT, device="cuda"):
    """Sharded rollout with the fields row-sharded over ``mp`` of a
    (dp, mp) mesh (make_mesh_mp): each rank holds a row block of every
    lane's field and a psum of the additive partials gives the whole
    field's scores.  Map lines and scans are replicated over mp (they are
    KBs; the field is the heavy part).  Same inputs and outputs as
    run_batch_sharded."""
    return _run(frames, ctxs, mesh, cfg, "mp", device)
