"""Multi-session serving: N robots localized in one batched step a tick
(counterpart of lsdtpu/runtime/serving.py).

A serving layer with no reference equivalent (the reference is one
robot per process).  A fixed pool of session slots runs the per-frame
step over a lane axis of all its slots (runtime/loop.py): every tick
scores all slots' candidates in one launch of the lane-batched
CalcScore kernel, and reads the outputs back in one device -> host
copy, so one card serves a fleet.  Maps are padded onto a common canvas
filled with the cap z_occ_max_dis (in the working type); per-slot
TrackState and the per-slot pruning fields live on the device between
ticks; joining/leaving sessions swaps a slot's map context and resets
its state.  Slots without a submitted scan (idle, or never opened) run
the step on an empty scan and keep their state.

A slot relocks (a global match from the (-1, -1) sentinel) on its first
scan after it was opened and on the scan after an answer was lost
(score inf).  The pool knows these slots on the host, from its own
calls and from the outputs it reads back, so a tick that carries one
steps every lane with ``relock`` (runtime/loop.match_stage): a relock
lane is answered from up to shapes.relock_candidates gated hypotheses,
and every other lane's outputs are those of a tick without one, bit
for bit.  Neither the swap of a slot's map nor a relock adds a read of
the device.

With ``mesh`` (make_pool_mesh: a 1-D mesh of ranks, each with its own
card or sharing one) the slot axis is spread over the ranks, as in a
multi-controller pool: every rank makes the same calls and holds the same
host-side slot table, keeps the device state and fields of its own
block of slots only, steps that block as its lanes, and one all_gather a
tick gives every rank every slot's outputs.  The capacity is padded to a
multiple of the mesh; the padding slots are never handed out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.match.associate import coarse_field, quantize_cache
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.collectives import Axis, gather_lanes, rank_slice
from lsdtpu_torch.runtime.distributed import DP_AXIS
from lsdtpu_torch.runtime.loop import (MapContext, TrackState, batched_cfg,
                                       init_state, localization_step,
                                       numpy_dtype, torch_dtype)
from lsdtpu_torch.runtime.online import to_host as _to_host


def make_pool_mesh(n_devices: Optional[int] = None, device="cuda"):
    """1-D (dp,) mesh over the ranks for a pool's slot axis (no
    collective but the outputs' all_gather: slots are independent)."""
    from lsdtpu_torch.runtime.shard import make_mesh_1d
    return make_mesh_1d(n_devices, device)


def _put(dst, slot: int, val) -> None:
    """dst[slot] = val in place; u16 fields through int16 views (the
    card's PyTorch has no uint16 indexing)."""
    if dst.dtype == torch.uint16:
        dst, val = dst.view(torch.int16), val.view(torch.int16)
    dst[slot] = val


def to_host(out: dict) -> dict:
    """The pool's outputs on the host in one read (online.to_host),
    counted as the tracer's ``host_reads.pool.readback``."""
    return _to_host(out, "pool.readback")


def _pool_step(states: TrackState, inputs, ctxs: MapContext, active,
               cfg: EngineConfig, coarse=None, relock: bool = False):
    """One step over every slot; inactive slots keep their state.
    coarse: optional (B, ch, cw) per-slot pruning fields, maintained by
    the pool beside the slot fields (loop-invariant across ticks).
    relock: a slot of the tick relocks (module docstring)."""
    new_states, outs = localization_step(states, inputs, ctxs,
                                         batched_cfg(cfg), coarse=coarse,
                                         relock=relock)
    return TrackState(*(
        geo.lane_where(active, getattr(new_states, f.name),
                       getattr(states, f.name))
        for f in dataclasses.fields(TrackState))), outs


class SessionPool:
    """Fixed-capacity pool of concurrent localization sessions on one
    device.

    >>> pool = SessionPool(16, (979, 1440))                 # on the card
    >>> pool.open_session("r1", lines_info, map_cache, resol, ox, oy)
    >>> pool.submit_scan("r1", ranges, angles, odom)
    >>> out = pool.step()["r1"]                              # numpy dict

    ``mesh``: a 1-D mesh (make_pool_mesh); the slots spread over its ranks
    (module docstring).  One frame a tick: cfg's prefeaturize and
    scan_unroll are ignored."""

    def __init__(self, capacity: int, canvas_hw, cfg: EngineConfig = DEFAULT,
                 dtype=np.float32, device="cuda", mesh=None):
        self.capacity = capacity
        self.cfg = cfg
        self.dtype = numpy_dtype(dtype).type
        self.device = resolve_device(device)
        self.H, self.W = canvas_hw
        self._axis = Axis.none() if mesh is None else Axis.of(mesh, DP_AXIS)
        n = self._axis.size
        # the slots padded to the mesh, and this rank's block of them
        self._n_slots = -(-capacity // n) * n
        self._mine = rank_slice(self._n_slots, self._axis)
        lanes = self._mine.stop - self._mine.start
        dt = torch_dtype(dtype)
        dev = self.device
        M = cfg.shapes.max_map_lines
        z = cfg.map.z_occ_max_dis
        # honour match.cache_dtype like make_map_context does (the
        # compressed field is per pool: all slots share one type)
        self._quantize = lambda c: quantize_cache(
            c, cfg.match.cache_dtype, z, float_dtype=dt)
        self._ctxs = MapContext(
            lines=torch.zeros((lanes, M, 10), dtype=dt, device=dev),
            lines_mask=torch.zeros((lanes, M), dtype=torch.bool,
                                   device=dev),
            cache=self._quantize(torch.full((lanes, self.H, self.W), z,
                                            dtype=dt, device=dev)
                                 ).contiguous(),
            rows=torch.zeros(lanes, dtype=torch.int32, device=dev),
            cols=torch.zeros(lanes, dtype=torch.int32, device=dev),
            resol=torch.ones(lanes, dtype=dt, device=dev),
            ori_x=torch.zeros(lanes, dtype=dt, device=dev),
            ori_y=torch.zeros(lanes, dtype=dt, device=dev))
        self._states = init_state(dt, dev, lanes=lanes)
        # per-slot pruning fields (match/associate.coarse_field),
        # recomputed only when a slot's map changes - never per tick
        self._coarse = (coarse_field(self._ctxs.cache, cfg.match.prune_block)
                        if cfg.match.prune else None)
        # only the asked capacity is handed out (never a padding slot)
        self._free: List[int] = list(range(self.capacity))
        self._sessions: Dict[str, int] = {}
        self._prev_odom: Dict[str, np.ndarray] = {}
        self._pending: Dict[int, tuple] = {}
        # slots whose next scan relocks: opened, or last answer lost
        self._relock: set = set()
        self._ticks = 0           # steps taken: the tracer's requests

    # -- session lifecycle ------------------------------------------------
    def open_session(self, sid: str, lines_info, map_cache, resol,
                     ori_x, ori_y) -> None:
        """Take a free slot for ``sid`` with this map; its first scan
        relocks.  No read of the device."""
        with trace.span("pool.open_session"):
            if sid in self._sessions:
                raise ValueError(f"session {sid!r} already open")
            if not self._free:
                raise RuntimeError("pool full")
            h, w = map_cache.shape
            if h > self.H or w > self.W:
                raise ValueError(f"map {h}x{w} exceeds canvas "
                                 f"{self.H}x{self.W}")
            M = self.cfg.shapes.max_map_lines
            k = len(lines_info)
            if k > M:
                # caps are never silent (ShapeConfig contract)
                raise ValueError(f"map has {k} lines > "
                                 f"shapes.max_map_lines={M}; raise the cap")
            slot = self._free.pop(0)
            self._sessions[sid] = slot
            self._relock.add(slot)
            if not self._mine.start <= slot < self._mine.stop:
                return            # another rank's slot: the table only
            slot -= self._mine.start
            dev = self.device
            c = self._ctxs
            dt = c.lines.dtype
            c.lines[slot] = 0
            c.lines[slot, :k] = torch.as_tensor(lines_info).to(dev, dt)
            c.lines_mask[slot] = torch.arange(M, device=dev) < k
            # the slot's canvas: its map, the cap elsewhere, in the working
            # type (an f64 pool keeps the f64 field, as make_map_context does)
            cache = torch.full((self.H, self.W), self.cfg.map.z_occ_max_dis,
                               dtype=dt, device=dev)
            cache[:h, :w] = torch.as_tensor(map_cache).to(dev, dt)
            cache = self._quantize(cache)
            _put(c.cache, slot, cache)
            c.rows[slot], c.cols[slot] = h, w
            for name, v in (("resol", resol), ("ori_x", ori_x),
                            ("ori_y", ori_y)):
                getattr(c, name)[slot] = float(v)
            if self._coarse is not None:
                _put(self._coarse, slot,
                     coarse_field(cache, self.cfg.match.prune_block))
            self._reset_slot(slot)

    def close_session(self, sid: str) -> None:
        with trace.span("pool.close_session"):
            slot = self._sessions.pop(sid)
            self._prev_odom.pop(sid, None)
            self._pending.pop(slot, None)
            self._free.append(slot)

    def _reset_slot(self, slot: int) -> None:
        fresh = init_state(self._states.kalman_x.dtype, self.device)
        for f in dataclasses.fields(TrackState):
            getattr(self._states, f.name)[slot] = getattr(fresh, f.name)

    @property
    def n_active(self) -> int:
        return len(self._sessions)

    # -- per-tick IO ------------------------------------------------------
    def submit_scan(self, sid: str, ranges, angles,
                    odom: Optional[np.ndarray] = None) -> None:
        slot = self._sessions[sid]
        N = self.cfg.shapes.points_per_scan
        n = len(ranges)
        if n > N:
            # caps are never silent (ShapeConfig contract)
            raise ValueError(f"scan has {n} points > "
                             f"shapes.points_per_scan={N}; raise the cap")
        odom = np.zeros(3, self.dtype) if odom is None else \
            np.asarray(odom, self.dtype)
        prev = self._prev_odom.get(sid, odom)
        if slot in self._pending:
            # overwriting an unprocessed scan: keep ITS prev (the last
            # odometry the filter actually consumed), or the dropped
            # scan's motion would vanish from the UKF prediction
            prev = self._pending[slot][3]
        self._pending[slot] = (np.asarray(ranges), np.asarray(angles[:n]),
                               n, prev, odom)
        self._prev_odom[sid] = odom

    def step(self) -> Dict[str, dict]:
        """One batched step over all slots with one host -> device copy
        of the submitted scans and one device -> host read of the
        outputs; returns the outputs (numpy) of every session that had
        a scan."""
        if not self._pending:
            return {}
        self._ticks += 1
        with trace.span("pool.step", self._ticks) as sp:
            relock = sorted(self._relock.intersection(self._pending))
            inputs, active = self._pack()
            self._states, outs = _pool_step(self._states, inputs,
                                            self._ctxs, active, self.cfg,
                                            self._coarse, bool(relock))
            with trace.span("pool.readback"):
                host = to_host(gather_lanes(self._axis, outs))
            results = {sid: {k: v[slot] for k, v in host.items()}
                       for sid, slot in self._sessions.items()
                       if slot in self._pending}
            lost = {slot for slot in self._pending
                    if not np.isfinite(host["score"][slot])}
            self._relock = (self._relock - set(self._pending)) | lost
            if relock:
                trace.count("pool.relock_ticks")
                trace.count("pool.relock_lanes", len(relock))
                trace.count("pool.relock_overflow", int(
                    host["candidate_overflow"][relock].sum()))
            sp.set(slots_stepped=self.capacity, scans_carried=len(results),
                   relock_lanes=len(relock))
            self._pending.clear()
            return results

    def _pack(self):
        """This rank's submitted scans in one host buffer, copied to the
        device once: the step's inputs and the active flags."""
        N = self.cfg.shapes.points_per_scan
        lo, hi = self._mine.start, self._mine.stop
        B = hi - lo
        with trace.span("pool.pack"):
            # per slot of this rank: ranges, angles (zero-padded to N),
            # odom_prev, odom_cur, the point count and the active flag
            # (both exact)
            buf = np.zeros((B, 2 * N + 8), self.dtype)
            for slot, (r, a, n, p, c) in self._pending.items():
                if not lo <= slot < hi:
                    continue
                slot -= lo
                buf[slot, :n] = r
                buf[slot, N:N + n] = a
                buf[slot, 2 * N:2 * N + 3] = p
                buf[slot, 2 * N + 3:2 * N + 6] = c
                buf[slot, 2 * N + 6] = n
                buf[slot, 2 * N + 7] = 1
            t = torch.from_numpy(buf).to(self.device)
            n = t[:, 2 * N + 6].to(torch.int32)
            valid = torch.arange(N, device=self.device) < n[:, None]
            inputs = (t[:, :N], t[:, N:2 * N], valid, n,
                      t[:, 2 * N:2 * N + 3], t[:, 2 * N + 3:2 * N + 6])
            return inputs, t[:, 2 * N + 7] > 0
