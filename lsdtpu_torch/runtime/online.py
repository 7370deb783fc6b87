"""Online (streaming) localization - the ROS node equivalent
(counterpart of lsdtpu/runtime/online.py).

The reference's online entry is a ROS node: mapCallback builds the map
artifacts and sets an isMapReady guard, laserCallback runs FeatureScan
+ FeatureAssociation per incoming scan (reference:
LSD/main_on_linux.cpp:33-176).  Here the same lifecycle is a plain
object around the per-frame step with persistent filter state on the
device; scans stream in one at a time and each push returns the pose
estimate as numpy arrays, read from the device in one transfer.

Two matcher generations, mirroring the two reference main programs:
  * "tracking" (default): the current-generation dense matcher with HMM
    gating, weighted fusion and the odometry-fused UKF (LSD/myFA.cpp,
    the Windows V2.6 pipeline) - runtime/loop.localization_step, whose
    scorer is the CalcScore kernel on the card;
  * "legacy": the ROS V2.2 global first-minimum matcher over raw polar
    reprojection, stateless (ROS/lsd/src/FeatureAssociation.cpp;
    match/legacy.py, plain PyTorch).

Map prep from a grid (set_map) runs the port's prepare_map on the
localizer's device (wave growth, float32), or with mapprep="oracle" the
numpy oracle on the host (f64, the reference semantics; the counterpart
of the reference's use_tpu_mapprep=False), its arrays then moved to the
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.eval.ate import pixel_to_world
from lsdtpu_torch.mapprep.pipeline import prepare_map
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.match import legacy as mlegacy
from lsdtpu_torch.oracle import driver as odrv
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.checkpoint import load_session, save_state
from lsdtpu_torch.runtime.loop import (MapContext, TrackState,
                                       featurize_stage, init_state,
                                       localization_step, make_map_context,
                                       numpy_dtype, prepare_coarse)

# the ROS node builds its field with this cap (main_on_linux.cpp:129),
# and the legacy scorer tests it by equality
LEGACY_Z_OCC_MAX_DIS = 2.0
MAPPREPS = ("torch", "oracle")


def occupancy_grid_to_map_value(data, width: int, height: int) -> np.ndarray:
    """ROS OccupancyGrid payload -> dataset-convention map values.

    The reference's mapCallback reads the int8 grid bytes as unsigned and
    remaps 255 (int8 -1, unknown) -> 0, 0 (free) -> 255, anything else
    (occupancy percentage, e.g. 100) -> 1 = occupied
    (LSD/main_on_linux.cpp:108-124).
    """
    d = np.asarray(data).astype(np.int16).astype(np.uint8)
    d = d.reshape(int(height), int(width))
    out = np.ones_like(d)
    out[d == 255] = 0
    out[d == 0] = 255
    return out


def laser_scan_to_polar(ranges, angle_min: float, angle_increment: float):
    """ROS LaserScan -> compacted (ranges, angles) with INF dropped.

    The reference's laserCallback drops INF readings and reconstructs
    angles incrementally (LSD/main_on_linux.cpp:48-64).  Its compaction
    is buggy: valid points are stored at their ORIGINAL index i while
    only the first len_lp entries are consumed, so interleaved INFs make
    it read stale points from the previous frame.  This compacts
    properly (the Windows main program's behavior,
    main_on_windows.cpp:110-124).
    """
    r = np.asarray(ranges, np.float64)
    ang = angle_min + np.arange(r.shape[0], dtype=np.float64) \
        * angle_increment
    keep = np.isfinite(r)
    return r[keep], ang[keep]


def _legacy_step(ranges, angles, valid, n, ctx: MapContext,
                 cfg: EngineConfig) -> dict:
    """One legacy frame: featurize, the legacy candidates (the lidar
    position not rounded), their scores, the first minimum."""
    fs = featurize_stage((ranges, angles, valid, n, None, None), ctx, cfg)
    cand = mlegacy.generate_candidates_legacy(
        fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask, fs.lidar_pos,
        ctx.resol, max_candidates=cfg.shapes.max_candidates)
    scores = mlegacy.score_candidates_legacy(
        cand, ranges, angles, valid, n, ctx.cache, ctx.resol,
        rows=ctx.rows, cols=ctx.cols, z_occ_max_dis=LEGACY_Z_OCC_MAX_DIS)
    pose, best = mlegacy.first_min_pose(cand, scores)
    world = mlegacy.pixel_to_world(pose, ctx.resol, ctx.ori_x, ctx.ori_y)
    return {"pose": pose, "pose_world": world, "score": best,
            "n_candidates": torch.isfinite(scores).sum(),
            "candidate_overflow": (cand.count > cand.mask.shape[0]) |
                                  fs.overflow}


def to_host(out: dict, site: str = "online.readback") -> dict:
    """The outputs as numpy arrays of their own dtypes and shapes, read
    from the device in one transfer (every value, counts and flags
    included, is exact in float64), counted as the tracer's
    ``host_reads.<site>``."""
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in out.values()])
    host = trace.host_read(site, flat)
    res, i = {}, 0
    for k, v in out.items():
        n = v.numel()
        res[k] = host[i:i + n].reshape(tuple(v.shape)).astype(
            numpy_dtype(v.dtype))
        i += n
    return res


class OnlineLocalizer:
    """Streaming localization session on one device.

    >>> loc = OnlineLocalizer()                        # on the card
    >>> loc.set_map(map_value, resol, ori_x, ori_y)    # mapCallback
    >>> out = loc.push_scan(ranges, angles, odom_xyang)  # laserCallback

    One scan a push: cfg's prefeaturize and scan_unroll are ignored."""

    def __init__(self, cfg: EngineConfig = DEFAULT, mode: str = "tracking",
                 dtype=np.float32, device="cuda", mapprep: str = "torch"):
        if mode not in ("tracking", "legacy"):
            raise ValueError(f"unknown mode {mode!r}")
        if mapprep not in MAPPREPS:
            raise ValueError(f"mapprep={mapprep!r}: expected one of "
                             f"{MAPPREPS}")
        self.cfg = cfg
        self.mode = mode
        self.mapprep = mapprep
        self.dtype = numpy_dtype(dtype).type
        self.device = resolve_device(device)
        self.ctx: Optional[MapContext] = None
        self.state: Optional[TrackState] = None
        self._coarse = None
        self._world = None
        self._prev_odom: Optional[np.ndarray] = None
        # the last set_map's map-prep counters (None for the oracle's)
        self.last_mapprep_stats: Optional[MapPrepStats] = None
        self._maps = self._pushes = 0     # the tracer's requests

    @property
    def is_map_ready(self) -> bool:
        """The reference's isMapReady guard (main_on_linux.cpp:31,50)."""
        return self.ctx is not None

    def set_map(self, map_value: np.ndarray, resol: float, ori_x: float,
                ori_y: float) -> int:
        """Build the map artifacts (mapCache + LSD lines): the port's
        map prep on the localizer's device, or the numpy oracle on the
        host (mapprep="oracle").  Returns #lines."""
        z = LEGACY_Z_OCC_MAX_DIS if self.mode == "legacy" else \
            self.cfg.map.z_occ_max_dis
        self._maps += 1
        with trace.span("online.set_map", ("map", self._maps)):
            if self.mapprep == "oracle":
                self.last_mapprep_stats = None
                art = odrv.prepare_map(np.asarray(map_value), resol,
                                       z_occ_max_dis=z)
            else:
                self.last_mapprep_stats = MapPrepStats()
                art = prepare_map(map_value, resol, z_occ_max_dis=z,
                                  device=self.device,
                                  stats=self.last_mapprep_stats)
            with trace.span("mapprep.context"):
                self.set_map_artifacts(art.lines_info, art.map_cache, resol,
                                       ori_x, ori_y)
            return int(art.lines_info.shape[0])

    def set_map_occupancy_grid(self, data, width: int, height: int,
                               resol: float, ori_x: float,
                               ori_y: float) -> int:
        """mapCallback over a ROS-shaped OccupancyGrid payload: converts
        the int8 grid (main_on_linux.cpp:108-124) and builds artifacts.
        Returns #lines."""
        return self.set_map(occupancy_grid_to_map_value(data, width,
                                                        height),
                            resol, ori_x, ori_y)

    def push_laser_scan(self, ranges, angle_min: float,
                        angle_increment: float,
                        odom: Optional[np.ndarray] = None) -> dict:
        """laserCallback over a ROS-shaped LaserScan: INF readings are
        dropped, angles reconstructed incrementally
        (main_on_linux.cpp:48-64)."""
        r, a = laser_scan_to_polar(ranges, angle_min, angle_increment)
        return self.push_scan(r.astype(self.dtype), a.astype(self.dtype),
                              odom)

    def set_map_artifacts(self, lines_info, map_cache, resol: float,
                          ori_x: float, ori_y: float) -> None:
        """Map artifacts (numpy arrays or tensors) -> the session's map
        context on its device; resets the filter chain."""
        cache_dtype = self.cfg.match.cache_dtype
        if self.mode == "legacy" and cache_dtype not in ("f32", "default"):
            # the legacy matcher gathers the raw float field and tests
            # the z=2 cap by equality (match/legacy.py) - it has no
            # dequant step, so compressed fields would score garbage
            raise ValueError(
                "legacy mode needs match.cache_dtype='f32' (the legacy "
                "scorer reads the raw float field)")
        self.ctx = make_map_context(
            lines_info, map_cache, resol, ori_x, ori_y,
            max_map_lines=self.cfg.shapes.max_map_lines, dtype=self.dtype,
            cache_dtype=cache_dtype,
            z_occ_max_dis=self.cfg.map.z_occ_max_dis, device=self.device)
        # the map geometry as the context holds it, on the host, for
        # pose_world without a device read per scan
        self._world = tuple(float(self.dtype(v))
                            for v in (resol, ori_x, ori_y))
        # per-map pruning field, loop-invariant: computed once here,
        # never per pushed scan
        self._coarse = prepare_coarse(self.ctx, self.cfg)
        self.reset()

    def reset(self) -> None:
        """Tracking-loss style reset of the filter chain."""
        self.state = init_state(self.dtype, self.device)
        self._prev_odom = None

    def push_scan(self, ranges: np.ndarray, angles: np.ndarray,
                  odom: Optional[np.ndarray] = None) -> dict:
        """Process one scan; returns per-frame outputs as numpy arrays
        (pose in map px, pose_world in meters, score, ...).

        ranges/angles: (n,) valid polar points; odom: (3,) [x, y, ang]
        cumulative odometry (tracking mode only; the first frame may
        omit it, and its odometry is its own anchor)."""
        if not self.is_map_ready:
            raise RuntimeError("map not set (isMapReady guard)")
        N = self.cfg.shapes.points_per_scan
        n = len(ranges)
        if n > N:
            # caps are never silent (ShapeConfig contract)
            raise ValueError(f"scan has {n} points > "
                             f"shapes.points_per_scan={N}; raise the cap")
        odom = np.zeros(3, self.dtype) if odom is None else \
            np.asarray(odom, self.dtype)
        prev = self._prev_odom if self._prev_odom is not None else odom
        self._pushes += 1
        with trace.span("online.push", ("push", self._pushes)):
            with trace.span("online.pack"):
                # one host -> device copy: ranges, angles (zero-padded to
                # N) and the two odometry readings
                buf = np.zeros(2 * N + 6, self.dtype)
                buf[:n] = ranges
                buf[N:N + n] = angles[:n]
                buf[2 * N:2 * N + 3] = prev
                buf[2 * N + 3:] = odom
                t = torch.from_numpy(buf).to(self.device)
                r, a = t[:N], t[N:2 * N]
                v = torch.arange(N, device=self.device) < n
                n_t = torch.full((), n, dtype=torch.int32,
                                 device=self.device)

            if self.mode == "legacy":
                out = _legacy_step(r, a, v, n_t, self.ctx, self.cfg)
                with trace.span("online.readback"):
                    return to_host(out)

            self.state, out = localization_step(
                self.state, (r, a, v, n_t, t[2 * N:2 * N + 3],
                             t[2 * N + 3:]),
                self.ctx, self.cfg, coarse=self._coarse)
            self._prev_odom = odom
            with trace.span("online.readback"):
                res = to_host(out)
                xy = pixel_to_world(res["pose"][None], *self._world)
                res["pose_world"] = np.array([xy[0, 0], xy[0, 1],
                                              res["pose"][2]])
            return res

    # -- checkpoint / resume (runtime/checkpoint.py) ---------------------
    def save(self, path: str) -> None:
        """Checkpoint the full session carry: TrackState AND the
        odometry anchor, so restore() resumes mid-trajectory with the
        right first scan_pose delta."""
        save_state(path, self.state, prev_odom=self._prev_odom)

    def restore(self, path: str) -> None:
        self.state, prev = load_session(path, dtype=self.dtype,
                                        device=self.device)
        self._prev_odom = None if prev is None else np.asarray(prev)
