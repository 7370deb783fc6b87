"""Frozen configuration for the line-feature localization engine.

The port's own copy of the reference package's configuration: the same
dataclasses, fields and defaults.  Defaults mirror the reference's
compile-time constants (reference: LSD/baseFunc.h:56-87).  The static
shape caps (``max_*``) give every dynamically sized object of the
reference (lines, split points, scan pixels, candidates) a padded
fixed-width representation with a validity mask.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LSDConfig:
    """Line Segment Detector parameters (reference: LSD/baseFunc.h:60-68)."""

    sca: float = 0.3          # downsample scale (lsd_sca)
    sig: float = 0.6          # Gaussian sigma (lsd_sig)
    ang_thre: float = 22.5    # angle threshold, degrees (lsd_angThre)
    den_thre: float = 0.7     # density threshold (lsd_denThre)
    pse_bin: int = 1024       # pseudo-sort bins (pseBin)
    # region-growth order: "fifo" (the reference's exact FIFO acceptance
    # order) or "wave" (wave-synchronous; line sets structural).  Map
    # prep is not ported yet: the port takes map lines as inputs.
    growth: str = "fifo"
    # NFA rasterize+count backend of the map-prep slice (not ported yet)
    nfa_kernel: str = "xla"


@dataclasses.dataclass(frozen=True)
class RDPConfig:
    """Scan segmentation parameters (reference: LSD/baseFunc.h:69-72)."""

    least_point: int = 3      # min points per cluster (rdp_leastPoint)
    thre_line: float = 0.08   # split distance ratio threshold (rdp_threLine)
    least_dist: float = 0.5   # min extracted segment length, m (rdp_leastDist)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Feature association parameters (reference: LSD/baseFunc.h:73-86)."""

    ignore_scan_length: float = 40.0  # min scan line length, px (ignoreScanLength)
    scan_to_map_diff: float = 0.35    # length-diff gate ratio (scanToMapDiff)
    max_esti_dist: float = 60.0       # HMM gate radius, px (maxEstiDist)
    score_accept: float = 3.0         # candidate acceptance score (myFA.cpp:261)
    valid_ratio: float = 0.7          # CalcScore validity gate (myFA.cpp:389)
    max_dist_penalty: float = 10.0    # per-pixel cap penalty (myFA.cpp:381)
    # scoring backend name, kept for config compatibility with the
    # reference package: on a CUDA tensor every value routes to the
    # hand-written CalcScore kernel (ops/score.py, csrc/score.cu); on a
    # CPU tensor every value routes to its plain PyTorch version.
    score_kernel: str = "xla"
    # distance-field storage: "f32" (exact, at the rollout's float
    # dtype).  "bf16", "u16" and "u8" are not ported yet and raise.
    cache_dtype: str = "f32"
    # candidate/pixel chunking of the reference's scorer loops.  The
    # port's kernel reads the live candidate and pixel counts on the
    # device and needs no chunking: score_chunk and score_pixel_chunk
    # stay for config compatibility and are not read;
    # score_dynamic_chunks gates pruning, as in the reference package.
    score_dynamic_chunks: bool = True
    score_chunk: int = 40
    score_pixel_chunk: int = 192
    # windowed scoring (side length in px; 0 = off).  Not ported yet:
    # a value > 0 raises NotImplementedError.
    score_window: int = 0
    # exact candidate pruning: every live candidate gets a provable
    # lower bound on its CalcScore from a min-pooled+eroded coarse
    # distance field; candidates whose bound already fails score_accept
    # skip the exact kernel, which then runs over the survivor index
    # list only (match/associate.py score_candidates_pruned).
    prune: bool = True
    prune_block: int = 16     # coarse-field block size, px (covers group radius)
    prune_group: int = 16     # pixels per bound group (contiguous, compacted)
    # run the bound phase only when the live candidate count reaches
    # this: tracking frames (tens of gated candidates, most accepted)
    # would pay the bound without pruning anything; relock sweeps
    # (~1000 candidates) are where it pays.  0 = always prune.
    prune_min_live: int = 192
    # obstacle-tolerant scoring (beyond the reference; 0 = exact
    # reference formula): forgive up to this fraction of the scan's
    # pixels when they land at the distance cap.  Range [0, 0.5].
    obstacle_tolerance: float = 0.0
    # a pixel is forgivable when its field distance >= this (meters);
    # None = the mapCache cap z_occ_max_dis.
    obstacle_min_dist: float = None
    # ambiguity-aware relocalization (beyond the reference; 0 = off):
    # defer a global relock when a distinct accepted candidate scores
    # within (1+margin) of the winner.
    relock_margin: float = 0.0
    # coast-on-loss (beyond the reference; 0 = off): dead-reckon up to
    # this many consecutive no-candidate frames on rotated odometry
    # instead of resetting to the (-1,-1) sentinel.
    coast_on_loss: int = 0
    # sub-pixel Gauss-Newton polish of the fused pose.  Not ported yet:
    # True raises NotImplementedError.
    polish_pose: bool = False
    polish_iters: int = 4
    polish_max_px: float = 4.0   # total displacement cap (HMM basin)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map preprocessing parameters (reference: LSD/baseFunc.h:57)."""

    z_occ_max_dis: float = 1.0   # mapCache distance cap, m (Windows); ROS uses 2.0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Static shape caps (no reference equivalent - the reference uses
    dynamic allocation everywhere).  Exceeding a cap is never silent:
    the per-frame outputs flag it (candidate_overflow, which also
    covers scan line/pixel caps)."""

    points_per_scan: int = 360     # lidar points per revolution (pointPerLoop)
    max_scan_lines: int = 64       # scan segments per frame (cap)
    max_map_lines: int = 256       # LSD lines per map (cap)
    max_scan_pixels: int = 4096    # rasterized scan pixels per frame (cap)
    max_cells: int = 64            # clusters per scan (cap)
    # rasterization step grid per scan segment (major-axis pixels);
    # longer segments flag `overflow` (scan/featurize.py)
    max_scan_steps: int = 512
    max_splits: int = 360          # RDP split points (absolute bound)
    # gated (scan, map, 4) hypotheses; candidate_overflow flags excess
    max_candidates: int = 2048


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """UKF parameters (reference: LSD/myFA.cpp:404-536)."""

    alpha: float = 1e-2
    beta: float = 2.0
    kappa: float = 0.0
    dt: float = 1.0               # kalman_t


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level configuration bundle."""

    lsd: LSDConfig = dataclasses.field(default_factory=LSDConfig)
    rdp: RDPConfig = dataclasses.field(default_factory=RDPConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    shapes: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    # "faithful" reproduces reference bugs (odometry y-term
    # main_on_windows.cpp:151, and the perfect-score NaN chain: a
    # score-0 candidate gets weight 1/0 = inf and the fused pose
    # NaN-poisons tracking, myFA.cpp:161); "fixed" corrects them
    # (incl. a 1e-6 fusion weight floor - match/associate.fuse).
    faithful: bool = True
    # execution strategies of the reference package's lax.scan rollout
    # (batched featurization before the scan; k frames per scan body).
    # Both give identical outputs there; the port's frame loop has no
    # such choice and ignores them.
    prefeaturize: bool = False
    scan_unroll: int = 1
    scan_unroll_batch_featurize: bool = True


DEFAULT = EngineConfig()
