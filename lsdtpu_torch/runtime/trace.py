"""Observability: the stage tracer and host-read counters of the hot
paths, per-stage timing, device profiling, structured logs (counterpart
of lsdtpu/runtime/trace.py).

The reference's only instrumentation is a run-level clock() and
per-frame printfs (LSD/main_on_windows.cpp:17-18,189-190;
LSD/myFA.cpp:106,173).  Here:

* ``span(name)``: a stage of a hot path (the serving pool's tick, the
  streaming localizer's map switch and push, a batch's frames, the
  step's stages, map prep's stages), recorded as (name, start, end,
  parent, request, counts) on ``time.perf_counter_ns()``, the clock a
  device trace is aligned to.  Recording is on exactly while a
  ``torch.profiler`` profile is active in the process (any activities),
  or inside ``recording()``; off, a span site reads one module global
  and returns a shared no-op.  Python's garbage-collection pauses are
  recorded as ``host.gc`` spans while recording is on.
* ``host_read(site, tensor)``: every device -> host read a hot path
  waits on, counted under ``host_reads.<site>`` (always on, as is
  ``count``); ``counters()`` reads them.
* ``stage_timings``: a per-stage timing harness over the frame's stage
  functions; ``device_trace``: a torch.profiler scope that writes a
  Chrome trace of the host and the card; ``FrameLog``: structured
  per-frame JSONL records.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import time
from typing import IO, TYPE_CHECKING, Callable, Dict, List, NamedTuple, \
    Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig

if TYPE_CHECKING:
    from lsdtpu_torch.runtime.loop import MapContext

# -- the stage tracer ------------------------------------------------------
CAPACITY = 1 << 18         # spans kept; the oldest go first when full


class SpanRecord(NamedTuple):
    name: str
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]    # id of the span open when this one started
    request: object          # shared by every span of one request
    counts: dict             # integers of the span's work
    id: int


class _Forced:
    """The gate while ``recording()`` is open."""
    _is_profiler_enabled = True


# span sites read ``_gate._is_profiler_enabled``: torch.autograd.profiler
# itself (every profile's __enter__ sets it, whatever its activities), or
# _Forced inside recording()
_gate = _profiler
_forced = 0
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_open: List["_Span"] = []
_ids = itertools.count()
_counters: Dict[str, int] = collections.defaultdict(int)
_sources: Dict[str, Callable[[], int]] = {}
_gc_t0: Optional[int] = None          # the running collection's start


def _record(rec: SpanRecord) -> None:
    global _dropped
    if len(_buffer) == _buffer.maxlen:
        _dropped += 1
    _buffer.append(rec)


class _Span:
    __slots__ = ("name", "request", "counts", "parent", "id", "t0")

    def __init__(self, name: str, request, counts: dict):
        self.name, self.request, self.counts = name, request, counts

    def __enter__(self):
        up = _open[-1] if _open else None
        self.parent = None if up is None else up.id
        if self.request is None and up is not None:
            self.request = up.request
        self.id = next(_ids)
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _open and _open[-1] is self:
            _open.pop()
        _record(SpanRecord(self.name, self.t0, t1, self.parent,
                           self.request, self.counts, self.id))
        return False

    def set(self, **counts) -> None:
        """Set integer counts of the span's work."""
        self.counts.update(counts)


class _NoSpan:
    """The shared no-op span of a site while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _NoSpan()


def span(name: str, request=None, **counts):
    """A context manager around one stage of a hot path: recorded as a
    SpanRecord when it ends, while recording is on (module docstring).
    ``request`` defaults to the enclosing span's; ``counts`` (integers)
    may be set inside the span with ``.set(key=n)``."""
    if not _gate._is_profiler_enabled:
        return _OFF
    return _Span(name, request, counts)


@contextlib.contextmanager
def recording():
    """Record spans inside this scope, with no profiler (tests, scripts
    that time a whole run)."""
    global _gate, _forced
    _forced += 1
    _gate = _Forced
    try:
        yield
    finally:
        _forced -= 1
        if not _forced:
            _gate = _profiler


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (at most CAPACITY)."""
    return list(_buffer)


def dropped() -> int:
    """Spans dropped because the buffer was full."""
    return _dropped


def clear() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    _buffer.clear()
    _dropped = 0


def count(name: str, n: int = 1) -> None:
    """Add n to a process-wide counter (always on)."""
    _counters[name] += n


def register_counter(name: str, read: Callable[[], int]) -> None:
    """A counter kept elsewhere, read by ``counters()`` under ``name``."""
    _sources[name] = read


def counters() -> Dict[str, int]:
    """Every counter's current value."""
    out = dict(_counters)
    out.update((k, int(f())) for k, f in _sources.items())
    return out


def host_read(site: str, t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: one device -> host read the caller waits
    on, counted under ``host_reads.<site>``."""
    count("host_reads." + site)
    return t.cpu().numpy()


def _on_gc(phase: str, info: dict) -> None:
    """gc.callbacks: a collection's pause as a ``host.gc`` span."""
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter_ns() if _gate._is_profiler_enabled \
            else None
        return
    t0, _gc_t0 = _gc_t0, None
    if t0 is None or not _gate._is_profiler_enabled:
        return
    up = _open[-1] if _open else None
    _record(SpanRecord("host.gc", t0, time.perf_counter_ns(),
                       None if up is None else up.id,
                       None if up is None else up.request,
                       {"generation": int(info.get("generation", -1)),
                        "collected": int(info.get("collected", 0))},
                       next(_ids)))


gc.callbacks.append(_on_gc)


# -- per-stage timing, the profiler scope, per-frame logs -------------------
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
    # the hot paths import this module for its tracer
    from lsdtpu_torch.filter import ukf as fukf
    from lsdtpu_torch.geometry import c_round
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.scan.featurize import featurize
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
