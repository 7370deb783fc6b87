"""Region growth - exact FIFO growth, the FIFO radius reducer and
wave-synchronous growth: the wrappers around the hand-written CUDA
kernels (csrc/grow.cu) and their plain versions.

No TPU kernel stands behind these: the reference package runs them as
XLA while_loops, lsdtpu/mapprep/lsd.py:_grow_fifo, _grow and
lsdtpu/mapprep/rect.py:radius_reducer_fifo (reference: RegionGrower and
RegionRadiusReducer, LSD/myLSD.cpp:491-590, 736-802).  The FIFO walks
are serial queue walks, so eager PyTorch would pay tens of launches per
popped pixel; wave growth pays some twenty full-field launches and a
device read a wave.  On the card each call is one launch of a one-block
kernel that keeps its state in shared memory: ``grow_plan`` sizes the
FIFO region bitmap and queue there, ``wave_plan`` the wave kernel's two
bitmaps and lists, ``reduce_plan`` the reducer's slots and far flags.

``grow_fifo``, ``grow_wave`` and ``radius_reducer_fifo`` launch their
kernels for CUDA tensors and count the launches (``.launches``); for CPU
tensors, and only then, they call ``grow_fifo_reference``,
``grow_wave_reference`` and ``radius_reducer_fifo_reference``, host
loops over the same arrays (the wave one over full-field torch passes).
Nothing falls back: a CUDA input a kernel does not take raises.

The FIFO region's start angle is that of the seed pixel, whose sin and
cos come from the per-map tables ``sin_map``/``cos_map`` (sin/cos of
``deg_map``), as does every sin/cos the running mean adds: the kernel
and the plain version then differ only in atan2.  Wave growth starts
from a given angle (a device scalar) and adds each wave's sums from the
same tables; its kernel adds them in another order than torch's sum.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lsdtpu_torch.ops import build

PI = math.pi
THREADS = 256     # csrc/grow.cu's block size (checked when the library loads)
SMEM_MAX = 232_448  # shared bytes a block may use on sm_90 (checked too)
QUEUE_CAP = 16_384  # grow_fifo's shared queue entries at most (64 KB)
QUEUE_MIN = 4_096   # the fewest queue entries beside a shared bitmap
REDUCE_CAP = 8_192  # radius_reducer_fifo's shared entries at most (64 KB)
WAVE_STATIC = 1_024  # grow_wave's static shared bytes (checked too)
MAX_SIDE = 65_535   # a packed queue entry's y and x (y << 16 | x)

_FN: dict = {}


class Growth(NamedTuple):
    """One grown region."""

    cur: torch.Tensor      # (H, W) bool region mask
    reg_deg: torch.Tensor  # () running region angle, the working dtype
    qy: torch.Tensor       # (cap,) int32 queue buffers: the first n
    qx: torch.Tensor       # entries in acceptance order
    counts: torch.Tensor   # (3,) int32 [n, popped pixels, passes]


class WaveGrowth(NamedTuple):
    """One region grown in waves."""

    cur: torch.Tensor      # (H, W) bool region mask
    reg_deg: torch.Tensor  # () running region angle, the working dtype
    counts: torch.Tensor   # (3,) int32 [n, waves, candidate tests]


def fifo_queue(H: int, W: int, device):
    """(qy, qx) queue buffers at the cap H*W, allocated once per map and
    reused by every growth call: every pixel enters a queue at most once,
    so the cap can never bind."""
    return (torch.empty(H * W, dtype=torch.int32, device=device),
            torch.empty(H * W, dtype=torch.int32, device=device))


class GrowPlan(NamedTuple):
    """Where one grow_fifo launch keeps its region mask and queue."""

    shared_mask: bool  # the mask a bitmap in shared memory, else global
    mask_words: int    # the bitmap's 32-bit words (0 for a global mask)
    queue_cap: int     # queue entries in shared memory; later ones spill
    smem_bytes: int    # the launch's dynamic shared memory


def grow_plan(H: int, W: int) -> GrowPlan:
    """The shared-memory plan of a grow_fifo launch on an (H, W) field:
    a bitmap of the region mask when it fits beside QUEUE_MIN queue
    entries in SMEM_MAX, and the largest queue up to QUEUE_CAP (and the
    field's cells) in the rest; a larger field keeps its mask in the
    global uint8 output beside a queue of QUEUE_CAP."""
    if not (0 < H <= MAX_SIDE and 0 < W <= MAX_SIDE
            and H * W < 2 ** 31):
        raise ValueError(f"grow_fifo takes fields up to {MAX_SIDE} a side "
                         f"and 2**31 cells, got {H}x{W}")
    cells = H * W
    words = -(-cells // 32)
    shared = 4 * (words + min(QUEUE_MIN, cells)) <= SMEM_MAX
    room = SMEM_MAX // 4 - (words if shared else 0)
    cap = min(QUEUE_CAP, cells, room)
    words = words if shared else 0
    return GrowPlan(shared, words, cap, 4 * (words + cap))


class WavePlan(NamedTuple):
    """Where one grow_wave launch keeps its region, seen cells and lists."""

    shared_mask: bool  # two bitmaps in shared memory, else the global mask
    list_cap: int      # candidate-list entries in shared memory
    acc_cap: int       # a wave's accepted entries in shared memory
    smem_bytes: int    # the launch's dynamic shared memory


def wave_plan(H: int, W: int) -> WavePlan:
    """The shared-memory plan of a grow_wave launch on an (H, W) field:
    the region and seen bitmaps when they fit beside QUEUE_MIN entries of
    each list in SMEM_MAX (less the kernel's static WAVE_STATIC bytes),
    and the two lists of equal caps up to QUEUE_CAP (and the field's
    cells) in the rest; entries past a cap spill to the per-map queue
    buffers.  A larger field keeps its state in the global uint8 mask."""
    grow_plan(H, W)   # the field limits of a packed entry
    cells = H * W
    words = 2 * -(-cells // 32)
    budget = (SMEM_MAX - WAVE_STATIC) // 4
    shared = words + 2 * min(QUEUE_MIN, cells) <= budget
    words = words if shared else 0
    cap = min(QUEUE_CAP, cells, (budget - words) // 2)
    return WavePlan(shared, cap, cap, 4 * (words + 2 * cap))


class ReducePlan(NamedTuple):
    """Where one radius_reducer_fifo launch keeps the queue's slots."""

    cap: int            # slots held in shared memory; later ones stay global
    flag_words: int     # 32-slot words of far flags, one bit a slot
    shared_flags: bool  # the flags in shared memory, else a global buffer
    smem_bytes: int     # the launch's dynamic shared memory


def reduce_plan(entries: int) -> ReducePlan:
    """The shared-memory plan of a reducer launch on a queue of
    ``entries`` slots: up to REDUCE_CAP slots (8 bytes each) and a far
    flag for every slot, in shared memory while they fit in SMEM_MAX."""
    cap = max(1, min(REDUCE_CAP, entries))
    words = max(1, -(-entries // 32))
    shared = 8 * cap + 4 * words <= SMEM_MAX
    return ReducePlan(cap, words, shared, 8 * cap + (4 * words if shared
                                                     else 0))


def _lib(name, dtype):
    key = (name, dtype)
    if key not in _FN:
        lib = build.load_library("grow")
        lib.lsd_grow_threads.restype = ctypes.c_int32
        lib.lsd_grow_smem_max.restype = ctypes.c_int32
        lib.lsd_grow_wave_static.restype = ctypes.c_int32
        got = (lib.lsd_grow_threads(), lib.lsd_grow_smem_max(),
               lib.lsd_grow_wave_static())
        if got != (THREADS, SMEM_MAX, WAVE_STATIC):
            raise RuntimeError(
                f"csrc/grow.cu's block size and shared budgets {got} are "
                f"not ops/grow.py's {(THREADS, SMEM_MAX, WAVE_STATIC)}")
        sfx = "f32" if dtype == torch.float32 else "f64"
        real = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "grow":
            fn = getattr(lib, f"lsd_grow_fifo_{sfx}")
            fn.argtypes = [i, i, real, p, p, p, p, p, i, i, i, i, p, p, p,
                           p, p, p]
        elif name == "wave":
            fn = getattr(lib, f"lsd_grow_wave_{sfx}")
            fn.argtypes = [i, i, p, real, p, p, p, p, p, i, i, i, i, i, p, p,
                           p, p, p, p]
        else:
            fn = getattr(lib, f"lsd_radius_reducer_fifo_{sfx}")
            fn.argtypes = [i, i, real, p, p, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _FN[key] = fn
    return _FN[key]


PROBE_RING = 1024  # csrc/grow.cu's kProbeRing


def latency_probe(device="cuda", steps: int = 4096) -> dict:
    """SM cycles of one dependent step on the card, for the queue
    kernels' chain bound: a shared-memory load ("smem_load"), an L1 hit
    on the read-only path ("l1_load"), and in each working type an atan2
    ("atan2_float64", "atan2_float32"), one acceptance of grow_fifo - its
    add, atan2 and the next angle test ("accept_float64", ...) - and one
    distance test of the reducer ("dist_float64", ...); each the mean over
    a chain of ``steps`` (csrc/grow.cu:latency_probe_kernel, one thread,
    clock64).  A measurement, not a kernel of map prep: it is not
    counted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the latency probe runs on a CUDA device, not {dev}")
    lib = build.load_library("grow")
    fn = lib.lsd_grow_latency_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ring = (torch.arange(1, PROBE_RING + 1, device=dev) % PROBE_RING).to(
        torch.int32)
    keys = ("smem_load", "l1_load", "atan2_float64", "atan2_float32",
            "accept_float64", "accept_float32", "dist_float64",
            "dist_float32")
    out = torch.zeros(len(keys) + 1, dtype=torch.int64, device=dev)
    err = fn(ring.data_ptr(), steps, out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"latency probe launch failed: CUDA error {err}")
    cycles = out.cpu().tolist()
    return {k: cycles[i] / steps for i, k in enumerate(keys)}


def _check_grow(name, seed_y, seed_x, deg_thre, mask, deg_map, sin_map,
                cos_map, queue, seed_deg=None):
    """The inputs of grow_fifo (mask: ban) or grow_wave (mask: free,
    seed_deg: the start angle)."""
    dt = deg_map.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32/float64, got {dt}")
    if deg_map.dim() != 2:
        raise ValueError(f"deg_map must be (H, W), got {tuple(deg_map.shape)}")
    H, W = deg_map.shape
    if not (0 <= seed_y < H and 0 <= seed_x < W):
        raise ValueError(f"seed ({seed_y}, {seed_x}) outside {H}x{W}")
    grow_plan(H, W)
    for label, t in (("sin_map", sin_map), ("cos_map", cos_map)):
        if t.dtype != dt or t.shape != deg_map.shape:
            raise TypeError(f"{label} must be {dt} {tuple(deg_map.shape)}")
    if mask.dtype != torch.bool or mask.shape != deg_map.shape:
        raise TypeError(f"the {name} mask must be a bool mask of deg_map's "
                        "shape")
    qy, qx = queue
    for t in (qy, qx):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError("the queue buffers must be int32 vectors")
        if t.numel() < H * W:
            raise ValueError(
                f"queue cap {t.numel()} < H*W={H * W}: an undersized queue "
                "would silently truncate region growth")
    tensors = [mask, deg_map, sin_map, cos_map, qy, qx]
    scalars = [("deg_thre", deg_thre)] + (
        [] if seed_deg is None else [("seed_deg", seed_deg)])
    for label, v in scalars:
        if torch.is_tensor(v):
            if v.dtype != dt or v.numel() != 1:
                raise TypeError(f"{label} must be a one-element {dt} tensor")
            tensors.append(v)
        elif label == "seed_deg":
            raise TypeError("seed_deg must be a one-element tensor")
    for t in tensors:
        if t.device != deg_map.device:
            raise ValueError(f"all inputs must be on {deg_map.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")


def grow_fifo(seed_y: int, seed_x: int, deg_thre, ban, deg_map, sin_map,
              cos_map, queue=None) -> Growth:
    """Exact-order FIFO region growth from (seed_y, seed_x).

    deg_thre: the angle tolerance, a float or a one-element tensor of
    deg_map's dtype on its device (read there, no host sync); ban: (H, W)
    bool, the pixels growth may not enter (used == 1); deg_map, sin_map,
    cos_map: (H, W) level-line angles and their sin/cos; queue: the
    per-map (qy, qx) buffers of fifo_queue (allocated here when None)."""
    H, W = deg_map.shape
    if queue is None:
        queue = fifo_queue(H, W, deg_map.device)
    _check_grow("grow_fifo", seed_y, seed_x, deg_thre, ban, deg_map, sin_map,
                cos_map, queue)
    if deg_map.device.type == "cpu":
        return grow_fifo_reference(seed_y, seed_x, deg_thre, ban, deg_map,
                                   sin_map, cos_map, queue)
    if deg_map.device.type != "cuda":
        raise ValueError(f"no kernel for device {deg_map.device}")
    dev = deg_map.device
    qy, qx = queue
    plan = grow_plan(H, W)
    cur = torch.empty((H, W), dtype=torch.bool, device=dev)
    reg_deg = torch.empty((), dtype=deg_map.dtype, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    thre_t = torch.is_tensor(deg_thre)
    err = _lib("grow", deg_map.dtype)(
        int(seed_y), int(seed_x), 0.0 if thre_t else float(deg_thre),
        deg_thre.data_ptr() if thre_t else None, ban.data_ptr(),
        deg_map.data_ptr(), sin_map.data_ptr(), cos_map.data_ptr(), H, W,
        int(plan.shared_mask), plan.queue_cap, qy.data_ptr(), qx.data_ptr(),
        cur.data_ptr(), reg_deg.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grow_fifo kernel launch failed: CUDA error {err}")
    grow_fifo.launches += 1
    return Growth(cur, reg_deg, qy, qx, counts)


grow_fifo.launches = 0


def _scalar_ops(dtype):
    """(cast, atan2, sqrt) of host scalars in ``dtype``: Python floats for
    float64, numpy float32 scalars (rounded after every operation) for
    float32."""
    if dtype == torch.float64:
        return float, math.atan2, math.sqrt
    return np.float32, np.arctan2, np.sqrt


def grow_fifo_reference(seed_y: int, seed_x: int, deg_thre, ban, deg_map,
                        sin_map, cos_map, queue) -> Growth:
    """Plain version of grow_fifo (same contract), a host loop over the
    CPU tensors' buffers."""
    H, W = deg_map.shape
    t, atan2, _ = _scalar_ops(deg_map.dtype)
    deg = memoryview(deg_map.reshape(-1).numpy())
    sn = memoryview(sin_map.reshape(-1).numpy())
    cs = memoryview(cos_map.reshape(-1).numpy())
    banned = memoryview(ban.reshape(-1).numpy())
    thre = t(float(deg_thre))
    fold, two_pi = t(1.5 * PI), t(2.0 * PI)
    s = seed_y * W + seed_x
    s_sin, s_cos = t(sn[s]), t(cs[s])
    d = atan2(s_sin, s_cos)
    cur = bytearray(H * W)
    cur[s] = 1
    qy, qx = [seed_y], [seed_x]
    pops = passes = ex = 0
    while ex != len(qy):
        ex = len(qy)
        passes += 1
        i = 0
        while i < len(qy):
            ry, rx = qy[i], qx[i]
            i += 1
            pops += 1
            for m in (ry - 1, ry, ry + 1):
                if not 0 <= m < H:
                    continue
                for n in (rx - 1, rx, rx + 1):
                    if not 0 <= n < W:
                        continue
                    k = m * W + n
                    if cur[k] or banned[k]:
                        continue
                    cd = t(deg[k])
                    dif = abs(d - cd)
                    if dif > fold:
                        dif = abs(dif - two_pi)
                    if dif < thre:
                        s_sin = s_sin + t(sn[k])
                        s_cos = s_cos + t(cs[k])
                        d = atan2(s_sin, s_cos)
                        cur[k] = 1
                        qy.append(m)
                        qx.append(n)
    n = len(qy)
    queue[0][:n] = torch.tensor(qy, dtype=torch.int32)
    queue[1][:n] = torch.tensor(qx, dtype=torch.int32)
    mask = torch.from_numpy(np.frombuffer(cur, dtype=np.bool_).copy())
    return Growth(mask.reshape(H, W),
                  torch.tensor(float(d), dtype=deg_map.dtype), queue[0],
                  queue[1], torch.tensor([n, pops, passes],
                                         dtype=torch.int32))


def grow_wave(seed_y: int, seed_x: int, seed_deg, deg_thre, free, deg_map,
              sin_map, cos_map, queue=None) -> WaveGrowth:
    """Wave-synchronous region growth from (seed_y, seed_x): one launch,
    whose counts the caller reads once.

    seed_deg: the start angle, a one-element tensor of deg_map's dtype on
    its device (read there); deg_thre: the angle tolerance, a float or
    such a tensor; free: (H, W) bool, the pixels growth may enter
    (used != 1); deg_map, sin_map, cos_map: (H, W) level-line angles and
    their sin/cos; queue: the per-map (qy, qx) buffers of fifo_queue, the
    kernel's spill space (allocated here when None)."""
    H, W = deg_map.shape
    if queue is None:
        queue = fifo_queue(H, W, deg_map.device)
    _check_grow("grow_wave", seed_y, seed_x, deg_thre, free, deg_map,
                sin_map, cos_map, queue, seed_deg=seed_deg)
    if deg_map.device.type == "cpu":
        return grow_wave_reference(seed_y, seed_x, seed_deg, deg_thre, free,
                                   deg_map, sin_map, cos_map)
    if deg_map.device.type != "cuda":
        raise ValueError(f"no kernel for device {deg_map.device}")
    dev = deg_map.device
    qy, qx = queue
    plan = wave_plan(H, W)
    cells = H * W
    # the kernel changes the global mask's bytes by 32-bit atomics: the
    # allocation holds whole 16-byte words
    cur = torch.empty(-(-cells // 16) * 16, dtype=torch.bool,
                      device=dev)[:cells].view(H, W)
    reg_deg = torch.empty((), dtype=deg_map.dtype, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    thre_t = torch.is_tensor(deg_thre)
    err = _lib("wave", deg_map.dtype)(
        int(seed_y), int(seed_x), seed_deg.data_ptr(),
        0.0 if thre_t else float(deg_thre),
        deg_thre.data_ptr() if thre_t else None, free.data_ptr(),
        deg_map.data_ptr(), sin_map.data_ptr(), cos_map.data_ptr(), H, W,
        int(plan.shared_mask), plan.list_cap, plan.acc_cap, qx.data_ptr(),
        qy.data_ptr(), cur.data_ptr(), reg_deg.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grow_wave kernel launch failed: CUDA error {err}")
    grow_wave.launches += 1
    return WaveGrowth(cur, reg_deg, counts)


grow_wave.launches = 0


def grow_wave_reference(seed_y: int, seed_x: int, seed_deg, deg_thre, free,
                        deg_map, sin_map, cos_map, dilate=None, psum=None,
                        read=None) -> WaveGrowth:
    """Plain version of grow_wave (same contract): a host loop of
    full-field passes, a device read a wave.

    A row block of a sharded field (mapprep/lsd.py:_grow) grows by the
    same loop through three hooks: ``dilate``, the block's 8-neighbour
    dilation with its halo rows; ``psum``, the sum over the ranks of a
    wave's [accepted, sin sum, cos sum, candidates]; ``read``, the host
    read of the summed [accepted, candidates].  seed_y is then the row in
    the block, outside it when another rank holds the seed.  At one rank:
    the plain dilation, no sum and a plain read."""
    if dilate is None:
        def dilate(m):
            return F.max_pool2d(m.to(torch.float32)[None, None], 3, 1,
                                1)[0, 0] > 0.0
    psum = (lambda t: t) if psum is None else psum
    read = (lambda t: t.tolist()) if read is None else read
    cur = torch.zeros(deg_map.shape, dtype=torch.bool, device=deg_map.device)
    if 0 <= seed_y < deg_map.shape[0]:
        cur[seed_y, seed_x] = True
    sin = torch.sin(seed_deg)
    cos = torch.cos(seed_deg)
    deg = torch.atan2(sin, cos)
    n, waves, tests = 1, 0, 0
    while True:
        waves += 1
        cand = dilate(cur) & ~cur & free
        dif = torch.abs(deg - deg_map)
        dif = torch.where(dif > PI * 1.5, torch.abs(dif - 2 * PI), dif)
        acc = cand & (dif < deg_thre)
        s_sin = torch.where(acc, sin_map, 0.0).sum()
        s_cos = torch.where(acc, cos_map, 0.0).sum()
        # one collective: the counts ride exactly in the float type
        n_acc, s_sin, s_cos, n_cand = psum(torch.stack(
            [acc.sum().to(s_sin.dtype), s_sin, s_cos,
             cand.sum().to(s_sin.dtype)]))
        sin = sin + s_sin
        cos = cos + s_cos
        cur = cur | acc
        deg = torch.atan2(sin, cos)
        k, c = (int(v) for v in read(torch.stack([n_acc, n_cand])))
        tests += c
        if k == 0:
            return WaveGrowth(cur, deg, torch.tensor([n, waves, tests],
                                                     dtype=torch.int32))
        n += k


def _check_reduce(qy, qx, n, cur, fit):
    for name, t in (("qy", qy), ("qx", qx), ("n", n)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be an int32 vector")
    if n.numel() != 1:
        raise TypeError("n must be a one-element int32 tensor")
    for name, t in (("cur", cur), ("fit", fit)):
        if t.dtype != torch.bool or t.dim() != 2:
            raise TypeError(f"{name} must be an (H, W) bool mask")
    if fit.shape != cur.shape:
        raise ValueError("cur and fit must have one shape")
    for t in (qx, n, cur, fit):
        if t.device != qy.device:
            raise ValueError(f"all inputs must be on {qy.device}, got "
                             f"{t.device}")
    for t in (qy, qx, n, cur, fit):
        if not t.is_contiguous():
            raise ValueError("radius_reducer_fifo inputs must be contiguous")


def radius_reducer_fifo(seed_x: int, seed_y: int, rad, qy, qx, n, cur, fit):
    """One shrink pass of the FIFO radius reducer, in place.

    rad: the pass's radius, a numpy scalar of the working dtype
    (float32 or float64); qy, qx: the queue, whose first n (a
    one-element int32 tensor, updated) entries are live; cur: the region
    mask, fit: the mask the rectangle is fitted on (both updated)."""
    _check_reduce(qy, qx, n, cur, fit)
    if not isinstance(rad, (np.float32, np.float64)):
        raise TypeError(f"rad must be a numpy float32/float64 scalar, got "
                        f"{type(rad).__name__}")
    if qy.device.type == "cpu":
        return radius_reducer_fifo_reference(seed_x, seed_y, rad, qy, qx, n,
                                             cur, fit)
    if qy.device.type != "cuda":
        raise ValueError(f"no kernel for device {qy.device}")
    dt = torch.float32 if isinstance(rad, np.float32) else torch.float64
    plan = reduce_plan(min(qy.numel(), qx.numel()))
    flags = None if plan.shared_flags else torch.empty(
        plan.flag_words, dtype=torch.int32, device=qy.device)
    err = _lib("reduce", dt)(
        int(seed_x), int(seed_y), float(rad), qy.data_ptr(), qx.data_ptr(),
        n.data_ptr(), cur.data_ptr(), fit.data_ptr(), cur.shape[1],
        plan.cap, plan.flag_words,
        None if flags is None else flags.data_ptr(),
        torch.cuda.current_stream(qy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"radius_reducer_fifo kernel launch failed: CUDA "
                           f"error {err}")
    radius_reducer_fifo.launches += 1


radius_reducer_fifo.launches = 0


def radius_reducer_fifo_reference(seed_x: int, seed_y: int, rad, qy, qx, n,
                                  cur, fit):
    """Plain version of radius_reducer_fifo (same contract), a host loop."""
    t, _, sqrt = _scalar_ops(torch.float32 if isinstance(rad, np.float32)
                             else torch.float64)
    W = cur.shape[1]
    fx, fy = t(seed_x), t(seed_y)
    rad = t(rad)
    m = int(n[0])
    ys, xs = qy[:m].tolist(), qx[:m].tolist()
    cm, fm = cur.reshape(-1), fit.reshape(-1)
    k, i = m, 0
    while i < k:
        yi, xi = ys[i], xs[i]
        dx, dy = fx - t(xi), fy - t(yi)
        if sqrt(dx * dx + dy * dy) > rad:
            ys[i], xs[i] = ys[k - 1], xs[k - 1]
            k -= 1
            cm[yi * W + xi] = False
            fm[yi * W + xi] = False
        else:
            i += 1
    if sqrt(fx * fx + fy * fy) > rad and k > 0:
        fm[ys[k - 1] * W + xs[k - 1]] = False
        cm[0] = False
        k -= 1
    qy[:m] = torch.tensor(ys, dtype=torch.int32)
    qx[:m] = torch.tensor(xs, dtype=torch.int32)
    n[0] = k
