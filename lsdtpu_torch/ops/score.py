"""CalcScore partials: the wrapper around the hand-written CUDA kernel
(csrc/score.cu) and its plain PyTorch version.

Replaces the TPU kernel lsdtpu/ops/score_pallas.py:_score_kernel and the
XLA transform+gather+reduce of lsdtpu/match/associate.py:_make_part_all
(reference: CalcScore, LSD/myFA.cpp:357-396).  For each candidate slot
the function returns the additive partials (sum_d, n_valid, sum_far,
n_far) over the live scan pixels; match/associate.finalize_scores turns
them into scores.

``score_partials`` launches the kernel for CUDA tensors and counts the
launch in ``score_partials.launches``; for CPU tensors, and only then,
it calls ``score_partials_reference``.  Nothing falls back: a CUDA
input the kernel does not take raises.

The field is stored in the working float type, bfloat16, or the
fixed-point u16/u8 codes of match.cache_dtype (``dequant``; the kernel
dequantizes each gathered cell).  It is the whole map or a window of it
(``col0``): a row-major view whose row stride the kernel takes as its
pitch, so the window is read in place.

The kernel runs a persistent grid (``plan``: the card's SMs x the
blocks its launch bounds keep resident, fixed from the caps, never from
the live counts); block b scores the live slots b, b + grid, ..., each
over the whole live pixel prefix, which its threads hold in registers
(``split``: the same arithmetic as csrc/score.cu).

``score_partials_batched`` scores a batch of B lanes (the robots of a
serving pool, the sequences of a batched rollout) in one launch of the
same kernel, with a grid of (grid, B): each lane its own candidates,
survivor list, counts, pixels, field on a common (B, H, W) canvas and
true map extent, and the same per-lane x-extent (``plan`` with
``lanes``; ``split_lanes`` and ``zero_split`` are the lane
decomposition), over each lane's whole field or over the same row block
``[row0, row0 + H)`` of every lane's (a map-block-sharded rank).  It counts its launches in
``score_partials_batched.launches``; for CPU tensors, and only then, it
calls ``score_partials_batched_reference``.  A lane's partials equal a
single-lane launch on that lane's inputs bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.ops import build

# csrc/score.cu's constants (checked against the library when it loads)
THREADS = 256                 # threads per block
PIX = 8                       # pixels a thread holds
HELD = THREADS * PIX          # pixels a block holds per round
RESIDENT = {torch.float32: 3, torch.float64: 2}   # blocks per SM
MAX_PIXELS = 1 << 18          # a warp's counts pack n_far << 16
U16_MAX = 65535
U8_MAX = 255
# fixed-point codes: the top code marks the cells at/above the cap
TOP_CODE = {torch.uint16: U16_MAX, torch.uint8: U8_MAX}
# the field storage types the kernel takes for each working type
STORAGE = {dt: (dt, torch.bfloat16, torch.uint16, torch.uint8)
           for dt in (torch.float32, torch.float64)}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.uint16: "u16", torch.uint8: "u8"}

_FN: dict = {}
_SMS: dict = {}


class LaunchPlan(NamedTuple):
    grid: int             # blocks, at most sms x blocks_per_sm
    blocks_per_sm: int
    rounds: int           # rounds of HELD pixels at the cap P


def plan(K: int, P: int, n_sm: int, dtype, lanes: int = 1) -> LaunchPlan:
    """The launch of a (K, P) call on a card with ``n_sm`` SMs: no more
    blocks than stay resident at once, and no more than the K slots.
    With ``lanes`` > 1, ``grid`` is each lane's x-extent: the lanes
    share the resident blocks evenly (at least one block a lane)."""
    if P >= MAX_PIXELS:
        raise ValueError(f"score_partials takes fewer than {MAX_PIXELS} "
                         f"pixel slots, got {P}")
    bps = RESIDENT[dtype]
    return LaunchPlan(max(1, min(n_sm * bps // lanes, K)), bps,
                      max(1, -(-P // HELD)))


def split(grid: int, n_live: int, n_pix: int):
    """The live work as the kernel takes it on the device: for each
    block, its slots (b, b + grid, ... below n_live), and for each
    thread t, the pixels q0 + t + THREADS * u (u < PIX) of every round
    q0 = 0, HELD, ... below n_pix."""
    slots = [list(range(b, n_live, grid)) for b in range(grid)]
    pixels = [[q0 + t + THREADS * u for q0 in range(0, n_pix, HELD)
               for u in range(PIX) if q0 + t + THREADS * u < n_pix]
              for t in range(THREADS)]
    return slots, pixels


def split_lanes(grid: int, n_live, n_pix):
    """``split`` of every lane of a batched launch (the grid's y axis):
    lane l's blocks take its live slots and pixels on their own."""
    return [split(grid, int(n), int(p)) for n, p in zip(n_live, n_pix)]


def zero_split(grid: int, n_live: int, K: int):
    """The dead slots [n_live, K) of one lane as its blocks zero them:
    for each block and thread, the slots n_live + block * THREADS +
    thread + k * grid * THREADS below K."""
    return [[list(range(n_live + b * THREADS + t, K, grid * THREADS))
             for t in range(THREADS)] for b in range(grid)]


def scale(z_occ_max_dis: float, storage, dtype) -> float:
    """The dequantization step of a fixed-point field: z / top code,
    computed in double and rounded to the working type (as the reference
    package's weakly typed Python scalar); 1.0 for a float field."""
    if storage not in TOP_CODE:
        return 1.0
    return float(torch.tensor(z_occ_max_dis / TOP_CODE[storage],
                              dtype=dtype))


def cells(field, *index):
    """field[index] for any storage type.  u16 codes come back widened to
    int32: PyTorch has few uint16 kernels, and none that index on the
    card, so they are gathered through an int16 view (exact)."""
    if field.dtype == torch.uint16:
        return field.view(torch.int16)[index].to(torch.int32) & U16_MAX
    return field[index]


def dequant(vals, dt, z_occ_max_dis: float, storage=None):
    """Gathered field cells of a ``storage`` field (default: vals' own
    type; ``cells`` widens u16 codes) -> (values in ``dt``, at-cap
    predicate): a fixed-point code is code * scale and at the cap
    exactly at the top code; a float cell is widened and at the cap
    where >= z."""
    storage = vals.dtype if storage is None else storage
    if storage in TOP_CODE:
        at_cap = vals == TOP_CODE[storage]
        step = torch.tensor(scale(z_occ_max_dis, storage, dt), dtype=dt,
                            device=vals.device)
        return vals.to(dt) * step, at_cap
    v = vals.to(dt)
    return v, v >= z_occ_max_dis


def gather_cells(flat, index):
    """``cells`` of a flat field (..., L) at an index tensor whose
    leading axes are the field's (one field per lane): flat[..., index]
    lane by lane, with index's shape."""
    lanes = tuple(flat.shape[:-1])
    i = index.reshape(lanes + (-1,))
    if flat.dtype == torch.uint16:
        out = torch.gather(flat.view(torch.int16), -1, i).to(torch.int32) \
            & U16_MAX
    else:
        out = torch.gather(flat, -1, i)
    return out.reshape(index.shape)


def _kernel(dtype, storage):
    """The ctypes launcher for ``dtype`` over a ``storage`` field (builds
    csrc/score.cu once)."""
    key = (dtype, storage)
    if key not in _FN:
        lib = build.load_library("score")
        got = (ctypes.c_int32 * 4)()
        lib.lsd_score_plan_constants.argtypes = [ctypes.c_void_p]
        lib.lsd_score_plan_constants.restype = None
        lib.lsd_score_plan_constants(ctypes.cast(got, ctypes.c_void_p))
        want = [THREADS, PIX, RESIDENT[torch.float32],
                RESIDENT[torch.float64]]
        if list(got) != want:
            raise RuntimeError(f"csrc/score.cu's plan constants {list(got)} "
                               f"are not ops/score.py's {want}")
        fn = getattr(lib, f"lsd_score_partials_{_SUFFIX[dtype]}_"
                          f"{_SUFFIX[storage]}")
        real = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, p, i, i, i, ctypes.c_longlong,
                       i, i, i, i, p, p, real, real, real, real, p, p, p, p,
                       i, i, p]
        fn.restype = ctypes.c_int
        _FN[key] = fn
    return _FN[key]


def _sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _check(cand6, idx, n_cand, px, py, n_pix, cache):
    dt = cand6.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"score_partials takes float32/float64, got {dt}")
    K = cand6.shape[1]
    if cand6.dim() != 2 or cand6.shape[0] != 6:
        raise ValueError(f"cand6 must be (6, K), got {tuple(cand6.shape)}")
    if px.dim() != 1 or px.shape != py.shape:
        raise ValueError("px, py must be equal (P,) vectors")
    if cache.dim() != 2:
        raise ValueError("cache must be a 2-D field block")
    for name, t in (("px", px), ("py", py)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, cand6 is {dt}")
    if cache.dtype not in STORAGE[dt]:
        raise TypeError(f"a {cache.dtype} field with {dt} scoring: the "
                        f"kernel takes {STORAGE[dt]}")
    if cache.stride(1) != 1 or cache.stride(0) < cache.shape[1]:
        raise ValueError("cache must be a row-major field block (unit column "
                         "stride)")
    for name, t in (("n_cand", n_cand), ("n_pix", n_pix)):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise TypeError(f"{name} must be a one-element int32 tensor")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (K,)):
        raise TypeError("idx must be an int32 (K,) tensor or None")
    tensors = [cand6, px, py, n_cand, n_pix] + ([] if idx is None else [idx])
    dev = cand6.device
    for t in tensors + [cache]:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("score_partials inputs must be contiguous")


def score_partials(cand6, idx, n_cand, px, py, n_pix, cache, row0: int,
                   rows: int, cols: int, z_occ_max_dis: float,
                   max_dist_penalty: float, obstacle_min_dist: float,
                   col0: int = 0):
    """Per-slot CalcScore partials.

    cand6: (6, K) rows [ca, sa, sx, sy, mx, my]; idx: (K,) int32
    survivor list or None; n_cand: () int32 live slot count (slots
    [0, n_cand) are scored; with idx, slot b scores candidate idx[b]);
    px, py: (P,) pixel coordinates whose first n_pix () int32 entries
    are live (a prefix); cache: (block_h, block_w) field cells
    [row0, row0 + block_h) x [col0, col0 + block_w) of a rows x cols
    map, in the working type, bfloat16, or u16/u8 codes (``dequant``),
    row-major with any row stride.  Returns (sum_d (K,), n_valid (K,)
    int32, sum_far (K,), n_far (K,) int32); dead slots are zero."""
    _check(cand6, idx, n_cand, px, py, n_pix, cache)
    if cand6.device.type == "cpu":
        return score_partials_reference(
            cand6, idx, n_cand, px, py, n_pix, cache, row0, rows, cols,
            z_occ_max_dis, max_dist_penalty, obstacle_min_dist, col0)
    if cand6.device.type != "cuda":
        raise ValueError(f"no kernel for device {cand6.device}")
    K = cand6.shape[1]
    P = px.shape[0]
    dt = cand6.dtype
    dev = cand6.device
    block_h, block_w = cache.shape
    pl = plan(K, P, _sm_count(dev), dt)
    sum_d = torch.empty(K, dtype=dt, device=dev)
    sum_far = torch.empty_like(sum_d)
    n_valid = torch.empty(K, dtype=torch.int32, device=dev)
    n_far = torch.empty_like(n_valid)
    err = _kernel(dt, cache.dtype)(
        cand6.data_ptr(), K, None if idx is None else idx.data_ptr(),
        n_cand.data_ptr(), px.data_ptr(), py.data_ptr(), P, n_pix.data_ptr(),
        cache.data_ptr(), block_h, block_w, cache.stride(0),
        block_h * cache.stride(0), int(row0), int(col0), int(rows),
        int(cols), None, None, z_occ_max_dis, max_dist_penalty,
        obstacle_min_dist, scale(z_occ_max_dis, cache.dtype, dt),
        sum_d.data_ptr(), n_valid.data_ptr(), sum_far.data_ptr(),
        n_far.data_ptr(), 1, pl.grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_partials kernel launch failed: CUDA "
                           f"error {err}")
    score_partials.launches += 1
    return sum_d, n_valid, sum_far, n_far


score_partials.launches = 0


def score_partials_reference(cand6, idx, n_cand, px, py, n_pix, cache,
                             row0: int, rows: int, cols: int,
                             z_occ_max_dis: float, max_dist_penalty: float,
                             obstacle_min_dist: float, col0: int = 0):
    """Plain PyTorch version of score_partials (same contract), the
    torch form of lsdtpu/match/associate.py:_make_part_all.  Reads the
    live counts on the host to slice the work to the live prefix."""
    K = cand6.shape[1]
    dev = cand6.device
    dt = cand6.dtype
    n = int(n_cand.clamp(0, K))
    P = int(n_pix)
    sel = torch.arange(n, device=dev) if idx is None else idx[:n].long()
    ca, sa, sx, sy, mx, my = cand6[:, sel][:, :, None]
    pxs = px[None, :P]
    pys = py[None, :P]
    tx = (pxs - sx) * ca - (pys - sy) * sa + mx
    ty = (pxs - sx) * sa + (pys - sy) * ca + my
    fx = geo.c_round(tx)
    fy = geo.c_round(ty)
    block_h, block_w = cache.shape
    inside = (fx >= max(col0, 0)) & (fx < min(cols, col0 + block_w)) & \
        (fy >= max(row0, 0)) & (fy < min(rows, row0 + block_h))
    v, at_cap = dequant(cells(cache,
                              torch.where(inside, fy, row0).long() - row0,
                              torch.where(inside, fx, col0).long() - col0),
                        dt, z_occ_max_dis, cache.dtype)
    contrib = torch.where(at_cap, max_dist_penalty, v)
    far = inside & (at_cap | (v >= obstacle_min_dist))

    def pad(x):
        out = torch.zeros((K,), dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    return (pad(torch.where(inside, contrib, 0.0).sum(1)),
            pad(inside.sum(1).to(torch.int32)),
            pad(torch.where(far, contrib, 0.0).sum(1)),
            pad(far.sum(1).to(torch.int32)))


def _check_batched(cand6, idx, n_cand, px, py, n_pix, cache, rows, cols):
    dt = cand6.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"score_partials_batched takes float32/float64, "
                        f"got {dt}")
    if cand6.dim() != 3 or cand6.shape[1] != 6:
        raise ValueError(f"cand6 must be (B, 6, K), got {tuple(cand6.shape)}")
    B, _six, K = cand6.shape
    if px.dim() != 2 or px.shape[0] != B or px.shape != py.shape:
        raise ValueError("px, py must be equal (B, P) tensors")
    if cache.dim() != 3 or cache.shape[0] != B:
        raise ValueError("cache must be the (B, H, W) canvas of the lanes")
    for name, t in (("px", px), ("py", py)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, cand6 is {dt}")
    if cache.dtype not in STORAGE[dt]:
        raise TypeError(f"a {cache.dtype} field with {dt} scoring: the "
                        f"kernel takes {STORAGE[dt]}")
    for name, t in (("n_cand", n_cand), ("n_pix", n_pix), ("rows", rows),
                    ("cols", cols)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise TypeError(f"{name} must be a (B,) int32 tensor")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (B, K)):
        raise TypeError("idx must be an int32 (B, K) tensor or None")
    tensors = [cand6, px, py, n_cand, n_pix, cache, rows, cols] + (
        [] if idx is None else [idx])
    dev = cand6.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("score_partials_batched inputs must be "
                             "contiguous")


def score_partials_batched(cand6, idx, n_cand, px, py, n_pix, cache, rows,
                           cols, z_occ_max_dis: float,
                           max_dist_penalty: float,
                           obstacle_min_dist: float, row0: int = 0):
    """Per-slot CalcScore partials of B lanes in one launch.

    cand6: (B, 6, K); idx: (B, K) int32 survivor lists or None; n_cand,
    n_pix: (B,) int32 live counts, read on the device; px, py: (B, P);
    cache: the (B, H, W) canvas, each lane's field in its top-left
    rows[l] x cols[l] cells (any storage type score_partials takes), or,
    with ``row0``, every lane's rows [row0, row0 + H) of its field (the
    row block of a map-block-sharded rank; rows past a lane's true
    extent never count); rows, cols: (B,) int32 true map extents, read
    on the device.  Returns (sum_d, n_valid, sum_far, n_far), each
    (B, K); dead slots are zero, lane by lane."""
    _check_batched(cand6, idx, n_cand, px, py, n_pix, cache, rows, cols)
    if cand6.device.type == "cpu":
        return score_partials_batched_reference(
            cand6, idx, n_cand, px, py, n_pix, cache, rows, cols,
            z_occ_max_dis, max_dist_penalty, obstacle_min_dist, row0)
    if cand6.device.type != "cuda":
        raise ValueError(f"no kernel for device {cand6.device}")
    B, _six, K = cand6.shape
    P = px.shape[1]
    H, W = cache.shape[1:]
    dt = cand6.dtype
    dev = cand6.device
    pl = plan(K, P, _sm_count(dev), dt, lanes=B)
    sum_d = torch.empty((B, K), dtype=dt, device=dev)
    sum_far = torch.empty_like(sum_d)
    n_valid = torch.empty((B, K), dtype=torch.int32, device=dev)
    n_far = torch.empty_like(n_valid)
    err = _kernel(dt, cache.dtype)(
        cand6.data_ptr(), K, None if idx is None else idx.data_ptr(),
        n_cand.data_ptr(), px.data_ptr(), py.data_ptr(), P, n_pix.data_ptr(),
        cache.data_ptr(), H, W, W, H * W, int(row0), 0, H, W,
        rows.data_ptr(), cols.data_ptr(), z_occ_max_dis, max_dist_penalty,
        obstacle_min_dist, scale(z_occ_max_dis, cache.dtype, dt),
        sum_d.data_ptr(), n_valid.data_ptr(), sum_far.data_ptr(),
        n_far.data_ptr(), B, pl.grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_partials_batched kernel launch failed: "
                           f"CUDA error {err}")
    score_partials_batched.launches += 1
    return sum_d, n_valid, sum_far, n_far


score_partials_batched.launches = 0


def score_partials_batched_reference(cand6, idx, n_cand, px, py, n_pix,
                                     cache, rows, cols,
                                     z_occ_max_dis: float,
                                     max_dist_penalty: float,
                                     obstacle_min_dist: float,
                                     row0: int = 0):
    """Plain PyTorch version of score_partials_batched (same contract):
    score_partials_reference on each lane's inputs, stacked."""
    B = cand6.shape[0]
    rows_h, cols_h = rows.tolist(), cols.tolist()
    parts = [score_partials_reference(
        cand6[b], None if idx is None else idx[b], n_cand[b], px[b], py[b],
        n_pix[b], cache[b], int(row0), rows_h[b], cols_h[b], z_occ_max_dis,
        max_dist_penalty, obstacle_min_dist) for b in range(B)]
    return tuple(torch.stack(p) for p in zip(*parts))
