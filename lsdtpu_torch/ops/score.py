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

The kernel runs a persistent grid (``plan``: the card's SMs x the
blocks its launch bounds keep resident, fixed from the caps, never from
the live counts); block b scores the live slots b, b + grid, ..., each
over the whole live pixel prefix, which its threads hold in registers
(``split``: the same arithmetic as csrc/score.cu).
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

_FN: dict = {}
_SMS: dict = {}


class LaunchPlan(NamedTuple):
    grid: int             # blocks, at most sms x blocks_per_sm
    blocks_per_sm: int
    rounds: int           # rounds of HELD pixels at the cap P


def plan(K: int, P: int, n_sm: int, dtype) -> LaunchPlan:
    """The launch of a (K, P) call on a card with ``n_sm`` SMs: no more
    blocks than stay resident at once, and no more than the K slots."""
    if P >= MAX_PIXELS:
        raise ValueError(f"score_partials takes fewer than {MAX_PIXELS} "
                         f"pixel slots, got {P}")
    bps = RESIDENT[dtype]
    return LaunchPlan(max(1, min(n_sm * bps, K)), bps, max(1, -(-P // HELD)))


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


def _kernel(dtype):
    """The ctypes launcher for ``dtype`` (builds csrc/score.cu once)."""
    if dtype not in _FN:
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
        fn = lib.lsd_score_partials_f32 if dtype == torch.float32 \
            else lib.lsd_score_partials_f64
        real = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, p, i, i, i, i, i,
                       real, real, real, p, p, p, p, i, p]
        fn.restype = ctypes.c_int
        _FN[dtype] = fn
    return _FN[dtype]


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
    for name, t in (("px", px), ("py", py), ("cache", cache)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, cand6 is {dt}")
    for name, t in (("n_cand", n_cand), ("n_pix", n_pix)):
        if t.dtype != torch.int32 or t.numel() != 1:
            raise TypeError(f"{name} must be a one-element int32 tensor")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (K,)):
        raise TypeError("idx must be an int32 (K,) tensor or None")
    tensors = [cand6, px, py, cache, n_cand, n_pix] + \
        ([] if idx is None else [idx])
    dev = cand6.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("score_partials inputs must be contiguous")


def score_partials(cand6, idx, n_cand, px, py, n_pix, cache, row0: int,
                   rows: int, cols: int, z_occ_max_dis: float,
                   max_dist_penalty: float, obstacle_min_dist: float):
    """Per-slot CalcScore partials.

    cand6: (6, K) rows [ca, sa, sx, sy, mx, my]; idx: (K,) int32
    survivor list or None; n_cand: () int32 live slot count (slots
    [0, n_cand) are scored; with idx, slot b scores candidate idx[b]);
    px, py: (P,) pixel coordinates whose first n_pix () int32 entries
    are live (a prefix); cache: (block_h, pad_cols) field rows
    [row0, row0 + block_h) of a rows x cols map.  Returns (sum_d (K,),
    n_valid (K,) int32, sum_far (K,), n_far (K,) int32); dead slots are
    zero."""
    _check(cand6, idx, n_cand, px, py, n_pix, cache)
    if cand6.device.type == "cpu":
        return score_partials_reference(
            cand6, idx, n_cand, px, py, n_pix, cache, row0, rows, cols,
            z_occ_max_dis, max_dist_penalty, obstacle_min_dist)
    if cand6.device.type != "cuda":
        raise ValueError(f"no kernel for device {cand6.device}")
    K = cand6.shape[1]
    P = px.shape[0]
    dt = cand6.dtype
    dev = cand6.device
    block_h, pad_cols = cache.shape
    pl = plan(K, P, _sm_count(dev), dt)
    sum_d = torch.empty(K, dtype=dt, device=dev)
    sum_far = torch.empty_like(sum_d)
    n_valid = torch.empty(K, dtype=torch.int32, device=dev)
    n_far = torch.empty_like(n_valid)
    err = _kernel(dt)(
        cand6.data_ptr(), K, None if idx is None else idx.data_ptr(),
        n_cand.data_ptr(), px.data_ptr(), py.data_ptr(), P, n_pix.data_ptr(),
        cache.data_ptr(), block_h, pad_cols, int(row0), int(rows), int(cols),
        z_occ_max_dis, max_dist_penalty, obstacle_min_dist,
        sum_d.data_ptr(), n_valid.data_ptr(), sum_far.data_ptr(),
        n_far.data_ptr(), pl.grid,
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
                             obstacle_min_dist: float):
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
    block_h, pad_cols = cache.shape
    inside = (fx >= 0) & (fx < min(cols, pad_cols)) & \
        (fy >= max(row0, 0)) & (fy < min(rows, row0 + block_h))
    lin = (torch.where(inside, fy, row0).long() - row0) * pad_cols + \
        torch.where(inside, fx, 0).long()
    v = cache.reshape(-1)[lin]
    at_cap = v >= z_occ_max_dis
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
