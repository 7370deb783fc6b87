"""NFA rectangle rasterize + count: the wrapper around the hand-written
CUDA kernel (csrc/nfa.cu) and its plain PyTorch version.

Replaces the TPU kernel lsdtpu/ops/nfa_pallas.py:_kernel (per-pixel
math rect_counts_math; reference: RectangleNFACalculator,
LSD/myLSD.cpp:926-1016).  For each rectangle of a batch the function
returns the two exact counts (all_pix, ali_pix): the pixels of the
level-line field the rectangle covers, and those among them whose
level-line angle is within ``prec`` of the rectangle's, over the whole
field or over one row block of it (``row0``, ``n_rows``: the sharded map
prep's per-rank counts, which a psum adds up).

``rect_counts`` launches the kernel for CUDA tensors and counts the
launch in ``rect_counts.launches``; for CPU tensors, and only then, it
calls ``rect_counts_reference``.  Nothing falls back: a CUDA input the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lsdtpu_torch.ops import build

PI = math.pi
INT_MIN = float(-(2 ** 31))

# packed scalar layout of one rectangle (mapprep/nfa.py
# pack_rect_scalars): [x_start, x_len, vx0..vx3, vy0..vy3, k0..k3, deg, prec]
N_SCALARS = 16

_FN: dict = {}


def c_int(v, up: bool):
    """C ceil/floor + cvttsd2si: non-finite or out-of-range values
    become INT_MIN (the x86 conversion the reference inherits,
    myLSD.cpp:983-999).  NaN and +-inf fail both range compares."""
    r = torch.ceil(v) if up else torch.floor(v)
    ok = (v >= INT_MIN) & (v < 2.0 ** 31)
    return torch.where(ok, r, INT_MIN)


def rect_inside(deg_map: torch.Tensor, scalars: torch.Tensor, row0: int = 0,
                n_rows=None):
    """(R, H, W) bool: the pixels each packed rectangle covers (iota
    grids and the per-column bounds, myLSD.cpp:973-1016).  deg_map may
    be rows [row0, row0 + H) of a field of true height n_rows (None: no
    rows past the block): a pixel's row is its global row, and rows at or
    past n_rows are not covered."""
    dt = deg_map.dtype
    H, W = deg_map.shape
    yi = torch.arange(H, device=deg_map.device) + row0
    yy = yi.to(dt)[None, :, None]
    xx = torch.arange(W, device=deg_map.device).to(dt)[None, None, :]
    (x_start, x_len, vx0, vx1, _vx2, vx3, vy0, vy1, _vy2, vy3,
     k0, k1, k2, k3) = scalars.T[:14, :, None, None]
    col_ok = (xx >= x_start) & (xx <= x_start + x_len - 1.0)
    y_low = c_int(torch.where(xx < vx3, vy0 + (xx - vx0) * k3,
                              vy3 + (xx - vx3) * k2), up=True)
    y_high = c_int(torch.where(xx < vx1, vy0 + (xx - vx0) * k0,
                               vy1 + (xx - vx1) * k1), up=False)
    inside = col_ok & (yy >= y_low) & (yy <= y_high)
    if n_rows is not None:
        inside = inside & (yi < n_rows)[None, :, None]
    return inside


def rect_counts_reference(deg_map: torch.Tensor, scalars: torch.Tensor,
                          row0: int = 0, n_rows=None):
    """Plain PyTorch version of rect_counts (same contract): the dense
    per-pixel form - the inside and aligned masks, two sums."""
    inside = rect_inside(deg_map, scalars, row0, n_rows)
    deg, prec = scalars.T[14:, :, None, None]
    deg_dif = torch.abs(deg - deg_map)
    deg_dif = torch.where(deg_dif > PI * 1.5, torch.abs(deg_dif - 2 * PI),
                          deg_dif)
    all_pix = inside.sum((1, 2), dtype=torch.int32)
    ali_pix = (inside & (deg_dif < prec)).sum((1, 2), dtype=torch.int32)
    return all_pix, ali_pix


def _kernel(dtype):
    """The ctypes launcher for ``dtype`` (builds csrc/nfa.cu once)."""
    if dtype not in _FN:
        lib = build.load_library("nfa")
        fn = lib.lsd_rect_counts_f32 if dtype == torch.float32 \
            else lib.lsd_rect_counts_f64
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, i, p, p, p]
        fn.restype = ctypes.c_int
        _FN[dtype] = fn
    return _FN[dtype]


def _check(deg_map, scalars):
    dt = deg_map.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rect_counts takes float32/float64, got {dt}")
    if deg_map.dim() != 2:
        raise ValueError(f"deg_map must be (H, W), got {tuple(deg_map.shape)}")
    if scalars.dim() != 2 or scalars.shape[1] != N_SCALARS:
        raise ValueError(f"scalars must be (R, {N_SCALARS}), got "
                         f"{tuple(scalars.shape)}")
    if scalars.dtype != dt:
        raise TypeError(f"scalars are {scalars.dtype}, deg_map is {dt}")
    if scalars.device != deg_map.device:
        raise ValueError(f"scalars on {scalars.device}, deg_map on "
                         f"{deg_map.device}")
    if not (deg_map.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("rect_counts inputs must be contiguous")


def rect_counts(deg_map: torch.Tensor, scalars: torch.Tensor, row0: int = 0,
                n_rows=None):
    """(all_pix, ali_pix), each (R,) int32, for a batch of rectangles.

    deg_map: (H, W) level-line field, or rows [row0, row0 + H) of a field
    of true height n_rows (a row-block-sharded rank's block; the counts
    are then the block's, rows at or past n_rows excluded; n_rows None:
    no rows past the block); scalars: (R, N_SCALARS) packed rectangle
    geometry in deg_map's dtype, on its device."""
    _check(deg_map, scalars)
    if deg_map.device.type == "cpu":
        return rect_counts_reference(deg_map, scalars, row0, n_rows)
    if deg_map.device.type != "cuda":
        raise ValueError(f"no kernel for device {deg_map.device}")
    R = scalars.shape[0]
    H, W = deg_map.shape
    all_pix = torch.empty(R, dtype=torch.int32, device=deg_map.device)
    ali_pix = torch.empty_like(all_pix)
    if R == 0:
        return all_pix, ali_pix
    err = _kernel(deg_map.dtype)(
        deg_map.data_ptr(), H, W, int(row0),
        int(row0) + H if n_rows is None else int(n_rows), scalars.data_ptr(),
        R, all_pix.data_ptr(), ali_pix.data_ptr(),
        torch.cuda.current_stream(deg_map.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rect_counts kernel launch failed: CUDA error "
                           f"{err}")
    rect_counts.launches += 1
    return all_pix, ali_pix


rect_counts.launches = 0
