"""Degree trigonometry, line-info construction and masked compaction on
tensors (counterpart of lsdtpu/geometry.py).

Line sets are (N, 10) float tensors in structLinesInfo field order
[k, b, dx, dy, x1, y1, x2, y2, len, orient] (reference:
LSD/baseFunc.h:33-44) with a boolean validity mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi

# structLinesInfo field indices
K, B, DX, DY, X1, Y1, X2, Y2, LEN, ORIENT = range(10)


def sqrt(x):
    """IEEE correctly rounded square root on every device.

    The card's sqrt is correctly rounded; the CPU build of torch's is
    not (1 ulp off on ~0.6% of random f64 inputs with torch 2.13), and
    the reference's bit-exact tiers (the distance field, the HMM gate,
    C-rounding boundaries) need the correctly rounded value.  On a CPU
    tensor numpy's sqrt, which is correctly rounded, computes it."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy(force=True))))
    return torch.sqrt(x)


def sind(x):
    """Degree sine (reference: baseFunc.cpp:6-8; same op order)."""
    return torch.sin(x / 180.0 * PI)


def cosd(x):
    return torch.cos(x / 180.0 * PI)


def atand(x):
    return torch.atan(x) * 180.0 / PI


def c_round(v):
    """C round(): half away from zero (torch.round is half-to-even)."""
    return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))


def lines_info_from_endpoints(x1, y1, x2, y2):
    """Build (..., 10) linesInfo rows from endpoint tensors
    (reference: LSD/myLSD.cpp:280-368 tail, LSD/myRDP.cpp:86-176).
    Division by zero follows IEEE (vertical lines get k=+-inf)."""
    k = (y2 - y1) / (x2 - x1)
    ang = atand(k)
    neg = ang < 0
    ang = torch.where(neg, ang + 180.0, ang)
    orient = torch.where(neg, -1.0, 1.0).to(x1.dtype)
    b = (y1 + y2) / 2.0 - k * (x1 + x2) / 2.0
    length = sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    return torch.stack([k, b, cosd(ang), sind(ang), x1, y1, x2, y2,
                        length, orient], dim=-1)


def normalized_line_direction(sx, sy, ex, ey):
    """Line direction in degrees, [-180, 180] (reference: myFA.cpp:274-305).
    The generic branch divides (ey-sy)/(ex-sx), +-inf for vertical lines
    where atand gives +-90; only exact horizontals need explicit cases."""
    dy = ey - sy
    dx = ex - sx
    ang = atand(dy / dx)                       # NaN only if dx==dy==0
    v90 = torch.where(dy > 0, 90.0, -90.0).to(ang.dtype)
    ang = torch.where((dx == 0) & (dy != 0), v90, ang)
    v0 = torch.where(dx > 0, 0.0, 180.0).to(ang.dtype)
    ang = torch.where((dx != 0) & (dy == 0), v0, ang)
    back = sx > ex
    return torch.where((ang < 0) & back, ang + 180.0,
                       torch.where((ang > 0) & back, ang - 180.0, ang))


def wrap_deg(ang):
    """Wrap degrees into (-180, 180] (reference while-loop semantics).
    Floored modulo, as jnp.mod: torch.remainder, not torch.fmod."""
    w = torch.remainder(ang + 180.0, 360.0)
    w = torch.where(w == 0.0, 360.0, w)
    return w - 180.0


def masked_compact(values, mask, out_size: int, fill=0):
    """Stable compaction: rows of ``values`` where ``mask``, in order,
    into a fixed (out_size, ...) buffer.  One cumsum and one scatter; rows
    that are masked out or past out_size go to a dump slot that is cut
    off.  Returns (compacted, out_mask, count): out_mask is a prefix
    mask and count the raw live total (count > out_size flags
    overflow)."""
    m = mask.reshape(-1).to(torch.int64)
    pos = torch.cumsum(m, 0) - 1
    count = m.sum()
    slot = torch.where((m > 0) & (pos < out_size), pos,
                       torch.full_like(pos, out_size))
    out = torch.full((out_size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[slot] = values
    out_mask = torch.arange(out_size, device=values.device) < count
    return out[:out_size], out_mask, count


def masked_compact_rows(values, mask, out_size: int, fill=0):
    """masked_compact over a row-structured grid: values (R, C, ...),
    mask (R, C); the same output as masked_compact of the flattened
    grid.  (The reference package's chunked trip-count scatter is a TPU
    execution strategy; one scatter is enough on the card.)"""
    R, C = mask.shape[:2]
    return masked_compact(values.reshape((R * C,) + tuple(values.shape[2:])),
                          mask.reshape(-1), out_size, fill=fill)
