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
import torch.nn.functional as F

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


def atan2(y, x):
    """atan2 whose value depends on its inputs only, on every device.

    The CPU build of torch's atan2 gives another ulp for the same input
    in the tail of a vectorized loop than in its body (torch 2.13), so a
    block of a field and the whole field would differ; the card's is
    elementwise.  On CPU tensors numpy's atan2 computes it."""
    if y.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.arctan2(y.numpy(force=True),
                                                      x.numpy(force=True))))
    return torch.atan2(y, x)


def tree_sum(rows, lead: int = 1):
    """Sums of ``rows`` over all axes after its first ``lead`` ones (for
    lead = 1: each row of a (k, ...) tensor; for lead = 2: each row of
    each lane of a (B, k, ...) tensor), in one fixed order on every
    device and for every row: zero-padded to a power of two, then halved
    by elementwise adds, each rounded once.  torch's own sum adds in a
    device-specific order; where the card must give the CPU's result bit
    for bit (a rectangle edge on a pixel centre, a score tie), sums go
    through this."""
    keep = tuple(rows.shape[:lead])
    x = rows.reshape(keep + (-1,))
    n = x.shape[-1]
    x = F.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def per_lane(x, trailing: int):
    """A per-lane (B,) tensor as (B, 1, ..., 1) with ``trailing`` unit
    axes, to broadcast against (B, ...) tensors; a Python number or a
    0-d tensor (one lane) passes through."""
    if torch.is_tensor(x) and x.dim() > 0:
        return x.reshape(tuple(x.shape) + (1,) * trailing)
    return x


def lane_where(cond, a, b):
    """torch.where with a per-lane condition ((...) bool: none or (B,))
    broadcast over the trailing axes of a and b (tensors or numbers):
    cond selects whole rows of each lane."""
    nd = max(t.dim() for t in (a, b) if torch.is_tensor(t))
    return torch.where(cond.reshape(tuple(cond.shape)
                                    + (1,) * (nd - cond.dim())), a, b)


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
    """Stable compaction along the last axis of ``mask``: for each lane
    (the leading axes of mask, none for a single lane), the entries of
    ``values`` where ``mask``, in order, into a fixed (..., out_size, ...)
    buffer.  mask: (*lanes, L); values: (*lanes, L, *features).  One
    cumsum along the last axis and one scatter into a buffer with one
    dump slot per lane; entries that are masked out or past out_size go
    to their lane's dump slot, which is cut off.  Returns (compacted,
    out_mask, count): out_mask is a prefix mask and count each lane's raw
    live total (count > out_size flags overflow)."""
    lanes = tuple(mask.shape[:-1])
    L = mask.shape[-1]
    feat = tuple(values.shape[len(lanes) + 1:])
    nl = 1
    for d in lanes:
        nl *= d
    m = mask.reshape(nl, L).to(torch.int64)
    pos = torch.cumsum(m, -1) - 1
    count = m.sum(-1)
    slot = torch.where((m > 0) & (pos < out_size), pos,
                       torch.full_like(pos, out_size))
    slot = slot + (out_size + 1) * torch.arange(
        nl, device=values.device)[:, None]
    out = torch.full((nl * (out_size + 1),) + feat, fill,
                     dtype=values.dtype, device=values.device)
    out[slot.reshape(-1)] = values.reshape((nl * L,) + feat)
    out = out.reshape((nl, out_size + 1) + feat)[:, :out_size]
    out_mask = torch.arange(out_size, device=values.device) < count[:, None]
    return (out.reshape(lanes + (out_size,) + feat),
            out_mask.reshape(lanes + (out_size,)), count.reshape(lanes))


def masked_compact_rows(values, mask, out_size: int, fill=0):
    """masked_compact over a row-structured grid of each lane: values
    (*lanes, R, C, ...), mask (*lanes, R, C); the same output as
    masked_compact of the flattened grid.  (The reference package's
    chunked trip-count scatter is a TPU execution strategy; one scatter
    is enough on the card.)"""
    lanes = tuple(mask.shape[:-2])
    R, C = mask.shape[-2:]
    feat = tuple(values.shape[len(lanes) + 2:])
    return masked_compact(values.reshape(lanes + (R * C,) + feat),
                          mask.reshape(lanes + (R * C,)), out_size, fill=fill)
