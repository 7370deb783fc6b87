"""Level-line gradient field: one shifted-difference pass on tensors
(counterpart of lsdtpu/mapprep/gradient.py).

Reference: myLineSegmentDetector prologue, LSD/myLSD.cpp:145-174.
Row 0 and column 0 stay zero (the reference never writes them); pixels
below gradThre = 2/sin(degThre) are pre-banned in the used map.
"""

from __future__ import annotations

import math

import torch

from lsdtpu_torch import geometry as geo

PI = math.pi


def gradient_core(gauss: torch.Tensor):
    """Shifted-difference magnitude and level-line angle: row/col i of
    the output corresponds to input rows/cols (i, i+1)."""
    a = gauss[1:, 1:]
    b = gauss[1:, :-1]
    c = gauss[:-1, 1:]
    d = gauss[:-1, :-1]
    gx = (b + d - a - c) / 2.0
    gy = (c + d - a - b) / 2.0
    m = geo.sqrt(gx * gx + gy * gy)
    v = geo.atan2(gx, -gy)
    v = torch.where(torch.abs(v - PI) < 1e-6, 0.0, v)
    return m, v


def gradient_field(gauss: torch.Tensor, deg_thre: float):
    """Returns (mag, deg, banned, max_grad): banned is the bool pre-ban
    mask; max_grad a 0-d tensor on the field's device (not read on the
    host here)."""
    m, v = gradient_core(gauss)
    grad_thre = 2.0 / math.sin(deg_thre)
    mag = torch.zeros_like(gauss)
    mag[1:, 1:] = m
    deg = torch.zeros_like(gauss)
    deg[1:, 1:] = v
    banned = torch.zeros(gauss.shape, dtype=torch.bool, device=gauss.device)
    banned[1:, 1:] = m < grad_thre
    # row/col 0 are not seeds either: mag there is 0 -> bin 0 (skipped)
    return mag, deg, banned, m.max()
