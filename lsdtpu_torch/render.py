"""Line-image rasterization: the reference's lineIm outputs (counterpart
of lsdtpu/render.py).

The reference emits a rasterized image beside every line set
(structLSD.lineIm, myLSD.cpp:296-357; structFeatureScan.lineIm,
myRDP.cpp:96-161), used for display and by the legacy matcher.  The
per-line pixel sets are evaluated on a fixed (line, step) grid
(major-axis stepping with C rounding, the closed form of
scan/featurize.py) and only the marked pixels are scattered into the
image.  Plain PyTorch: no kernel stands behind it.

Quirks kept: out-of-bounds samples collapse to the (0, 0) sentinel and
any sample on row 0 or column 0 is dropped (myLSD.cpp:325-355).
"""

from __future__ import annotations

from typing import Optional

import torch

from lsdtpu_torch import geometry as geo


def render_line_image(lines, lines_mask, rows: int, cols: int,
                      max_steps: Optional[int] = None) -> torch.Tensor:
    """lines: (L, 10) structLinesInfo rows, lines_mask: (L,) bool; returns
    the (rows, cols) uint8 image with line pixels set to 255, on the
    lines' device.

    max_steps defaults to the longest possible major-axis run on this
    canvas (max(rows, cols) + 2), so no in-bounds line is ever truncated;
    pass a smaller cap only when the lines are known short."""
    if max_steps is None:
        max_steps = max(rows, cols) + 2
    x1 = lines[:, geo.X1, None]
    y1 = lines[:, geo.Y1, None]
    x2 = lines[:, geo.X2, None]
    y2 = lines[:, geo.Y2, None]
    k = lines[:, geo.K, None]

    x_low = torch.floor(torch.minimum(x1, x2))
    x_high = torch.ceil(torch.maximum(x1, x2))
    y_low = torch.floor(torch.minimum(y1, y2))
    y_high = torch.ceil(torch.maximum(y1, y2))
    x_major = torch.abs(x2 - x1) > torch.abs(y2 - y1)

    t = torch.arange(max_steps, device=lines.device).to(lines.dtype)[None, :]
    xxa = x_low + t
    yya = geo.c_round((xxa - x1) * k + y1)
    yyb = y_low + t
    xxb = geo.c_round((yyb - y1) / k + x1)
    xx = torch.where(x_major, xxa, xxb)
    yy = torch.where(x_major, yya, yyb)
    n_steps = torch.where(x_major, x_high - x_low, y_high - y_low) + 1.0

    oob = (xx < 0) | (xx >= cols) | (yy < 0) | (yy >= rows)
    xx = torch.where(oob, 0.0, xx)
    yy = torch.where(oob, 0.0, yy)
    mark = (t < n_steps) & (xx != 0) & (yy != 0) & lines_mask[:, None]

    # a degenerate line (k = 0/0) samples NaN columns, which pass every
    # test above; the reference package's float -> int conversion (XLA's)
    # takes NaN to 0, so they mark column 0
    img = torch.zeros(rows * cols, dtype=torch.uint8, device=lines.device)
    iy, ix = (torch.nan_to_num(v[mark], nan=0.0).to(torch.int64)
              for v in (yy, xx))
    img[iy * cols + ix] = 255
    return img.reshape(rows, cols)
