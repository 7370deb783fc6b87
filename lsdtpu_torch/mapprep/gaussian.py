"""Gaussian downsampler as two gather passes on tensors (counterpart of
lsdtpu/mapprep/gaussian.py).

Reference: GaussianSampler, LSD/myLSD.cpp:378-484.  The reflected window
indices of every output column (row) are a precomputed (new, hSize)
table built with numpy on the host, and each pass sums the hSize taps
over gathered whole columns (rows):

    aux[y, x']  = sum_i img[y, jx[x', i]] * kx[x', i]
    out[y', x'] = sum_i aux[jy[y', i], x'] * ky[y', i]

The taps are summed SEQUENTIALLY in ascending i, each product and each
sum a separate elementwise op.  PyTorch contracts nothing into an FMA
across ops, so the blur equals the reference's scalar loop
(myLSD.cpp:428-433) bit for bit, on the CPU and on the card.  The three
phase-shifted kernels (the V1.1 x%3 trick, myLSD.cpp:398-417) are built
as the reference builds them: glibc exp per tap and a sequential tap
sum for the normalisation (myLSD.cpp:404-411).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def kernel_bank(sca: float, sig: float):
    """The 3 phase-shifted normalized kernels; returns (ker (3, hSize)
    float64, h)."""
    prec = 3
    if sca < 1:
        sig = sig / sca
    h = int(math.ceil(sig * math.sqrt(2 * prec * math.log(10))))
    h_size = 1 + 2 * h
    k = np.arange(h_size, dtype=np.float64)
    args = (-0.5 * ((k - h) / sig) ** 2,
            -0.5 * ((k - h - 1.0 / 3) / sig) ** 2,
            -0.5 * ((k - h + 1.0 / 3) / sig) ** 2)
    ker = np.empty((3, h_size), np.float64)
    for r in range(3):
        # math.exp is glibc's exp, the reference's; np.exp differs at
        # the last ulp on some taps
        ker[r] = [math.exp(a) for a in args[r].tolist()]
        s = 0.0
        for v in ker[r].tolist():    # one rounded add per tap
            s += v
        ker[r] /= s
    return ker, h


def _reflect_indices(centers: np.ndarray, h: int, lim: int) -> np.ndarray:
    """Symmetric reflection over the doubled domain (myLSD.cpp:434-444)."""
    idx = centers[:, None] + (np.arange(2 * h + 1)[None, :] - h)
    dou = 2 * lim
    idx = np.mod(idx, dou)
    return np.where(idx >= lim, dou - idx - 1, idx)


def gaussian_sampler(image: torch.Tensor, sca: float = 0.3,
                     sig: float = 0.6) -> torch.Tensor:
    """image: (row, col) float tensor; returns the (floor(row*sca),
    floor(col*sca)) blurred subsample in the image's dtype, on its
    device."""
    y_lim, x_lim = image.shape
    new_x = int(math.floor(x_lim * sca))
    new_y = int(math.floor(y_lim * sca))
    ker, h = kernel_bank(sca, sig)
    dev, dt = image.device, image.dtype

    def table(n, lim):
        c = np.floor(np.arange(n) / sca + 0.5).astype(np.int64)
        j = torch.from_numpy(_reflect_indices(c, h, lim)).to(dev)
        k = torch.from_numpy(ker[np.arange(n) % 3]).to(dev, dt)
        return j, k

    jx, kx = table(new_x, x_lim)
    jy, ky = table(new_y, y_lim)
    return tap_sum_rows(tap_sum_cols(image, jx, kx), jy, ky)


def tap_sum_cols(img, jx, kx):
    """x-pass: aux[y, x'] = sum_i img[y, jx[x', i]] * kx[x', i], taps
    accumulated in ascending i."""
    aux = img[:, jx[:, 0]] * kx[:, 0]
    for i in range(1, jx.shape[1]):
        aux = aux + img[:, jx[:, i]] * kx[:, i]
    return aux


def tap_sum_rows(aux, jy, ky):
    """y-pass: out[y', x] = sum_i aux[jy[y', i], x] * ky[y', i], taps
    accumulated in ascending i."""
    out = aux[jy[:, 0], :] * ky[:, 0:1]
    for i in range(1, jy.shape[1]):
        out = out + aux[jy[:, i], :] * ky[:, i:i + 1]
    return out
