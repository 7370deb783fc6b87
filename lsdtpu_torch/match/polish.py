"""Sub-pixel pose polish against the mapCache distance field
(counterpart of lsdtpu/match/polish.py).

A capability the reference lacks: its pose measurement is a weighted
mean over endpoint-alignment hypotheses (LSD/myFA.cpp:159-171), so it
is quantized to the discrete (scan endpoint, map endpoint) alignment
grid.  A few damped Gauss-Newton iterations on the fused lidar pose
descend the squared bilinearly interpolated mapCache distance over the
transformed scan pixel cloud; a step is accepted only when it lowers a
CalcScore-style penalized mean (polish_pose).  This is the
likelihood-field scan matcher of Probabilistic Robotics ch. 6.4 /
Hector SLAM.

Geometry: every reference candidate transform "rotate the cloud by
angDiff about the scan base point, translate scan base -> map base"
(myFA.cpp:307-355) is "rotate about the lidar position by angDiff,
translate lidar -> transformed lidar pose", so the fused pose (x, y,
theta) parameterizes the cloud directly:

    p' = R(theta) (p - lidar) + (x, y)

The iterations are a Python loop of tensor ops with no host read; the
accept decision is a torch.where.  The per-pixel sums (cost, normal
equations) add in one fixed order (geometry.tree_sum), the same on the
card and the CPU.

Off by default (``MatchConfig.polish_pose``): parity runs reproduce the
reference's quantized measurement.
"""

from __future__ import annotations

import math

import torch

from lsdtpu_torch import geometry as geo

PI = math.pi


def _bilinear_with_grad(cache_flat, pad_rows, pad_cols, rows, cols, x, y):
    """Bilinear sample + gradient of the distance field at (x, y).

    cache_flat: (..., H * W) flat fields, one per lane; x, y: (..., P);
    rows, cols: numbers, or (..., 1) tensors per lane.  Returns (value,
    d/dx, d/dy, inside).  ``inside`` requires the full 2x2 support in the
    TRUE map extent (rows/cols may be smaller than the padded storage).
    The support test compares the floored floats (integer-valued, so the
    same as the reference package's int32 test on every in-range
    coordinate); a NaN coordinate is outside."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    inside = (x0 >= 0) & (x0 + 1 < cols) & (y0 >= 0) & (y0 + 1 < rows)
    xc = torch.nan_to_num(x0).clamp(0, pad_cols - 2).long()
    yc = torch.nan_to_num(y0).clamp(0, pad_rows - 2).long()
    base = yc * pad_cols + xc

    def at(i):
        return torch.gather(cache_flat, -1, i)

    v00 = at(base)
    v01 = at(base + 1)                      # (x+1, y)
    v10 = at(base + pad_cols)               # (x, y+1)
    v11 = at(base + pad_cols + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    val = top * (1 - fy) + bot * fy
    ddx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    ddy = bot - top
    return val, ddx, ddy, inside


def _solve3(H, g):
    """Solve H d = g for symmetric (..., 3, 3) H via the adjugate; the
    products add in row order (no device matmul)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det,
                          torch.zeros_like(det))
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    Hin = torch.stack([torch.stack([A, B, C], -1), torch.stack([B, D, E], -1),
                       torch.stack([C, E, F], -1)], -2) * inv_det[..., None,
                                                                  None]
    return Hin[..., :, 0] * g[..., 0, None] + Hin[..., :, 1] * \
        g[..., 1, None] + Hin[..., :, 2] * g[..., 2, None]


def polish_pose(pose, lidar_pose, pixels, pixels_mask, cache,
                rows=None, cols=None, iters: int = 4,
                max_step_px: float = 1.5, max_step_deg: float = 1.0,
                max_total_px: float = 4.0, damping: float = 1e-2,
                off_field_penalty: float = 10.0):
    """Gauss-Newton polish of a lidar pose against the distance field.

    pose: (3,) (x, y, theta_deg) in map pixel coords (the fused
    measurement); lidar_pose: (2,) scan-local lidar position; pixels:
    (P, 2) scan-local pixel coords with (P,) mask; cache: (H, W) float
    distance field in meters (bf16 polishes in the pose's dtype on the
    rounded values).  Leading lane axes ``...`` polish each lane on its
    own: pose (B, 3), lidar_pose (B, 2), pixels (B, P, 2), cache the
    (B, H, W) canvas, rows/cols (B,) true map extents.

    The GN step descends the sum of squared field distances; a step is
    accepted only if it lowers the CalcScore-style penalized mean

        (sum_inside D + off_field_penalty * n_off) / n_masked

    so pushing badly-fitting pixels off the map (which the reference
    scorer penalizes, myFA.cpp:381-389) never looks like progress.
    Per-iteration steps are trust-region clipped and the total
    displacement is capped at ``max_total_px`` (the HMM acceptance
    basin, myFA.cpp:330).  Returns (polished_pose, cost_before,
    cost_after); a pose with no in-field support (or NaN) is returned
    unchanged."""
    if not cache.dtype.is_floating_point:
        raise ValueError(
            "polish_pose needs a float distance field; integer fixed-point "
            "caches (match.cache_dtype='u16'/'u8') carry no scale here - "
            "use f32 or bf16 with the polish")
    lanes = tuple(pose.shape[:-1])
    pad_rows, pad_cols = cache.shape[-2:]
    rows = pad_rows if rows is None else geo.per_lane(rows, 1)
    cols = pad_cols if cols is None else geo.per_lane(cols, 1)
    dt = pose.dtype
    dev = pose.device
    cache_flat = cache.reshape(lanes + (-1,)).to(dt)
    dxp = pixels[..., 0].to(dt) - lidar_pose[..., 0, None]
    dyp = pixels[..., 1].to(dt) - lidar_pose[..., 1, None]
    rad = torch.tensor(PI / 180.0, dtype=dt, device=dev)
    n_masked = pixels_mask.sum(-1).to(dt).clamp(min=1.0)

    def cost_and_normal(p):
        th = p[..., 2, None] * rad
        c = torch.cos(th)
        s = torch.sin(th)
        tx = c * dxp - s * dyp + p[..., 0, None]
        ty = s * dxp + c * dyp + p[..., 1, None]
        v, gx, gy, inside = _bilinear_with_grad(
            cache_flat, pad_rows, pad_cols, rows, cols, tx, ty)
        w = (inside & pixels_mask).to(dt)
        # d p'/d theta (radians)
        jth = gx * (-s * dxp - c * dyp) + gy * (c * dxp - s * dyp)
        J = torch.stack([gx, gy, jth], -2) * w[..., None, :]    # (..., 3, P)
        r = v * w
        sums = geo.tree_sum(torch.cat([
            torch.stack([v * w, w], -2),
            (J[..., :, None, :] * J[..., None, :, :])
            .reshape(lanes + (9, -1)), J * r[..., None, :]], -2),
            lead=len(lanes) + 1)
        n = sums[..., 1]
        # CalcScore-style penalized mean: off-field pixels cost the cap
        # penalty so a step can't "improve" by shoving pixels off-map
        cost = (sums[..., 0] + off_field_penalty * (n_masked - n)) / n_masked
        return (cost, sums[..., 2:11].reshape(lanes + (3, 3)),
                sums[..., 11:14], n)

    cost0, H, g, n0 = cost_and_normal(pose)
    ok = (n0 > 0) & torch.isfinite(pose).all(-1)
    best_pose = geo.lane_where(ok, pose, torch.zeros_like(pose))
    best_cost = torch.where(ok, cost0, torch.inf)
    eye = torch.eye(3, dtype=dt, device=dev)
    lo, hi = -max_step_deg * rad, max_step_deg * rad
    for _ in range(iters):
        # H/g belong to best_pose, so each iteration evaluates the field
        # exactly once (at the trial pose)
        lam = damping * (H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]) / 3.0 \
            + 1e-12
        delta = -_solve3(H + lam[..., None, None] * eye, g)
        # trust region: clip translation and rotation per iteration
        tn = geo.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2)
        tscale = torch.clamp(max_step_px / tn.clamp(min=1e-12), max=1.0)
        dth = torch.minimum(torch.maximum(delta[..., 2], lo), hi)
        cand = best_pose + torch.stack(
            [delta[..., 0] * tscale, delta[..., 1] * tscale, dth / rad], -1)
        # total displacement guard (stay inside the HMM basin)
        disp = geo.sqrt((cand[..., 0] - pose[..., 0]) ** 2
                        + (cand[..., 1] - pose[..., 1]) ** 2)
        new_cost, Hn, gn, new_n = cost_and_normal(cand)
        accept = (new_cost < best_cost) & (disp <= max_total_px) & \
            (new_n > 0) & torch.isfinite(cand).all(-1)
        best_pose = geo.lane_where(accept, cand, best_pose)
        best_cost = torch.where(accept, new_cost, best_cost)
        H = geo.lane_where(accept, Hn, H)
        g = geo.lane_where(accept, gn, g)
    return (geo.lane_where(ok, best_pose, pose), cost0,
            torch.where(ok, best_cost, cost0))
