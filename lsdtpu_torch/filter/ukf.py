"""9-state constant-acceleration UKF on tensors (counterpart of
lsdtpu/filter/ukf.py).

Reference: LSD/myFA.cpp:404-536.  State [x, y, th, vx, vy, vth, ax, ay,
ath]; measurement = identity on the first three states; odometry is
injected additively into the state before the unscented transform
(myFA.cpp:425-427).  Sigma points via Cholesky with the reference's
A = c * chol(P)^T row convention (myFA.cpp:456-460).

Every function takes leading lane axes ``...`` (none for one filter,
(B,) for a batch of B robots): indexing runs along the trailing axes and
the products are batched matmuls, one filter per lane.

Matmuls run in full precision: on the card a float32 matmul must not
use TF32 (torch.backends.cuda.matmul.allow_tf32 False, PyTorch's
default, which the caller keeps and ukf_step asserts).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lsdtpu_torch import geometry as geo

L = 9
ALPHA = 1e-2
KI = 0.0
BETA = 2.0
DT = 1.0

_Q = np.diag([1, 1, 1, .01, .01, .01, 1e-4, 1e-4, 1e-4])
_R = np.eye(3)

RESET_X = np.array([-1, -1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64)
RESET_P = np.diag([100, 100, 100, 1, 1, 1, 0.1, 0.1, 0.1]).astype(np.float64)


def process_noise() -> np.ndarray:
    """The UKF process-noise matrix Q (myFA.cpp:407-412)."""
    return _Q


def _transition(dt_step: float) -> np.ndarray:
    """Constant-acceleration transition (myFA.cpp:477-487)."""
    F = np.eye(L)
    for i in range(3):
        F[i, i + 3] = dt_step
        F[i + 3, i + 6] = dt_step
        F[i, i + 6] = 0.5 * dt_step * dt_step
    return F


def _cholesky_unrolled(P):
    """Lower Cholesky of small SPD matrices (..., n, n), right-looking
    (outer-product) form unrolled over the n columns, in the reference
    package's op order (the reference uses Eigen llt, myFA.cpp:456-460)."""
    n = P.shape[-1]
    rows = torch.arange(n, device=P.device)
    A = P
    Lm = torch.zeros_like(P)
    for j in range(n):
        d = geo.sqrt(A[..., j, j])
        col = torch.where(rows >= j, A[..., :, j] / d[..., None], 0.0)
        Lm = torch.where(rows[None, :] == j, col[..., :, None], Lm)
        A = A - col[..., :, None] * col[..., None, :]
    return Lm


def _inv3(M):
    """Closed-form inverse (adjugate / det) of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def _mv(M, v):
    """M @ v for (..., m, k) matrices and (..., k) vectors (one lane: the
    plain matrix-vector product)."""
    if v.dim() == 1:
        return M @ v
    return (M @ v[..., None])[..., 0]


def ukf_step(kalman_x, kalman_P, scan_pose, measurement,
             alpha: float = ALPHA, beta: float = BETA, kappa: float = KI,
             dt_step: float = DT):
    """One UKF predict+update: kalman_x (..., 9), kalman_P (..., 9, 9),
    scan_pose (..., 3), measurement (..., 3) tensors on one device.
    alpha/beta/kappa/dt_step mirror FilterConfig (defaults = the
    reference values, myFA.cpp:431-433)."""
    if kalman_x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("ukf_step needs full-precision matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    dt = kalman_x.dtype
    dev = kalman_x.device

    def const(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    Q, R, F = const(_Q), const(_R), const(_transition(dt_step))
    x = torch.cat([kalman_x[..., :3] + scan_pose, kalman_x[..., 3:]], -1)
    lam = alpha * alpha * (L + kappa) - L
    c = L + lam
    # weights in float64, then cast (the reference package's order)
    Wm = np.full(2 * L + 1, 0.5 / c)
    Wc = Wm.copy()
    Wm[0] = lam / c
    Wc[0] = lam / c + (1 - alpha * alpha + beta)
    Wm, Wc = const(Wm), const(Wc)

    A = math.sqrt(c) * _cholesky_unrolled(kalman_P).mT
    Y = x[..., :, None].expand(x.shape + (L,))
    Xset = torch.cat([x[..., :, None], Y + A, Y - A], dim=-1)    # (..., 9, 19)

    Xsig = F @ Xset
    Xmeans = Xsig @ Wm
    Xdiv = Xsig - Xmeans[..., :, None]
    P1 = (Xdiv * Wc) @ Xdiv.mT + Q

    Zmeans = Xmeans[..., :3]
    Zdiv = Xdiv[..., :3, :]
    Pzz = (Zdiv * Wc) @ Zdiv.mT + R
    Pxz = (Xdiv * Wc) @ Zdiv.mT
    K = Pxz @ _inv3(Pzz)
    new_x = Xmeans + _mv(K, measurement - Zmeans)
    new_P = P1 - K @ Pxz.mT
    return new_x, new_P
