"""Batch pose-graph refinement over a localized trajectory (counterpart of
lsdtpu/refine/pose_graph.py; plain PyTorch, no kernel stands behind it).

The online loop is causal - each pose sees only past scans; offline, the
whole trajectory can be re-estimated jointly:

    min_x  sum_t w_t ||x_t - m_t||^2                (FA measurements)
         + sum_t ||x_{t+1} - x_t - u_t||_Wu^2       (odometry chain)

with m_t the per-frame feature-association measurement (weight
w_t = 1/score_t^2, the reference's own confidence weighting,
myFA.cpp:159-171; frames with lost tracking get w_t = 0 and are bridged
by odometry), and u_t the rotated odometry delta the main loop feeds the
filter.  Both residuals are linear in x (u_t is already in map
coordinates), so the normal system is a symmetric block-tridiagonal
(3x3 blocks) matrix solved exactly in one pass: a block Thomas forward
elimination and back substitution, each a loop over the chain on the
device.  This is the Schur-complement elimination of a chain graph:
each forward step marginalizes one pose.  The segment-parallel solve
cuts the chain into segments whose interiors condense in one batched
call onto the segment-boundary poses, solves the small separator chain,
and back-substitutes the interiors in one batched call.

Angles are unwrapped before solving (the chain is linear, so branch cuts
would otherwise tear it) and all weights are per-frame arrays so callers
can reweight or freeze poses.  The 3x3 solves go through
``torch.linalg.solve_ex`` without its error check, which would read
``info`` on the host after every solve on the card.
"""

from __future__ import annotations

import torch

from lsdtpu_torch import resolve_device


def _wrap_deg(a):
    """Angles wrapped to [-180, 180) degrees (floor-mod: ``%`` on a
    tensor is torch.remainder, which takes the divisor's sign)."""
    return (a + 180.0) % 360.0 - 180.0


def _solve(A, B):
    """A^-1 B for (..., 3, 3) A, without a host read."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _tensors(meas, scores, scan_pose, device):
    """The inputs as tensors of the measurements' dtype on the device."""
    dev = resolve_device(device)
    meas = torch.as_tensor(meas, device=dev)
    dt = meas.dtype
    return (meas, torch.as_tensor(scores, device=dev).to(dt),
            torch.as_tensor(scan_pose, device=dev).to(dt))


def _normal_system(meas, scores, scan_pose, odom_weight, max_meas_weight):
    """The block-tridiagonal normal system (D (F, 3, 3), U (3, 3), rhs
    (F, 3)) plus the measurement mask and weights."""
    F = meas.shape[0]
    dt = meas.dtype
    dev = meas.device

    ok = torch.isfinite(scores) & torch.isfinite(meas).all(1)
    w_meas = torch.where(ok, torch.clamp(1.0 / (scores * scores),
                                         max=max_meas_weight), 0.0)

    # unwrap measurement angles along the trajectory so the linear chain
    # never spans a branch cut.  Lost frames (NaN meas) are forward-filled
    # with the last measured angle first: the diffs through a gap then
    # telescope to wrap(next - prev), so a gap straddling +-180 does not
    # tear, and a lost frame 0 cannot poison the cumsum with NaN (a
    # leading gap backfills from the first measured frame)
    idx = torch.arange(F, device=dev)
    last_ok = torch.cummax(torch.where(ok, idx, -1), 0).values
    first_ok = torch.where(ok, idx, F).min()
    src = torch.where(last_ok >= 0, last_ok.clamp(min=0),
                      first_ok.clamp(0, F - 1))
    any_ok = ok.any()
    ang = torch.where(any_ok, meas[src.clamp(0, F - 1), 2], 0.0)
    dang = _wrap_deg(torch.diff(ang))
    ang_unwrapped = torch.cat([ang[:1], ang[0] + torch.cumsum(dang, 0)])
    m = torch.cat([meas[:, :2], torch.where(ok, ang_unwrapped, 0.0)[:, None]],
                  1)
    m = torch.where(ok[:, None], m, 0.0)

    Wu = torch.as_tensor(odom_weight, dtype=dt, device=dev)   # (3,) diagonal

    # D_t = w_t I + Wu * ([t>0] + [t<F-1]);  U = -diag(Wu)
    I3 = torch.eye(3, dtype=dt, device=dev)
    has_prev = (idx > 0).to(dt)
    has_next = (idx < F - 1).to(dt)
    D = (w_meas[:, None, None] * I3 +
         (has_prev + has_next)[:, None, None] * torch.diag(Wu))
    # with NO measured frame the system is the anchorless chain Laplacian
    # (singular: the last Schur block is exactly 0) and the solve would
    # give NaN for every pose; anchor pose 0 at the origin then - the
    # result is pure odometry dead-reckoning, and info["n_measured"] == 0
    # tells callers so
    D = torch.cat([(D[0] + torch.where(any_ok, 0.0, 1.0) * I3)[None], D[1:]])
    U = -torch.diag(Wu)

    # rhs: w m_t + Wu u_t (pair t-1,t) - Wu u_{t+1} (pair t,t+1)
    u = scan_pose
    u_next = torch.cat([u[1:], torch.zeros((1, 3), dtype=dt, device=dev)])
    rhs = (w_meas[:, None] * m +
           has_prev[:, None] * (Wu * u) -
           has_next[:, None] * (Wu * u_next))
    return D, U, rhs, ok, w_meas


def _info(ok, w_meas):
    n = ok.sum()
    return {"n_measured": n, "mean_weight": w_meas.sum() / n.clamp(min=1)}


def refine_trajectory(meas, scores, scan_pose, odom_weight=(4.0, 4.0, 4.0),
                      max_meas_weight: float = 100.0, device="cuda"):
    """meas: (F, 3) FA measurements [x_px, y_px, ang_deg] (NaN where
    tracking was lost); scores: (F,); scan_pose: (F, 3) odometry deltas
    in map pixel coords (frame t's delta from t-1).  numpy arrays or
    tensors; the solve runs in the measurements' dtype on ``device``.
    Returns (refined (F, 3) tensor, info dict of 0-d tensors:
    n_measured, mean_weight)."""
    meas, scores, scan_pose = _tensors(meas, scores, scan_pose, device)
    D, U, rhs, ok, w_meas = _normal_system(meas, scores, scan_pose,
                                           odom_weight, max_meas_weight)
    # one shared block-Thomas solve (U is symmetric, so the multi-rhs form
    # is the hand-rolled elimination)
    xs = _thomas_multi(D, U, rhs[:, :, None])[:, :, 0]
    refined = torch.cat([xs[:, :2], _wrap_deg(xs[:, 2:])], 1)
    return refined, _info(ok, w_meas)


def _thomas_multi(D, U, R):
    """Block-Thomas solve of chain systems with diagonal blocks D
    (..., L, 3, 3), a constant symmetric off-diagonal block U (3, 3) and
    multi-column right-hand sides R (..., L, 3, k); the leading axes
    ``...`` are independent systems, solved in the same calls.  Returns
    X (..., L, 3, k)."""
    L = D.shape[-3]
    S, Y = [D[..., 0, :, :]], [R[..., 0, :, :]]
    for t in range(1, L):
        k = Y[-1].shape[-1]
        Z = _solve(S[-1], torch.cat([U.expand(S[-1].shape), Y[-1]], -1))
        S.append(D[..., t, :, :] - U @ Z[..., :3])
        Y.append(R[..., t, :, :] - U @ Z[..., 3:3 + k])
    X = [_solve(S[-1], Y[-1])]
    for t in range(L - 2, -1, -1):
        X.append(_solve(S[t], Y[t] - U @ X[-1]))
    return torch.stack(X[::-1], -3)


def _thomas_var(D, Uu, R):
    """Block-Thomas with per-edge off-diagonal blocks Uu (L-1, 3, 3)
    (Uu[t] couples t and t+1, symmetric system) and rhs R (L, 3).
    Returns X (L, 3)."""
    L = D.shape[0]
    S, y = [D[0]], [R[0]]
    for t in range(1, L):
        Ut = Uu[t - 1]                     # couples t-1 and t
        Z = _solve(S[-1], torch.cat([Ut, y[-1][:, None]], 1))
        S.append(D[t] - Ut.mT @ Z[:, :3])
        y.append(R[t] - Ut.mT @ Z[:, 3])
    X = [_solve(S[-1], y[-1][:, None])[:, 0]]
    for t in range(L - 2, -1, -1):
        X.append(_solve(S[t], (y[t] - Uu[t] @ X[-1])[:, None])[:, 0])
    return torch.stack(X[::-1])


def refine_trajectory_distributed(meas, scores, scan_pose,
                                  n_segments: int = 8,
                                  odom_weight=(4.0, 4.0, 4.0),
                                  max_meas_weight: float = 100.0,
                                  device="cuda"):
    """Segment-parallel exact solve of the same normal system.

    The F-pose chain is cut into ``n_segments`` segments whose interiors
    condense - all segments in one batched solve - onto the
    segment-boundary poses; the small separator chain (n_segments 3x3
    blocks) is solved sequentially; the interiors back-substitute in one
    batched solve.  The result is refine_trajectory's up to solver
    rounding.  Needs F divisible by n_segments with segments of length
    >= 2 (ValueError otherwise); callers pad with zero-weight frames."""
    meas, scores, scan_pose = _tensors(meas, scores, scan_pose, device)
    F = meas.shape[0]
    P = n_segments
    if P < 1 or F % P or F // P < 2:
        raise ValueError(f"refine_trajectory_distributed needs F % "
                         f"n_segments == 0 and F // n_segments >= 2 (F={F}, "
                         f"n_segments={P}); pad with zero-weight frames")
    L = F // P
    dt = meas.dtype
    dev = meas.device

    D, U, rhs, ok, w_meas = _normal_system(meas, scores, scan_pose,
                                           odom_weight, max_meas_weight)

    # segment s owns poses [sL, (s+1)L); separator s = pose sL+L-1
    D_int = D.reshape(P, L, 3, 3)[:, :L - 1]        # interiors (P, L-1, 3, 3)
    r_int = rhs.reshape(P, L, 3)[:, :L - 1]
    I3 = torch.eye(3, dtype=dt, device=dev)
    has_left = torch.arange(P, device=dev) > 0

    # condense every segment at once, multi-rhs [b_I | E_left | E_right]
    R = torch.zeros((P, L - 1, 3, 7), dtype=dt, device=dev)
    R[:, :, :, 0] = r_int
    R[:, 0, :, 1:4] = torch.where(has_left[:, None, None], I3, 0.0)
    R[:, L - 2, :, 4:7] = I3
    X = _thomas_multi(D_int, U, R)
    zb = X[..., 0]                                  # T^-1 b_I
    Ga = X[..., 1:4]                                # T^-1 E_left columns
    Gb = X[..., 4:7]                                # T^-1 E_right columns
    # couplings: left separator <-> first interior, right separator <->
    # last interior, both with block U
    C_aa = -U @ Ga[:, 0] @ U                        # onto (left, left)
    C_ab = -U @ Gb[:, 0] @ U                        # (left, right)
    C_bb = -U @ Gb[:, L - 2] @ U                    # (right, right)
    y_a = (-U @ zb[:, 0, :, None])[..., 0]
    y_b = (-U @ zb[:, L - 2, :, None])[..., 0]

    # separator chain over the P poses sL+L-1: segment s+1 contributes
    # C_aa to separator s and C_ab as the (s, s+1) coupling
    sep_idx = torch.arange(P, device=dev) * L + (L - 1)
    S_diag = D[sep_idx] + C_bb
    S_diag = torch.cat([S_diag[:P - 1] + C_aa[1:], S_diag[P - 1:]])
    r_sep = rhs[sep_idx] + y_b
    r_sep = torch.cat([r_sep[:P - 1] + y_a[1:], r_sep[P - 1:]])
    x_sep = _thomas_var(S_diag, C_ab[1:], r_sep)     # (P, 3)

    # every interior back-substitutes at once, with Dirichlet boundaries
    x_left = torch.cat([torch.zeros((1, 3), dtype=dt, device=dev),
                        x_sep[:-1]])
    r = r_int.clone()
    r[:, 0] += -torch.where(has_left[:, None],
                            (U @ x_left[:, :, None])[..., 0], 0.0)
    r[:, L - 2] += -(U @ x_sep[:, :, None])[..., 0]
    x_int = _thomas_multi(D_int, U, r[..., None])[..., 0]

    xs = torch.cat([x_int, x_sep[:, None, :]], 1).reshape(F, 3)
    refined = torch.cat([xs[:, :2], _wrap_deg(xs[:, 2:])], 1)
    return refined, _info(ok, w_meas)
