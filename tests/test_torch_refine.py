"""Pose-graph refinement: lsdtpu_torch.refine.pose_graph against
lsdtpu.refine.pose_graph on the same seeded f64 chains (CPU).

Tiers: refined poses within 1e-9 absolute (px and deg) of the JAX
package, n_measured exact; the segment-parallel solve within 1e-9 of
JAX's and within 1e-7 of the port's sequential solve (the reference
package's own tier between its two solvers); a batched block-Thomas
call within 1e-12 of one call per segment."""

import numpy as np
import pytest
import torch

from lsdtpu.refine import pose_graph as jpg
from lsdtpu_torch.refine import pose_graph as tpg
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import contexts, frames, np_

TOL = 1e-9


def _synthetic(F=120, noise=2.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(F)
    truth = np.stack([10 + 2.0 * t, 5 + 1.5 * t, 0.1 * t], axis=1)
    u = np.diff(truth, axis=0, prepend=truth[:1])
    u[0] = 0
    meas = truth + rng.normal(0, noise, (F, 3))
    scores = np.full(F, 0.5)
    return truth, meas, scores, u


def _noisy():
    _, meas, scores, u = _synthetic()
    return meas, scores, u


def _lost_gap():
    _, meas, scores, u = _synthetic(noise=0.5)
    scores[40:60] = np.inf
    meas[40:60] = np.nan
    return meas, scores, u


def _single_measurement():
    truth, meas, scores, u = _synthetic(noise=0.0)
    scores[:] = np.inf
    meas[:] = np.nan
    scores[0] = 0.1
    meas[0] = truth[0]
    return meas, scores, u


def _lost_first_and_wrap_gap():
    _, meas, scores, u = _synthetic(F=60, noise=0.2)
    meas[:, 2] = np.linspace(160, 200, 60)
    meas[:, 2] = ((meas[:, 2] + 180) % 360) - 180
    u[:, 2] = np.diff(np.linspace(160, 200, 60), prepend=160)
    u[0, 2] = 0
    scores[0] = np.inf
    meas[0] = np.nan
    scores[25:35] = np.inf
    meas[25:35] = np.nan
    return meas, scores, u


def _all_lost():
    F = 16
    return (np.full((F, 3), np.nan), np.full((F,), np.inf),
            np.tile(np.array([1.0, 0.5, 0.0]), (F, 1)))


CASES = {"noisy": _noisy, "lost_gap": _lost_gap,
         "single_measurement": _single_measurement,
         "lost_first_wrap_gap": _lost_first_and_wrap_gap,
         "all_lost": _all_lost}


def _angle_close(got, want, tol):
    """Poses equal within tol, the heading compared modulo 360."""
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=tol)
    d = (got[:, 2] - want[:, 2] + 180.0) % 360.0 - 180.0
    assert np.abs(d).max() <= tol, np.abs(d).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_matches_jax(case):
    meas, scores, u = CASES[case]()
    want, winfo = jpg.refine_trajectory(meas, scores, u)
    got, info = tpg.refine_trajectory(meas, scores, u, device="cpu")
    assert got.dtype == torch.float64
    got = np_(got)
    assert np.isfinite(got).all()
    _angle_close(got, np.asarray(want), TOL)
    assert int(info["n_measured"]) == int(winfo["n_measured"])
    np.testing.assert_allclose(float(info["mean_weight"]),
                               float(winfo["mean_weight"]), rtol=1e-12)


def test_refine_behaviour():
    """The reference package's own checks hold for the port: smoothing
    reduces the measurement noise, a lost gap is bridged by odometry, one
    exact measurement with exact odometry rebuilds the chain, and with no
    measured frame pose 0 is anchored and the odometry dead-reckoned."""
    truth, meas, scores, u = _synthetic()
    got = np_(tpg.refine_trajectory(meas, scores, u, device="cpu")[0])
    assert (np.abs(got[:, :2] - truth[:, :2]).mean()
            < 0.6 * np.abs(meas[:, :2] - truth[:, :2]).mean())
    truth, _, _, _ = _synthetic(noise=0.5)
    meas, scores, u = _lost_gap()
    got = np_(tpg.refine_trajectory(meas, scores, u, device="cpu")[0])
    assert np.abs(got[40:60, :2] - truth[40:60, :2]).max() < 2.0
    truth, _, _, _ = _synthetic(noise=0.0)
    meas, scores, u = _single_measurement()
    got = np_(tpg.refine_trajectory(meas, scores, u, device="cpu")[0])
    np.testing.assert_allclose(got[:, :2], truth[:, :2], atol=1e-5)
    meas, scores, u = _all_lost()
    got, info = tpg.refine_trajectory(meas, scores, u, device="cpu")
    assert int(info["n_measured"]) == 0
    want = np.cumsum(u, 0) - u[0]
    np.testing.assert_allclose(np_(got)[:, :2], want[:, :2], atol=1e-6)


def test_wrap_gap_heading_is_smooth():
    meas, scores, u = _lost_first_and_wrap_gap()
    got = np_(tpg.refine_trajectory(meas, scores, u, device="cpu")[0])
    un = np.unwrap(np.deg2rad(got[:, 2]))
    assert np.abs(np.rad2deg(np.diff(un))).max() < 5.0


def test_wrap_deg_is_floor_mod():
    """Negative angles wrap as the reference package's jnp % does (the
    divisor's sign), not as torch.fmod would."""
    a = np.array([-540.0, -181.0, -180.0, -0.5, 0.0, 179.9, 180.0, 725.0])
    got = np_(tpg._wrap_deg(torch.as_tensor(a)))
    np.testing.assert_array_equal(got, np.asarray(jpg._wrap_deg(a)))
    assert got.min() >= -180.0 and got.max() < 180.0


@pytest.mark.parametrize("P", [2, 8, 16])
def test_distributed_matches_jax_and_sequential(P):
    _, meas, scores, u = _synthetic(F=128, noise=1.5, seed=3)
    scores[30:40] = np.inf
    meas[30:40] = np.nan
    want, _ = jpg.refine_trajectory_distributed(meas, scores, u,
                                                n_segments=P)
    got, info = tpg.refine_trajectory_distributed(meas, scores, u,
                                                  n_segments=P, device="cpu")
    got = np_(got)
    _angle_close(got, np.asarray(want), TOL)
    assert int(info["n_measured"]) == 118
    seq = np_(tpg.refine_trajectory(meas, scores, u, device="cpu")[0])
    np.testing.assert_allclose(got, seq, rtol=0, atol=1e-7)


@pytest.mark.parametrize("F,P", [(10, 3), (6, 4), (8, 0)])
def test_distributed_rejects_bad_segment_grid(F, P):
    meas, scores, u = _synthetic(F=F)[1:]
    with pytest.raises(ValueError, match="n_segments"):
        tpg.refine_trajectory_distributed(meas, scores, u, n_segments=P,
                                          device="cpu")


def test_batched_thomas_equals_per_segment_calls():
    rng = np.random.default_rng(7)
    P, L, k = 5, 9, 4
    D = torch.as_tensor(rng.normal(size=(P, L, 3, 3)) * 0.1
                        + 10 * np.eye(3))
    D = D + D.mT
    U = -torch.diag(torch.tensor([4.0, 4.0, 4.0], dtype=torch.float64))
    R = torch.as_tensor(rng.normal(size=(P, L, 3, k)))
    got = tpg._thomas_multi(D, U, R)
    assert got.shape == (P, L, 3, k)
    for s in range(P):
        np.testing.assert_allclose(np_(got[s]),
                                   np_(tpg._thomas_multi(D[s], U, R[s])),
                                   rtol=0, atol=1e-12)


def test_refine_port_rollout_matches_jax():
    """refine_trajectory on the port's f64 rollout of a synthetic
    sequence (the data-bound reference tests' counterpart), then the
    trajectory concatenated four times, segment-parallel vs sequential."""
    _, tctx = contexts(0)
    outs = {k: np_(v) for k, v in tloop.run_sequence(
        frames(0), tctx, device="cpu").items()}
    args = (outs["measurement"], outs["score"], outs["scan_pose"])
    want, winfo = jpg.refine_trajectory(*args)
    got, info = tpg.refine_trajectory(*args, device="cpu")
    got = np_(got)
    assert np.isfinite(got).all()
    _angle_close(got, np.asarray(want), TOL)
    assert int(info["n_measured"]) == int(winfo["n_measured"]) > 0
    assert np.abs(got[2:, :2] - outs["pose"][2:, :2]).max() < 10.0
    cat = tuple(np.concatenate([a] * 4) for a in args)
    seq = np_(tpg.refine_trajectory(*cat, device="cpu")[0])
    seg = np_(tpg.refine_trajectory_distributed(*cat, n_segments=8,
                                                device="cpu")[0])
    np.testing.assert_allclose(seg, seq, rtol=0, atol=1e-6)
    jseg = np.asarray(jpg.refine_trajectory_distributed(*cat,
                                                        n_segments=8)[0])
    _angle_close(seg, jseg, TOL)


def test_default_device_is_the_card():
    meas, scores, u = _noisy()
    if torch.cuda.is_available():
        assert tpg.refine_trajectory(meas, scores, u)[0].is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tpg.refine_trajectory(meas, scores, u)
    with pytest.raises(RuntimeError, match="cuda"):
        tpg.refine_trajectory_distributed(meas, scores, u, n_segments=4)
