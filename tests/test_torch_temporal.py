"""Temporal segments: lsdtpu_torch.runtime.temporal against
lsdtpu.runtime.temporal and the port's sequential rollout, on a 40-frame
synthetic sequence (CPU, f64).

split_frames_temporal equals the JAX package's array for array.  The
segment-parallel rollout (four segments, the lanes of one batched
rollout in this process; two a rank over two spawned gloo ranks) holds
tests/test_temporal.py's documented tolerance of the sequential rollout
(every sequentially tracked frame tracked, position error max < 6 px,
mean < 1 px), the JAX package's segment rollout at the f64 rollout tier
of tests/test_torch_loop.py (poses within 1e-6 px, identical decisions)
and, over two ranks, the one-process result within 1e-9 px (CPU lanes add
their UKF matmuls in another order).  reconcile_temporal equals the JAX
package's within 1e-9."""

import numpy as np
import pytest

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.runtime import loop as jloop
from lsdtpu.runtime import temporal as jtemp
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime import temporal as ttemp

import torch_ranks
from torch_parity import lane_scenes, np_, solo_context

F = 40
S = 4
WARMUP = 6
MAX_ERR_PX = 6.0     # tests/test_temporal.py's documented tolerance
MEAN_ERR_PX = 1.0


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """(frames, port ctx, JAX ctx, artifacts, params, the two-rank group)."""
    dss, arts = lane_scenes(((1, 200, 260, F),))
    ds, art = dss[0], arts[0]
    p = ds.param
    fr = tloop.stack_frames(ds, dtype=np.float64)
    group = torch_ranks.Group(
        tmp_path_factory.mktemp("ranks"), 2,
        [("temporal", dict(frames=fr, ctx=(*art, p.resol, p.ori_x, p.ori_y),
                           warmup=WARMUP, n_segments=S)),
         ("temporal", dict(frames=fr, ctx=(*art, p.resol, p.ori_x, p.ori_y),
                           warmup=WARMUP, n_segments=3))])
    jctx = jloop.make_map_context(*art, p.resol, p.ori_x, p.ori_y,
                                  dtype=np.float64)
    return fr, solo_context(ds, art), jctx, group


@pytest.fixture(scope="module")
def one_process(seq):
    fr, ctx, _j, _g = seq
    seq_out = {k: np_(v) for k, v in tloop.run_sequence(
        fr, ctx, device="cpu").items()}
    par = ttemp.run_sequence_temporal(fr, ctx, warmup=WARMUP, n_segments=S,
                                      device="cpu")
    return seq_out, par


def test_split_equals_jax(seq):
    fr = seq[0]
    for s, w in ((S, WARMUP), (3, 2), (1, 5)):
        got, L, F1 = ttemp.split_frames_temporal(fr, s, w)
        want, L2, F2 = jtemp.split_frames_temporal(fr, s, w)
        assert (L, F1) == (L2, F2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="warmup"):
        ttemp.split_frames_temporal(fr, 10, 4)
    with pytest.raises(ValueError, match="n_segments"):
        ttemp.split_frames_temporal(fr, 0, 2)


def test_temporal_within_tolerance_of_sequential(one_process):
    seq_out, par = one_process
    assert par["pose"].shape == seq_out["pose"].shape == (F, 3)
    ok = np.isfinite(seq_out["score"])
    assert ok.sum() > F // 2
    assert (np.isfinite(par["score"]) | ~ok).all()
    err = np.linalg.norm(par["pose"][:, :2] - seq_out["pose"][:, :2], axis=1)
    assert err[ok].max() < MAX_ERR_PX, err[ok].max()
    assert err[ok].mean() < MEAN_ERR_PX, err[ok].mean()


def test_temporal_matches_jax(seq, one_process):
    fr, _ctx, jctx, _g = seq
    _s, par = one_process
    want = jtemp.run_sequence_temporal(fr, jctx, jtemp.make_mesh_sp(S),
                                       JDEFAULT, warmup=WARMUP)
    for k in ("n_candidates", "candidate_overflow", "n_scan_lines",
              "coasting", "relock_deferred"):
        np.testing.assert_array_equal(par[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.isfinite(par["score"]),
                                  np.isfinite(want["score"]))
    np.testing.assert_allclose(par["pose"], want["pose"], rtol=0, atol=1e-6)


def test_two_ranks_match_one_process(seq, one_process):
    _s, par = one_process
    res = seq[3].results()
    for r, (got, refused) in enumerate(res):
        assert "multiple" in refused           # 3 segments over 2 ranks
        for k in par:
            if k == "pose":
                np.testing.assert_allclose(got[k], par[k], rtol=0,
                                           atol=1e-9)
            else:
                np.testing.assert_array_equal(np.isfinite(got[k]) if
                                              got[k].dtype.kind == "f"
                                              else got[k],
                                              np.isfinite(par[k]) if
                                              par[k].dtype.kind == "f"
                                              else par[k], err_msg=k)


def test_reconcile_matches_jax(one_process):
    _s, par = one_process
    got, info = ttemp.reconcile_temporal(par, device="cpu")
    want, winfo = jtemp.reconcile_temporal(par)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert int(info["n_measured"]) == int(winfo["n_measured"])
