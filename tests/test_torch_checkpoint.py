"""Checkpoint / resume: lsdtpu_torch.runtime.checkpoint and
OnlineLocalizer.save/restore against lsdtpu.runtime.checkpoint (the
same npz format) on test_fuzz_parity's synthetic scenes (CPU).

Tiers: a round trip and a resume inside the port are bitwise; a resume
across packages gives identical decisions and poses within 1e-6 px of
the other package continuing (the rollout tier)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.runtime import checkpoint as jckpt
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.runtime import checkpoint as tckpt
from lsdtpu_torch.runtime import convert
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import localizers, np_, scene

SEED, CUT = 0, 4


def _push(loc, ds, frames):
    return [loc.push_scan(ds.frames[f][:, 0], ds.frames[f][:, 1],
                          ds.odom[f + 1]) for f in frames]


def _assert_rollout_close(got, want):
    for g, w in zip(got, want):
        assert int(g["n_candidates"]) == int(w["n_candidates"])
        assert np.isfinite(g["score"]) == np.isfinite(w["score"])
        np.testing.assert_allclose(g["pose"], w["pose"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_round_trip(tmp_path, dtype):
    ds, _ = scene(SEED)
    _, t = localizers(SEED, dtype=dtype)
    _push(t, ds, range(CUT))
    path = str(tmp_path / "sub" / "state.npz")
    t.save(path)
    state, prev = tckpt.load_session(path, device="cpu")
    want = convert.track_state_to_numpy(t.state)
    got = convert.track_state_to_numpy(state)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(prev, ds.odom[CUT].astype(dtype))
    assert os.listdir(tmp_path / "sub") == ["state.npz"]


def test_resume_mid_sequence_is_bitwise(tmp_path):
    ds, _ = scene(SEED)
    F = len(ds.frames)
    _, ref = localizers(SEED)
    want = _push(ref, ds, range(F))
    _, a = localizers(SEED)
    _push(a, ds, range(CUT))
    path = str(tmp_path / "state.npz")
    a.save(path)
    _, b = localizers(SEED)
    b.restore(path)
    got = _push(b, ds, range(CUT, F))
    for g, w in zip(got, want[CUT:]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    ds, _ = scene(SEED)
    F = len(ds.frames)
    j, t = localizers(SEED)
    _push(j, ds, range(CUT))
    path = str(tmp_path / "jax.npz")
    j.save(path)
    want = _push(j, ds, range(CUT, F))
    t.restore(path)
    np.testing.assert_array_equal(t._prev_odom, ds.odom[CUT])
    assert int(t.state.frame) == CUT
    _assert_rollout_close(_push(t, ds, range(CUT, F)), want)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    ds, _ = scene(SEED)
    F = len(ds.frames)
    j, t = localizers(SEED)
    _push(t, ds, range(CUT))
    path = str(tmp_path / "port.npz")
    t.save(path)
    want = _push(t, ds, range(CUT, F))
    state, prev = jckpt.load_session(path, dtype=np.float64)
    back = convert.track_state_to_numpy(tckpt.load_session(
        path, device="cpu")[0])
    for k in back:
        np.testing.assert_array_equal(np.asarray(getattr(state, k)), back[k],
                                      err_msg=k)
    j.restore(path)
    _assert_rollout_close(_push(j, ds, range(CUT, F)), want)


def test_file_without_lost_streak_loads(tmp_path):
    """A round-1 checkpoint (no lost_streak field) loads with the
    default 0 in either package."""
    st = jloop.init_state(jnp.float64)
    arrs = {f: np.asarray(getattr(st, f)) for f in jckpt._FIELDS
            if f != "lost_streak"}
    path = str(tmp_path / "round1.npz")
    np.savez(path, **arrs)
    state, prev = tckpt.load_session(path, dtype=torch.float32, device="cpu")
    assert prev is None
    assert state.lost_streak.dtype == torch.int32
    assert int(state.lost_streak) == 0
    assert state.kalman_x.dtype == torch.float32
    assert int(jckpt.load_state(path).lost_streak) == 0


def test_dtypes_cast_to_the_session(tmp_path):
    """Float fields and prev_odom take the session dtype; the counters
    stay int32 and is_offset bool."""
    st = tloop.init_state(torch.float64, "cpu")
    path = str(tmp_path / "f64.npz")
    tckpt.save_state(path, st, prev_odom=torch.tensor([1.0, 2.0, 0.5],
                                                      dtype=torch.float64))
    state, prev = tckpt.load_session(path, dtype=np.float32, device="cpu")
    assert prev.dtype == np.float32
    np.testing.assert_array_equal(prev, [1.0, 2.0, 0.5])
    for f, dt in (("kalman_x", torch.float32), ("kalman_P", torch.float32),
                  ("last_pose", torch.float32), ("ang_sum", torch.float32),
                  ("ang_cnt", torch.int32), ("frame", torch.int32),
                  ("lost_streak", torch.int32), ("is_offset", torch.bool)):
        assert getattr(state, f).dtype == dt, f


def test_failed_write_leaves_no_tmp_file(tmp_path, monkeypatch):
    st = tloop.init_state(torch.float64, "cpu")
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, st)
    before = open(path, "rb").read()

    def broken(fh, **arrs):
        fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_state(path, st, prev_odom=np.zeros(3))
    assert os.listdir(tmp_path) == ["state.npz"]
    assert open(path, "rb").read() == before


def test_default_device_is_the_card(tmp_path):
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, tloop.init_state(torch.float32, "cpu"))
    if torch.cuda.is_available():
        assert tckpt.load_session(path)[0].kalman_x.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tckpt.load_session(path)
    state, _ = tckpt.load_session(path, device="cpu")
    assert np_(state.kalman_x).shape == (9,)


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_load_state_reads_a_jax_checkpoint(tmp_path, dtype):
    """load_state gives load_session's TrackState (without the odometry
    anchor) of a file the JAX package wrote, and the JAX load_state's
    values."""
    ds, _ = scene(SEED)
    j, _ = localizers(SEED)
    _push(j, ds, range(CUT))
    path = str(tmp_path / "jax.npz")
    j.save(path)
    got = convert.track_state_to_numpy(
        tckpt.load_state(path, dtype=dtype, device="cpu"))
    want = convert.track_state_to_numpy(
        tckpt.load_session(path, dtype=dtype, device="cpu")[0])
    ref = jckpt.load_state(path, dtype=dtype)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    assert int(got["frame"]) == CUT
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tckpt.load_state(path)
