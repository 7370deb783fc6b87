"""The DCP checkpoint (lsdtpu_torch.runtime.checkpoint.save_state_dcp /
load_state_dcp) against the JAX package's orbax checkpoint
(lsdtpu.runtime.checkpoint.save_state_orbax / load_state_orbax) on the
CPU, on the synthetic scenes of tests/torch_parity.py.

The same state, taken after a few real localization steps of the port,
goes through both round trips: each gives it back bit for bit, with its
dtypes and shapes (f32 and f64, a session's and a 4-lane batch's).  The
rest holds the port's own contract: a field the checkpoint lacks takes
its default, a second save replaces the first, a failed write leaves
the old checkpoint and no temporary directory, a failed read raises,
the default device is the card, a session resumes bit for bit, and two
gloo ranks save one checkpoint and both read it back.  The JAX half
skips where orbax is not installed."""

import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException

import torch_ranks
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import checkpoint as tckpt
from lsdtpu_torch.runtime import convert
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import lane_scenes, localizers, scene

SEED, CUT, STEPS = 0, 4, 3
LANES4 = ((0, 200, 260, 10), (1, 180, 240, 10), (2, 210, 250, 7),
          (3, 190, 250, 8))
KEYS = ("ranges", "angles", "valid", "n", "odom_prev", "odom_cur")


def stepped_state(dtype, lanes):
    """The port's TrackState after STEPS localization steps on the CPU:
    one session on scene SEED, or a batch over the LANES4 scenes."""
    if lanes is None:
        ds, art = scene(SEED)
        p = ds.param
        ctx = tloop.make_map_context(art.lines_info, art.map_cache, p.resol,
                                     p.ori_x, p.ori_y, dtype=dtype,
                                     device="cpu")
        fr = tloop.to_device(tloop.stack_frames(ds, dtype=dtype), "cpu")
        cfg = DEFAULT
    else:
        dss, arts = lane_scenes(LANES4)
        fr, ctx, _ = tbatch.stack_batch(dss, arts, DEFAULT, dtype=dtype,
                                        device="cpu")
        fr = {k: torch.as_tensor(v).transpose(0, 1) for k, v in fr.items()}
        cfg = tloop.batched_cfg(DEFAULT)
    state = tloop.init_state(dtype, "cpu", lanes=lanes)
    coarse = tloop.prepare_coarse(ctx, cfg)
    for f in range(STEPS):
        state, _ = tloop.localization_step(
            state, tuple(fr[k][f] for k in KEYS), ctx, cfg, coarse=coarse)
    return state


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def port_trip(path, state):
    tckpt.save_state_dcp(path, state)
    return convert.track_state_to_numpy(
        tckpt.load_state_dcp(path, device="cpu"))


def jax_trip(path, arrs):
    import jax.numpy as jnp
    from lsdtpu.runtime import checkpoint as jckpt
    from lsdtpu.runtime.loop import TrackState as JTrackState
    jckpt.save_state_orbax(path, JTrackState(
        **{k: jnp.asarray(v) for k, v in arrs.items()}))
    back = jckpt.load_state_orbax(path)
    return {k: np.asarray(getattr(back, k)) for k in arrs}


@pytest.mark.parametrize("lanes", [None, 4], ids=["session", "lanes4"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_round_trip_matches_orbax(tmp_path, dtype, lanes):
    pytest.importorskip("orbax.checkpoint")
    state = stepped_state(dtype, lanes)
    want = convert.track_state_to_numpy(state)
    assert int(want["frame"].max()) == STEPS
    if lanes is not None:
        assert want["kalman_P"].shape == (lanes, 9, 9)
    port = port_trip(str(tmp_path / "dcp"), state)
    jax = jax_trip(str(tmp_path / "orbax"), want)
    assert_same(port, want)
    assert_same(jax, want)
    assert_same(port, jax)


@pytest.mark.parametrize("lanes", [None, 4], ids=["session", "lanes4"])
def test_round_trip_keeps_dtype_and_shape(tmp_path, lanes):
    state = stepped_state(np.float32, lanes)
    assert_same(port_trip(str(tmp_path / "dcp"), state),
                convert.track_state_to_numpy(state))
    assert sorted(os.listdir(tmp_path)) == ["dcp"]
    assert ".metadata" in os.listdir(tmp_path / "dcp")


def test_single_process_prints_no_warning(tmp_path):
    """Without a process group DCP warns on every call that it assumes
    a single process; the port takes that path on purpose and silences
    only that warning."""
    path = str(tmp_path / "ckpt")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        port_trip(path, tloop.init_state(torch.float64, "cpu"))
    assert not [w for w in seen if "torch.distributed" in str(w.message)]


@pytest.mark.filterwarnings("ignore:torch.distributed is disabled")
def test_absent_lost_streak_loads_as_zero(tmp_path):
    arrs = convert.track_state_to_numpy(tloop.init_state(torch.float64,
                                                         "cpu"))
    del arrs["lost_streak"]
    path = str(tmp_path / "round1")
    dcp.save({k: torch.from_numpy(v) for k, v in arrs.items()},
             checkpoint_id=path, no_dist=True)
    state = tckpt.load_state_dcp(path, device="cpu")
    assert state.lost_streak.dtype == torch.int32
    assert state.lost_streak.shape == () and int(state.lost_streak) == 0
    assert state.kalman_x.dtype == torch.float64


def test_absent_lost_streak_loads_as_zero_in_jax(tmp_path):
    ocp = pytest.importorskip("orbax.checkpoint")
    from lsdtpu.runtime import checkpoint as jckpt
    arrs = convert.track_state_to_numpy(tloop.init_state(torch.float64,
                                                         "cpu"))
    del arrs["lost_streak"]
    path = str(tmp_path / "round1")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, arrs)
    ckptr.wait_until_finished()
    back = jckpt.load_state_orbax(path)
    assert np.asarray(back.lost_streak).dtype == np.int32
    assert int(back.lost_streak) == 0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_second_save_wins(tmp_path, side):
    if side == "jax":
        pytest.importorskip("orbax.checkpoint")
    first = convert.track_state_to_numpy(tloop.init_state(torch.float64,
                                                          "cpu"))
    second = convert.track_state_to_numpy(stepped_state(np.float64, None))
    path = str(tmp_path / "ckpt")
    for arrs in (first, second):
        if side == "port":
            got = port_trip(path, convert.track_state_from_numpy(
                **arrs, device="cpu"))
        else:
            got = jax_trip(path, arrs)
    assert_same(got, second)
    assert os.listdir(tmp_path) == ["ckpt"]


def test_failed_write_leaves_old_checkpoint(tmp_path, monkeypatch):
    st = stepped_state(np.float64, None)
    path = str(tmp_path / "ckpt")
    tckpt.save_state_dcp(path, st)
    before = {n: (tmp_path / "ckpt" / n).read_bytes()
              for n in os.listdir(path)}

    def broken(self, plan, planner):
        with open(os.path.join(self.path, "__0_0.distcp"), "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(dcp.FileSystemWriter, "write_data", broken)
    # DCP raises its CheckpointException (a BaseException) with the
    # rank's own error
    with pytest.raises(CheckpointException, match="disk full"):
        tckpt.save_state_dcp(path, tloop.init_state(torch.float64, "cpu"))
    assert os.listdir(tmp_path) == ["ckpt"]
    assert {n: (tmp_path / "ckpt" / n).read_bytes()
            for n in os.listdir(path)} == before
    monkeypatch.undo()
    assert_same(convert.track_state_to_numpy(
        tckpt.load_state_dcp(path, device="cpu")),
        convert.track_state_to_numpy(st))


def test_failed_read_raises(tmp_path):
    """No fallback: an npz or a directory without DCP metadata raises."""
    npz = str(tmp_path / "state.npz")
    tckpt.save_state(npz, tloop.init_state(torch.float64, "cpu"))
    for path in (npz, str(tmp_path)):
        with pytest.raises(Exception):
            tckpt.load_state_dcp(path, device="cpu")


def test_orbax_checkpoint_is_not_read(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    arrs = convert.track_state_to_numpy(tloop.init_state(torch.float64,
                                                         "cpu"))
    path = str(tmp_path / "orbax")
    jax_trip(path, arrs)
    with pytest.raises(Exception):
        tckpt.load_state_dcp(path, device="cpu")


def test_default_device_is_the_card(tmp_path):
    path = str(tmp_path / "ckpt")
    tckpt.save_state_dcp(path, tloop.init_state(torch.float32, "cpu"))
    if torch.cuda.is_available():
        assert tckpt.load_state_dcp(path).kalman_x.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tckpt.load_state_dcp(path)
    assert tckpt.load_state_dcp(path, device="cpu").kalman_x.shape == (9,)


def _push(loc, ds, frames):
    return [loc.push_scan(ds.frames[f][:, 0], ds.frames[f][:, 1],
                          ds.odom[f + 1]) for f in frames]


def test_resume_mid_sequence_is_bitwise(tmp_path):
    """The odometry anchor comes from the npz (the DCP checkpoint, as
    orbax's, holds the TrackState only), the state from DCP."""
    ds, _ = scene(SEED)
    F = len(ds.frames)
    _, ref = localizers(SEED)
    want = _push(ref, ds, range(F))
    _, a = localizers(SEED)
    _push(a, ds, range(CUT))
    npz, ck = str(tmp_path / "state.npz"), str(tmp_path / "state.dcp")
    a.save(npz)
    tckpt.save_state_dcp(ck, a.state)
    _, b = localizers(SEED)
    b.restore(npz)
    restored = convert.track_state_to_numpy(b.state)
    b.state = tckpt.load_state_dcp(ck, device="cpu")
    assert_same(convert.track_state_to_numpy(b.state), restored)
    got = _push(b, ds, range(CUT, F))
    for g, w in zip(got, want[CUT:]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_two_ranks_save_one_checkpoint(tmp_path):
    state = convert.track_state_to_numpy(stepped_state(np.float64, None))
    path = str(tmp_path / "ckpt")
    ranks_dir = tmp_path / "ranks"
    ranks_dir.mkdir()
    res = torch_ranks.run_group(ranks_dir, 2, [
        ("checkpoint_dcp", dict(path=path, state=state))], timeout_s=120)
    for r in range(2):
        assert_same(res[r][0], state)
    names = os.listdir(path)
    assert names.count(".metadata") == 1
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # each field's bytes stored once, in one rank's file
    stored = [i.fqn for i in
              dcp.FileSystemReader(path).read_metadata().storage_data]
    assert sorted(stored) == sorted(state)
