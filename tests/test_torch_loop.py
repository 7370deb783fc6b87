"""The whole slice: lsdtpu_torch.runtime.loop.run_sequence against
lsdtpu.runtime.loop.run_sequence on test_fuzz_parity's synthetic scenes
(CPU), state conversion, and the default-device contract.

Tiers: f64 - identical finite-score pattern, n_candidates,
candidate_overflow and NaN-pose frames; scores within 1e-9; poses within
1e-6 px (the UKF chain amplifies the ulp-level differences of XLA's and
torch's CPU sin/cos/summation order).  f32 - identical n_candidates and
tracked/lost pattern."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.runtime import convert
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime.collectives import Axis

from torch_parity import contexts, frame_inputs, frames, np_, scene


def _rollouts(seed, dtype, cfg_kw=None):
    jctx, tctx = contexts(seed, dtype)
    fr = frames(seed, dtype)
    jcfg = jloop.DEFAULT
    tcfg = DEFAULT
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, match=dataclasses.replace(
            jcfg.match, **cfg_kw))
        tcfg = dataclasses.replace(tcfg, match=dataclasses.replace(
            tcfg.match, **cfg_kw))
    want = jax.tree.map(np.asarray, jloop.run_sequence(fr, jctx, jcfg))
    got = {k: np_(v) for k, v in
           tloop.run_sequence(fr, tctx, tcfg, device="cpu").items()}
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 101])
def test_rollout_f64_matches_jax(seed):
    got, want = _rollouts(seed, np.float64)
    for k in ("n_candidates", "candidate_overflow", "n_scan_lines",
              "coasting", "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"][fin], want["score"][fin],
                               rtol=0, atol=1e-9)
    nan = np.isnan(want["pose"]).any(1)
    np.testing.assert_array_equal(np.isnan(got["pose"]).any(1), nan)
    np.testing.assert_allclose(got["pose"][~nan], want["pose"][~nan],
                               rtol=0, atol=1e-6)
    if seed == 101:       # the perfect-score NaN chain is exercised
        assert nan.any() and (~fin).any()
    else:
        assert fin.all()


def test_rollout_f32_decisions_match_jax():
    got, want = _rollouts(0, np.float32)
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    np.testing.assert_array_equal(np.isfinite(got["score"]),
                                  np.isfinite(want["score"]))
    # poses: f32 rounding through the UKF chain (the reference package
    # holds its own f32 scorer variants to the same 0.2 px)
    assert got["pose"].dtype == np.float32
    np.testing.assert_allclose(got["pose"], want["pose"], atol=0.2)


@pytest.mark.parametrize("cfg_kw", [
    dict(prune_min_live=0), dict(prune=False),
    dict(coast_on_loss=2, relock_margin=0.2, obstacle_tolerance=0.1)])
def test_rollout_options_match_jax(cfg_kw):
    got, want = _rollouts(101, np.float64, cfg_kw)
    for k in ("n_candidates", "coasting", "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"][fin], want["score"][fin],
                               atol=1e-9)


def test_state_conversion_round_trip():
    """A JAX MapContext and mid-sequence TrackState drive the port to the
    same next frames as the JAX package."""
    seed, split = 0, 4
    jctx, _ = contexts(seed)
    fr = frames(seed)
    tctx = convert.map_context_from_numpy(
        **{f.name: np.asarray(getattr(jctx, f.name))
           for f in dataclasses.fields(jctx)}, device="cpu")
    assert tctx.rows == int(jctx.rows) and tctx.cache.dtype == torch.float64
    js = jloop.init_state(jnp.float64)
    coarse = jloop.prepare_coarse(jctx)
    jstep = jax.jit(lambda s, i: jloop.localization_step(s, i, jctx,
                                                         coarse=coarse))
    for f in range(split):
        js, _ = jstep(js, frame_inputs(fr, f)[0])
    st = convert.track_state_from_numpy(
        **{f.name: np.asarray(getattr(js, f.name))
           for f in dataclasses.fields(js)}, device="cpu")
    back = convert.track_state_to_numpy(st)
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(back[f.name],
                                      np.asarray(getattr(js, f.name)))
    tcoarse = tloop.prepare_coarse(tctx)
    for f in range(split, fr["ranges"].shape[0]):
        ji, ti = frame_inputs(fr, f)
        js, jo = jstep(js, ji)
        st, to = tloop.localization_step(st, ti, tctx, coarse=tcoarse)
        assert int(to["n_candidates"]) == int(jo["n_candidates"])
        np.testing.assert_allclose(np_(to["pose"]), np.asarray(jo["pose"]),
                                   atol=1e-6)


def test_default_device_is_the_card():
    ds, art = scene(0)
    args = (art.lines_info, art.map_cache, ds.param.resol, ds.param.ori_x,
            ds.param.ori_y)
    fr = frames(0)
    if torch.cuda.is_available():
        assert tloop.make_map_context(*args).cache.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.make_map_context(*args)
    ctx = tloop.make_map_context(*args, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.run_sequence(fr, ctx)
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.init_state()


def test_unported_options_raise():
    """match.polish_pose is ported (tests/test_torch_polish.py) and runs;
    tp/mp sharding is ported (tests/test_torch_shard.py): a step over
    one-rank axes gives the unsharded step's outputs, and the polish over
    a row block of the field (an mp axis of two ranks) raises, as in the
    reference package."""
    _, tctx = contexts(0)
    fr = frames(0)
    cfg = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, polish_pose=True))
    out = tloop.run_sequence(fr, tctx, cfg, device="cpu")
    assert torch.isfinite(out["score"]).all()
    st = tloop.init_state(torch.float64, "cpu")
    inputs = frame_inputs(fr, 0)[1]
    _, want = tloop.localization_step(st, inputs, tctx)
    for axis in ({"tp_axis": Axis.none()}, {"mp_axis": Axis.none()}):
        _, got = tloop.localization_step(st, inputs, tctx, **axis)
        for k in want:
            assert torch.equal(got[k].isnan(), want[k].isnan()), k
            assert torch.equal(got[k].nan_to_num(), want[k].nan_to_num()), k
    # the guard raises before any collective, so a stand-in axis will do
    two_ranks = types.SimpleNamespace(size=2, index=0)
    with pytest.raises(ValueError, match="polish_pose"):
        tloop.localization_step(st, inputs, tctx, cfg, mp_axis=two_ranks)
