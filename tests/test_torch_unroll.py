"""The rollout's execution strategies (cfg.prefeaturize, cfg.scan_unroll,
cfg.scan_unroll_batch_featurize) in lsdtpu_torch's run_sequence and
run_batch: the port's counterpart of tests/test_unroll.py (CPU).

Tiers: each strategy against the port's own default loop - bitwise
(featurize reads no carry, and each lane of a featurize call is
featurized on its own); featurize over two leading lane axes against
single-lane calls - bitwise; the port against the JAX package under the
same strategy - tests/test_torch_loop.py's tiers (f64: identical
decisions, scores within 1e-9, poses within 1e-6 px; f32: identical
n_candidates and tracked pattern, poses within 0.2 px)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.scan import featurize as tfeat

from torch_parity import (batch_contexts, contexts, frames, lane_scenes,
                          np_, solo_context)

BITWISE = ("pose", "score", "n_candidates", "candidate_overflow",
           "coasting", "relock_deferred")
# (prefeaturize, scan_unroll, scan_unroll_batch_featurize)
STRATEGIES = [(True, 1, True)] + [(False, k, b) for k in (2, 3, 4)
                                  for b in (True, False)]
# 41 frames: not a multiple of 2, 3 or 4, so every k pads its last block
SCENE = ((0, 200, 260, 41),)


def _cfg(base, prefeaturize, unroll, batch_featurize):
    return dataclasses.replace(base, prefeaturize=prefeaturize,
                               scan_unroll=unroll,
                               scan_unroll_batch_featurize=batch_featurize)


def _run(fr, ctx, cfg):
    return {k: np_(v) for k, v in
            tloop.run_sequence(fr, ctx, cfg, device="cpu").items()}


def _assert_bitwise(got, want):
    for k in BITWISE:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _scene(dtype, frames_=None):
    (ds,), (art,) = lane_scenes(SCENE)
    fr = tloop.stack_frames(ds, dtype=dtype, max_frames=frames_)
    return fr, solo_context(ds, art, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_bitwise_default(strategy, dtype):
    fr, ctx = _scene(dtype)
    want = _run(fr, ctx, DEFAULT)
    assert np.isfinite(want["score"]).sum() > 30
    _assert_bitwise(_run(fr, ctx, _cfg(DEFAULT, *strategy)), want)


@pytest.mark.parametrize("strategy", [(True, 1, True), (False, 2, True),
                                      (False, 4, True)])
def test_strategy_with_reset_flag(strategy):
    """A corpus-replay reset inside a featurized block (frame 15 of 30:
    the second frame of a k = 2 block, the fourth of a k = 4 block)
    resets the carry at its own frame."""
    fr, ctx = _scene(np.float64, 30)
    reset = np.zeros(30, bool)
    reset[0] = reset[15] = True
    fr = dict(fr, reset=reset)
    want = _run(fr, ctx, DEFAULT)
    _assert_bitwise(_run(fr, ctx, _cfg(DEFAULT, *strategy)), want)
    # the reset really restarts the chain: frame 15 takes the first-frame
    # argmin pose, not the tracked one
    plain = _run(dict(fr, reset=np.zeros(30, bool)), ctx, DEFAULT)
    np.testing.assert_array_equal(want["pose"][:15], plain["pose"][:15])
    assert not np.array_equal(want["pose"][15], plain["pose"][15])


@pytest.mark.parametrize("strategy", [(True, 1, True), (False, 3, True)])
def test_run_batch_strategy_bitwise_default(strategy):
    """Three lanes of three map sizes, one 3 frames shorter (padded):
    with prefeaturize one featurize call over the (F, B) frames."""
    _, (fr, ctxs, _lens) = batch_contexts()
    want = {k: np_(v) for k, v in
            tbatch.run_batch(fr, ctxs, DEFAULT, device="cpu").items()}
    got = {k: np_(v) for k, v in tbatch.run_batch(
        fr, ctxs, _cfg(DEFAULT, *strategy), device="cpu").items()}
    _assert_bitwise(got, want)


def _same(a, b):
    """Bit for bit, NaN where NaN (a vertical line's intercept)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


def _lane_stack():
    """(inputs (F, B, N) of the three lanes' scenes, resol/ori_x/ori_y
    (B,)) on the CPU."""
    _, (fr, ctxs, _lens) = batch_contexts()
    x = {k: torch.as_tensor(np.swapaxes(fr[k], 0, 1)).contiguous()
         for k in ("ranges", "angles", "valid", "n")}
    return x, (ctxs.resol, ctxs.ori_x, ctxs.ori_y)


def test_featurize_two_lane_axes_bitwise_single_lane():
    """featurize on an (F, B, N) stack (run_batch under prefeaturize)
    against one call a frame a lane; the RDP's host rounds are those of
    the slowest lane, one a round whatever the lane count."""
    x, scal = _lane_stack()
    args = [x[k] for k in ("ranges", "angles", "valid", "n")]
    tfeat._rdp_rounds.rounds = 0
    got = tfeat.featurize(*args, *scal)
    rounds_all = tfeat._rdp_rounds.rounds
    F, B = x["n"].shape
    most = 0
    for f in range(F):
        for b in range(B):
            tfeat._rdp_rounds.rounds = 0
            one = tfeat.featurize(*(a[f, b] for a in args),
                                  *(s[b] for s in scal))
            most = max(most, tfeat._rdp_rounds.rounds)
            for fld in dataclasses.fields(one):
                a = getattr(got, fld.name)[f, b]
                w = getattr(one, fld.name)
                assert a.shape == w.shape, fld.name
                assert _same(a, w), (f, b, fld.name)
    assert rounds_all == most > 1


def test_featurize_pieces_two_lane_axes():
    """_take, _prev_set_index/_next_set_index, the RDP rounds and
    _segment_pixels on two leading axes, each lane bitwise alone."""
    rng = np.random.default_rng(7)
    F, B, N = 4, 3, 40
    mask = torch.as_tensor(rng.random((F, B, N)) < 0.2)
    x = torch.as_tensor(rng.normal(size=(F, B, N)))
    i = torch.as_tensor(rng.integers(0, N, (F, B, N)))
    prev, nxt = tfeat._prev_set_index(mask), tfeat._next_set_index(mask)
    took = tfeat._take(x, i)
    # the RDP on random polylines: markers at both ends of each lane
    gwx = torch.as_tensor(np.cumsum(rng.normal(size=(F, B, N)), -1))
    gwy = torch.as_tensor(np.cumsum(rng.normal(size=(F, B, N)), -1))
    rng_r = torch.as_tensor(rng.uniform(0.5, 12.0, (F, B, N)))
    ends = torch.zeros((F, B, N), dtype=torch.bool)
    ends[..., 0] = ends[..., -1] = True
    marker = tfeat._rdp_rounds(gwx, gwy, rng_r, ends, ~ends, 0.08, N)
    # segments (F, B, S, 1) on a step grid, per-lane limits (F, B, 1, 1)
    e = torch.as_tensor(rng.uniform(0, 60, (F, B, 5, 4))).floor()
    lim = torch.as_tensor(rng.uniform(30, 60, (F, B, 1, 1))).floor()
    t = torch.arange(64, dtype=torch.float64)
    px = tfeat._segment_pixels(e[..., 0:1], e[..., 1:2], e[..., 2:3],
                               e[..., 3:4], lim, lim + 3, t)
    for f in range(F):
        for b in range(B):
            assert torch.equal(prev[f, b], tfeat._prev_set_index(mask[f, b]))
            assert torch.equal(nxt[f, b], tfeat._next_set_index(mask[f, b]))
            assert torch.equal(took[f, b], tfeat._take(x[f, b], i[f, b]))
            one = tfeat._rdp_rounds(gwx[f, b], gwy[f, b], rng_r[f, b],
                                    ends[f, b], ~ends[f, b], 0.08, N)
            assert torch.equal(marker[f, b], one)
            alone = tfeat._segment_pixels(
                e[f, b, :, 0:1], e[f, b, :, 1:2], e[f, b, :, 2:3],
                e[f, b, :, 3:4], lim[f, b], lim[f, b] + 3, t)
            for got, want in zip(px, alone):
                assert torch.equal(got[f, b], want)
    assert marker.sum() > 2 * F * B      # the rounds split some lanes


def _jax_and_port(seed, dtype, strategy):
    jctx, tctx = contexts(seed, dtype)
    fr = frames(seed, dtype)
    want = jax.tree.map(np.asarray, jloop.run_sequence(
        fr, jctx, _cfg(JDEFAULT, *strategy)))
    return _run(fr, tctx, _cfg(DEFAULT, *strategy)), want


@pytest.mark.parametrize("strategy", [(True, 1, True), (False, 3, True)])
def test_strategy_f64_matches_jax(strategy):
    got, want = _jax_and_port(1, np.float64, strategy)
    for k in ("n_candidates", "candidate_overflow", "n_scan_lines",
              "coasting", "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    assert fin.all()
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"], want["score"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=1e-6)


def test_strategy_f32_decisions_match_jax():
    got, want = _jax_and_port(0, np.float32, (True, 1, True))
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    np.testing.assert_array_equal(np.isfinite(got["score"]),
                                  np.isfinite(want["score"]))
    assert got["pose"].dtype == np.float32
    np.testing.assert_allclose(got["pose"], want["pose"], atol=0.2)
