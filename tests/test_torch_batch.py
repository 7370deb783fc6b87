"""Batched rollouts against the JAX package: lsdtpu_torch.runtime.batch
(run_batch, stack_batch) against lsdtpu.runtime.batch on synthetic
scenes of different map sizes and lengths (CPU), with pruning on and
off, on a u16 field, in f32, and with the per-lane options
(coast_on_loss, relock_margin, obstacle_tolerance, faithful); and
loop.batched_cfg against the reference's vmapped_cfg.  The lane
contracts (solo runs, padding, NaN isolation, corpus replay) are in
tests/test_torch_batch_lanes.py.

Tiers: f64 - identical n_candidates, candidate_overflow, n_scan_lines,
coasting, relock_deferred and tracked pattern, scores within 1e-9,
poses within 1e-6 px (tests/test_torch_loop.py's tier); f32 - identical
decisions."""

import dataclasses

import jax
import numpy as np
import pytest

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.runtime import batch as jbatch
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import LANES, batch_contexts, np_

DECISIONS = ("n_candidates", "candidate_overflow", "n_scan_lines",
             "coasting", "relock_deferred")


def _cfgs(**match):
    return tuple(dataclasses.replace(c, match=dataclasses.replace(
        c.match, **match)) for c in (JDEFAULT, DEFAULT))


def _both(dtype, cfgs=None, **kw):
    """(port outputs, JAX outputs, true lengths) of run_batch on LANES."""
    (jf, jc, lens), (tf, tc, tlens) = batch_contexts(dtype=dtype, cfgs=cfgs,
                                                     **kw)
    np.testing.assert_array_equal(lens, tlens)
    jcfg, tcfg = cfgs or (JDEFAULT, DEFAULT)
    want = jax.tree.map(np.asarray, jbatch.run_batch(jf, jc, jcfg))
    got = {k: np_(v) for k, v in
           tbatch.run_batch(tf, tc, tcfg, device="cpu").items()}
    return got, want, lens


def _assert_f64_tier(got, want, lens):
    for b, L in enumerate(lens):
        g = {k: v[b, :L] for k, v in got.items()}
        w = {k: v[b, :L] for k, v in want.items()}
        for k in DECISIONS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} lane {b}")
        fin = np.isfinite(w["score"])
        np.testing.assert_array_equal(np.isfinite(g["score"]), fin)
        np.testing.assert_allclose(g["score"][fin], w["score"][fin],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(g["pose"], w["pose"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("prune", [True, False])
def test_run_batch_f64_matches_jax(prune):
    """Three lanes of three map sizes (the canvas pad and each lane's
    rows/cols matter), one of them 3 frames shorter (padded)."""
    got, want, lens = _both(np.float64, _cfgs(prune=prune))
    assert got["pose"].shape == want["pose"].shape == (3, 10, 3)
    assert list(lens) == [f for *_s, f in LANES]
    _assert_f64_tier(got, want, lens)
    assert np.isfinite(got["score"][0]).all()


@pytest.mark.parametrize("faithful", [True, False])
def test_run_batch_options_match_jax(faithful):
    """coast_on_loss, relock_margin and obstacle_tolerance per lane, with
    the perfect-score NaN chain (seed 101) in lane 0 in faithful mode and
    its floored weights otherwise."""
    lanes = ((101, 200, 260, 10), LANES[1])
    cfgs = tuple(dataclasses.replace(c, faithful=faithful) for c in _cfgs(
        coast_on_loss=2, relock_margin=0.2, obstacle_tolerance=0.1))
    (jf, jc, lens), (tf, tc, _l) = batch_contexts(lanes, cfgs=cfgs)
    want = jax.tree.map(np.asarray, jbatch.run_batch(jf, jc, cfgs[0]))
    got = {k: np_(v) for k, v in
           tbatch.run_batch(tf, tc, cfgs[1], device="cpu").items()}
    for k in DECISIONS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"][fin], want["score"][fin],
                               rtol=0, atol=1e-9)
    assert np.isnan(got["pose"][0]).any() == faithful


def test_run_batch_u16_field_matches_jax():
    got, want, lens = _both(np.float64, cache_dtype="u16")
    _assert_f64_tier(got, want, lens)
    # the polish needs a float field, in a batch as alone
    _, (fr, ctx, _l) = batch_contexts(cache_dtype="u16")
    with pytest.raises(ValueError, match="float distance field"):
        tbatch.run_batch(fr, ctx, _cfgs(polish_pose=True)[1], device="cpu")


def test_run_batch_f32_decisions_match_jax():
    got, want, lens = _both(np.float32)
    assert got["pose"].dtype == np.float32
    for b, L in enumerate(lens):
        for k in ("n_candidates", "candidate_overflow"):
            np.testing.assert_array_equal(got[k][b, :L], want[k][b, :L])
        np.testing.assert_array_equal(np.isfinite(got["score"][b, :L]),
                                      np.isfinite(want["score"][b, :L]))


@pytest.mark.parametrize("match", [
    {}, dict(prune_min_live=0), dict(prune=False, prune_min_live=192),
    dict(score_window=768), dict(score_window=512, prune=False)])
def test_batched_cfg_is_vmapped_cfg(match):
    jcfg, tcfg = _cfgs(**match)
    want = jloop.vmapped_cfg(jcfg)
    got = tloop.batched_cfg(tcfg)
    for f in dataclasses.fields(got.match):
        assert getattr(got.match, f.name) == getattr(want.match, f.name), \
            f.name
    assert got.shapes == tcfg.shapes and got.faithful == tcfg.faithful
