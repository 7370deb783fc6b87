"""The legacy (ROS V2.2) matcher: lsdtpu_torch.match.legacy against
lsdtpu.match.legacy and the numpy oracle (lsdtpu.oracle.legacy_fa) on
test_fuzz_parity's synthetic scenes (CPU, f64, the ROS node's z = 2 m
field).

Tiers: candidates exact (count, mask, poses; cos/sin within 1e-15),
scores within 1e-12 relative with the same inf pattern, the same chosen
index; the chosen pose against the oracle within 1e-9 px."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.match import legacy as jlegacy
from lsdtpu.match.associate import Candidates as JCandidates
from lsdtpu.oracle import legacy_fa as olegacy
from lsdtpu.oracle import lsd as olsd
from lsdtpu.oracle import rdp as ordp
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.match import legacy as tlegacy
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import np_, port_candidates, scene

N = 360


def _field2(seed):
    ds, _ = scene(seed)
    return olsd.create_map_cache(ds.map_value, ds.param.resol, 2.0)


def _inputs(seed, f, max_candidates=2048):
    """(JAX, port) candidates + scoring inputs of frame f, and the raw
    frame: both packages featurize and generate from the same scan."""
    ds, art = scene(seed)
    cache = _field2(seed)
    p = ds.param
    args = (art.lines_info, cache, p.resol, p.ori_x, p.ori_y)
    jctx = jloop.make_map_context(*args, dtype=np.float64)
    tctx = tloop.make_map_context(*args, dtype=np.float64, device="cpu")
    fr = ds.frames[f]
    n = len(fr)
    r = np.zeros(N)
    a = np.zeros(N)
    v = np.zeros(N, bool)
    r[:n], a[:n], v[:n] = fr[:, 0], fr[:, 1], True
    jin = (jnp.asarray(r), jnp.asarray(a), jnp.asarray(v),
           jnp.asarray(n, jnp.int32), None, None)
    tin = (torch.from_numpy(r), torch.from_numpy(a), torch.from_numpy(v),
           torch.tensor(n, dtype=torch.int32), None, None)
    jfs = jloop.featurize_stage(jin, jctx)
    tfs = tloop.featurize_stage(tin, tctx)
    jc = jlegacy.generate_candidates_legacy(
        jfs.lines, jfs.lines_mask, jctx.lines, jctx.lines_mask,
        jfs.lidar_pos, jctx.resol, max_candidates=max_candidates)
    tc = tlegacy.generate_candidates_legacy(
        tfs.lines, tfs.lines_mask, tctx.lines, tctx.lines_mask,
        tfs.lidar_pos, tctx.resol, max_candidates=max_candidates)
    return (jc, jin, jctx), (tc, tin, tctx), fr


def _scores(jside, tside, jc=None, tc=None):
    (jc0, jin, jctx), (tc0, tin, tctx) = jside, tside
    jc = jc0 if jc is None else jc
    tc = tc0 if tc is None else tc
    js = jlegacy.score_candidates_legacy(
        jc, jin[0], jin[1], jin[2], jin[3], jctx.cache, jctx.resol,
        rows=jctx.rows, cols=jctx.cols)
    ts = tlegacy.score_candidates_legacy(
        tc, tin[0], tin[1], tin[2], tin[3], tctx.cache, tctx.resol,
        rows=tctx.rows, cols=tctx.cols)
    return np.asarray(js), ts


@pytest.mark.parametrize("seed,f", [(0, 0), (0, 7), (1, 3), (101, 9)])
def test_legacy_matches_jax(seed, f):
    jside, tside, _ = _inputs(seed, f)
    jc, tc = jside[0], tside[0]
    assert int(tc.count) == int(jc.count) > 0
    np.testing.assert_array_equal(np_(tc.mask), np.asarray(jc.mask))
    np.testing.assert_array_equal(np_(tc.pose), np.asarray(jc.pose))
    for k in ("sx", "sy", "mx", "my"):
        np.testing.assert_array_equal(np_(getattr(tc, k)),
                                      np.asarray(getattr(jc, k)), k)
    for k in ("ca", "sa"):
        np.testing.assert_allclose(np_(getattr(tc, k)),
                                   np.asarray(getattr(jc, k)), rtol=0,
                                   atol=1e-15, err_msg=k)
    js, ts = _scores(jside, tside)
    ts = np_(ts)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    assert fin.any()
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-12, atol=0)
    assert int(np.argmin(ts)) == int(np.argmin(js))
    jpose, jbest = jlegacy.first_min_pose(jc, jnp.asarray(js))
    tpose, tbest = tlegacy.first_min_pose(tc, torch.from_numpy(ts))
    np.testing.assert_array_equal(np_(tpose), np.asarray(jpose))
    assert float(tbest) == ts.min()
    np.testing.assert_allclose(float(tbest), float(jbest), rtol=1e-12)


@pytest.mark.parametrize("seed,f", [(0, 0), (1, 5), (2, 9)])
def test_legacy_pose_matches_oracle(seed, f):
    _jside, (tc, tin, tctx), fr = _inputs(seed, f)
    ds, art = scene(seed)
    p = ds.param
    ranges, angles = fr[:, 0].astype(np.float64), fr[:, 1].astype(np.float64)
    fs = ordp.feature_scan(ranges, angles, p.resol, p.ori_x, p.ori_y)
    pose_o, cands_o = olegacy.feature_association_legacy(
        fs.lines_info, art.lines_info, np.array(fs.lidar_pos, np.float64),
        _field2(seed), ranges, angles, p.resol)
    assert int(tc.count) == len(cands_o)
    ts = tlegacy.score_candidates_legacy(
        tc, tin[0], tin[1], tin[2], tin[3], tctx.cache, tctx.resol,
        rows=tctx.rows, cols=tctx.cols)
    m = np_(tc.mask)
    got = sorted(zip(np_(tc.pose[:, 0])[m], np_(tc.pose[:, 1])[m], np_(ts)[m]))
    want = sorted((c.x, c.y, c.score) for c in cands_o)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-9)
    pose, best = tlegacy.first_min_pose(tc, ts)
    assert pose_o is not None and math.isfinite(float(best))
    np.testing.assert_allclose(np_(pose), pose_o, rtol=0, atol=1e-9)


def test_first_min_takes_the_first_of_a_tie():
    """Candidates that floor onto one pose score bit for bit the same,
    and the earliest slot wins on both packages (as the reference's
    strict-less scan)."""
    jside, tside, _ = _inputs(0, 0)
    jc = jside[0]
    js, _ = _scores(jside, tside)
    live = np.flatnonzero(np.isfinite(js))
    order = live[np.argsort(js[live], kind="stable")]
    best, other = int(order[0]), int(order[-1])
    # slots: [worse, best, best, worse, best] of the frame's own poses
    rows = [other, best, best, other, best]
    fields = {k: np.asarray(getattr(jc, k))[rows]
              for k in ("ca", "sa", "sx", "sy", "mx", "my", "pose")}
    jt = JCandidates(**{k: jnp.asarray(v) for k, v in fields.items()},
                     mask=jnp.ones(5, bool), count=jnp.asarray(5, jnp.int32))
    tt = port_candidates(jt)
    js2, ts2 = _scores(jside, tside, jc=jt, tc=tt)
    ts2 = np_(ts2)
    assert ts2[1] == ts2[2] == ts2[4] < ts2[0]
    np.testing.assert_allclose(ts2, js2, rtol=1e-12)
    tpose, tbest = tlegacy.first_min_pose(tt, torch.from_numpy(ts2))
    jpose, _ = jlegacy.first_min_pose(jt, jnp.asarray(js2))
    assert int(torch.argmin(torch.from_numpy(ts2))) == 1
    np.testing.assert_array_equal(np_(tpose), np.asarray(jpose))
    assert float(tbest) == ts2[1]


def test_overflow_flag_and_prefix():
    jside, tside, _ = _inputs(1, 0, max_candidates=4)
    jc, tc = jside[0], tside[0]
    assert int(tc.count) == int(jc.count) > 4
    assert bool(tc.mask.all()) and tc.mask.shape == (4,)
    np.testing.assert_array_equal(np_(tc.pose), np.asarray(jc.pose))


@pytest.mark.parametrize("below", [False, True])
def test_cap_is_exact_equality(below):
    """A field of exactly z scores every in-bounds ray at the 7x cap
    weight; one ulp below z scores the distances themselves."""
    jside, tside, _ = _inputs(0, 0)
    (jc, jin, jctx), (tc, tin, tctx) = jside, tside
    val = np.nextafter(2.0, 0.0) if below else 2.0
    field = np.full(np_(tctx.cache).shape, val)
    jside = (jc, jin, dataclasses.replace(jctx, cache=jnp.asarray(field)))
    tctx.cache = torch.from_numpy(field)
    js, ts = _scores(jside, (tc, tin, tctx))
    ts = np_(ts)
    fin = np.isfinite(ts)
    np.testing.assert_array_equal(fin, np.isfinite(js))
    assert fin.any()
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-12)
    n = int(tin[3])
    tail = ts[fin] - (7.0 if not below else val)
    # what is left is the out-of-bounds term 10 (n - scanlen) / n >= 0
    assert (tail > -1e-12).all() and (tail < 10.0 * 0.25 + 1e-12).all()
    assert np.allclose(tail * n / 10.0, np.round(tail * n / 10.0))
