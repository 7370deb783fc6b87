"""Sharded batched rollouts: lsdtpu_torch.runtime.shard against the
port's run_batch / run_sequence and against lsdtpu.runtime.shard, on
synthetic scenes of three map sizes (CPU, f64).

The port's ranks are four spawned gloo processes (tests/torch_ranks.py)
running, in one group: tp over four ranks with an odd number of map
lines (padded to the mesh), mp over four ranks on a u16 field whose
canvas height is not a multiple of four, dp x tp and dp x mp (2 x 2) on
an odd batch (padded to dp), a concatenated corpus with reset flags under
tp and mp, and tp with the pose polish.  The JAX side runs the same
(2 x 2) meshes on the test process's virtual CPU devices.

Tiers: tests/test_runtime_parallel.py's - every rank's poses within
1e-9 px of the unsharded rollout and n_candidates equal; against the JAX
package's sharded rollouts tests/test_torch_loop.py's f64 tier (poses
within 1e-6 px, identical decisions).  And the lane-batched CalcScore
over a row block (the mp ranks' launch) against the JAX package's
score_candidates_partial with the same row0: counts exact, sums within
rel 1e-12; the blocks' partials add up to the whole field's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.match import associate as jas
from lsdtpu.runtime import shard as jshard
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.match import associate as tas
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime.loop import MapContext

import torch_ranks
from torch_parity import (batch_contexts, contexts, frame_inputs, frames,
                          lane_scenes, np_, solo_context)

NF = 8
LANES8 = ((0, 200, 260, NF), (1, 180, 240, NF), (2, 210, 250, NF - 2))
ODD_M = 61          # map lines kept (padding included): not a multiple of 4
CONCAT_F = 5
POLISH = dataclasses.replace(DEFAULT, match=dataclasses.replace(
    DEFAULT.match, polish_pose=True))


def _odd_lines(ctxs):
    return dataclasses.replace(ctxs, lines=ctxs.lines[:, :ODD_M],
                               lines_mask=ctxs.lines_mask[:, :ODD_M])


def _concat():
    """A stack_concat corpus (seed 0's sequence twice, with reset flags)
    lifted to one lane, its batched context, and the solo rollout."""
    dss, arts = lane_scenes(LANES8)
    ds, art = dss[0], arts[0]
    fr, bounds = tbatch.stack_concat([ds, ds], dtype=np.float64,
                                     max_frames=CONCAT_F)
    ctx = solo_context(ds, art)
    solo = tloop.run_sequence(tloop.stack_frames(ds, dtype=np.float64,
                                                 max_frames=CONCAT_F),
                              ctx, device="cpu")
    bctx = MapContext(*(torch.as_tensor(getattr(ctx, f.name))[None]
                        for f in dataclasses.fields(MapContext)))
    bctx = dataclasses.replace(bctx, rows=bctx.rows.to(torch.int32),
                               cols=bctx.cols.to(torch.int32))
    return ({k: v[None] for k, v in fr.items()}, bctx, bounds,
            {k: np_(v) for k, v in solo.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(jobs' inputs, each rank's results, JAX's (2 x 2) outputs)."""
    (jf, jc, lens), (tf, tc, _) = batch_contexts(LANES8)
    _, (uf, uc, _) = batch_contexts(LANES8, cache_dtype="u16")
    cf, cc, bounds, solo = _concat()
    jobs = [
        ("tp4_odd_lines", tf, _odd_lines(tc), DEFAULT, "tp", 1),
        ("mp4_u16", uf, uc, DEFAULT, "mp", 1),
        ("dp2_tp2", tf, tc, DEFAULT, "tp", 2),
        ("dp2_mp2", tf, tc, DEFAULT, "mp", 2),
        ("concat_tp4", cf, cc, DEFAULT, "tp", 1),
        ("concat_mp4", cf, cc, DEFAULT, "mp", 1),
        ("dp2_tp2_polish", tf, tc, POLISH, "tp", 2)]
    group = torch_ranks.Group(
        tmp_path_factory.mktemp("ranks"), 4,
        [("shard", dict(frames=f, ctxs=torch_ranks.host(c), cfg=cfg,
                        kind=kind, dp=dp))
         for _name, f, c, cfg, kind, dp in jobs])
    # the JAX package's (2 x 2) meshes while the ranks run
    jax_outs = {
        "dp2_tp2": jshard.run_batch_sharded(
            jf, jc, jshard.make_mesh(n_devices=4, dp=2), JDEFAULT),
        "dp2_mp2": jshard.run_batch_sharded_mapblocks(
            jf, jc, jshard.make_mesh_mp(n_devices=4, dp=2), JDEFAULT)}
    jax_outs = {k: jax.tree.map(np.asarray, v) for k, v in jax_outs.items()}
    ref = {}
    for name, f, c, cfg, _kind, _dp in jobs:
        if name.startswith("concat"):
            continue
        ref[name] = {k: np_(v) for k, v in tbatch.run_batch(
            f, c, cfg, device="cpu").items()}
    res = group.results()
    return ({name: [r[i] for r in res] for i, (name, *_rest) in
             enumerate(jobs)}, ref, jax_outs, lens, bounds, solo)


def _assert_lanes(got, want, lens, atol):
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got["pose"][b, :L], want["pose"][b, :L],
                                   rtol=0, atol=atol, err_msg=f"lane {b}")
        for k in ("n_candidates", "candidate_overflow", "n_scan_lines"):
            np.testing.assert_array_equal(got[k][b, :L], want[k][b, :L],
                                          err_msg=f"{k} lane {b}")
        np.testing.assert_array_equal(np.isfinite(got["score"][b, :L]),
                                      np.isfinite(want["score"][b, :L]))


@pytest.mark.parametrize("name", ["tp4_odd_lines", "mp4_u16", "dp2_tp2",
                                  "dp2_mp2", "dp2_tp2_polish"])
def test_sharded_matches_run_batch(runs, name):
    by_rank, ref, _jax, lens, _b, _s = runs
    for got in by_rank[name]:
        assert got["pose"].shape == ref[name]["pose"].shape
        _assert_lanes(got, ref[name], lens, 1e-9)
    # every rank returns the same outputs
    for got in by_rank[name][1:]:
        for k in got:
            np.testing.assert_array_equal(got[k], by_rank[name][0][k])


@pytest.mark.parametrize("name", ["dp2_tp2", "dp2_mp2"])
def test_sharded_matches_jax(runs, name):
    by_rank, _ref, jax_outs, lens, _b, _s = runs
    want = jax_outs[name]
    got = by_rank[name][0]
    _assert_lanes(got, want, lens, 1e-6)
    for b, L in enumerate(lens):
        fin = np.isfinite(want["score"][b, :L])
        np.testing.assert_allclose(got["score"][b, :L][fin],
                                   want["score"][b, :L][fin], rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("name", ["concat_tp4", "concat_mp4"])
def test_concat_with_resets_matches_standalone(runs, name):
    by_rank, _ref, _jax, _lens, bounds, solo = runs
    for got in by_rank[name]:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            np.testing.assert_allclose(got["pose"][0][lo:hi], solo["pose"],
                                       rtol=0, atol=1e-9)
            np.testing.assert_array_equal(got["n_candidates"][0][lo:hi],
                                          solo["n_candidates"])


def _lane_candidates(seeds, f=0):
    """Two lanes' relock candidates, pixels and fields on a common canvas
    (the cap beyond each map), batched, plus each lane's JAX Candidates."""
    cands, pix, masks, fields, dims, jcands = [], [], [], [], [], []
    for s in seeds:
        _, tctx = contexts(s)
        fs = tloop.featurize_stage(frame_inputs(frames(s), f)[1], tctx)
        c = tas.generate_candidates(
            fs.lines, fs.lines_mask, tctx.lines, tctx.lines_mask,
            tloop.geo.c_round(fs.lidar_pos),
            torch.tensor([-1.0, -1.0, 0.0], dtype=torch.float64),
            DEFAULT.shapes.max_candidates)
        cands.append(c)
        jcands.append(jas.Candidates(**{
            k: jnp.asarray(np_(getattr(c, k))) for k in
            ("ca", "sa", "sx", "sy", "mx", "my", "pose", "mask", "count")}))
        pix.append(fs.pixels)
        masks.append(fs.pixels_mask)
        fields.append(tctx.cache)
        dims.append((tctx.rows, tctx.cols))
    H = max(d[0] for d in dims)
    W = max(d[1] for d in dims)
    canvas = torch.stack([torch.nn.functional.pad(
        c, (0, W - c.shape[1], 0, H - c.shape[0]), value=1.0)
        for c in fields])
    batched = tas.Candidates(*(torch.stack([getattr(c, f.name)
                                            for c in cands])
                               for f in dataclasses.fields(tas.Candidates)))
    rows = torch.tensor([d[0] for d in dims], dtype=torch.int32)
    cols = torch.tensor([d[1] for d in dims], dtype=torch.int32)
    return (batched, torch.stack(pix), torch.stack(masks), canvas, rows, cols,
            jcands)


def test_row_block_scorer_matches_jax_partials():
    cand, pix, mask, canvas, rows, cols, jcands = _lane_candidates((0, 1))
    assert (cand.count > 50).all()          # relock frames
    H = canvas.shape[1]
    bh = -(-H // 3)
    whole = tas.score_candidates_partial(cand, pix, mask, canvas, 0, rows,
                                         cols)
    acc = [torch.zeros_like(p) for p in whole]
    for row0 in range(0, H, bh):
        block = canvas[:, row0:row0 + bh].contiguous()
        got = tas.score_candidates_partial(cand, pix, mask, block, row0,
                                           rows, cols)
        for b in range(2):
            want = jas.score_candidates_partial(
                jcands[b], jnp.asarray(np_(pix[b])), jnp.asarray(np_(mask[b])),
                jnp.asarray(np_(block[b])), row0, int(rows[b]), int(cols[b]))
            n = int(cand.count[b].clamp(max=cand.ca.shape[-1]))
            for g, w in zip(got, want):
                g, w = np_(g[b])[:n], np.asarray(w)[:n]
                if g.dtype.kind == "i":
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        acc = [a + g for a, g in zip(acc, got)]
    for a, w in zip(acc, whole):
        if w.dtype == torch.int32:
            assert torch.equal(a, w)
        else:
            np.testing.assert_allclose(np_(a), np_(w), rtol=1e-12, atol=1e-9)
    with pytest.raises(ValueError, match="col0"):
        tas.score_candidates_partial(cand, pix, mask, canvas, 0, rows, cols,
                                     col0=4)
