"""Batched rollouts against the port's own single-lane paths (CPU):
each lane of lsdtpu_torch.runtime.batch.run_batch against run_sequence
of that lane alone, padded frames, NaN-lane isolation, corpus replay
(stack_concat), featurize over lanes, and the lane-batched CalcScore
entry's plain version (ops/score.py:score_partials_batched).

Tiers: each lane against its solo run_sequence, identical decisions and
poses within 1e-9 px - not bitwise: torch's CPU batched matmuls with an
inner dimension of 3 (in the UKF) add in another order than the
single-lane products (~1e-10 px after 10 frames; on the card they are
bitwise, tests/test_torch_cuda.py).  Lanes of one batch against lanes
of another batch of the same shapes, padded frames, corpus replay and
the featurized scans: bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.ops import score as osc
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.scan.featurize import featurize

from torch_parity import (LANES, batch_contexts, lane_scenes, np_, scene,
                          solo_context)

DECISIONS = ("n_candidates", "candidate_overflow", "n_scan_lines",
             "coasting", "relock_deferred")


def _cfgs(**match):
    return tuple(dataclasses.replace(c, match=dataclasses.replace(
        c.match, **match)) for c in (JDEFAULT, DEFAULT))


@pytest.mark.parametrize("polish", [False, True])
def test_lanes_match_solo_run_sequence(polish):
    """Each lane of the batch against run_sequence of that lane's scene
    alone, with and without the pose polish (per-lane rows/cols in the
    bilinear support test): identical decisions, poses within 1e-9 px
    (not bitwise: the UKF's batched matmuls, see the module
    docstring)."""
    _j, cfg = _cfgs(polish_pose=polish)
    _, (fr, ctx, lens) = batch_contexts()
    got = {k: np_(v) for k, v in
           tbatch.run_batch(fr, ctx, cfg, device="cpu").items()}
    dss, arts = lane_scenes()
    for b, (ds, art) in enumerate(zip(dss, arts)):
        solo = {k: np_(v) for k, v in tloop.run_sequence(
            tloop.stack_frames(ds, dtype=np.float64), solo_context(ds, art),
            cfg, device="cpu").items()}
        L = lens[b]
        for k in DECISIONS:
            np.testing.assert_array_equal(got[k][b, :L], solo[k], err_msg=k)
        np.testing.assert_array_equal(np.isfinite(got["score"][b, :L]),
                                      np.isfinite(solo["score"]))
        np.testing.assert_allclose(got["pose"][b, :L], solo["pose"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["score"][b, :L], solo["score"],
                                   rtol=0, atol=1e-9)


def test_padded_frames_cut_to_length_equal_unpadded_run():
    """A ragged batch (10 and 7 frames) cut to the shorter length equals
    the batch of the same lanes cut to 7 frames before padding (no
    padding frame), bit for bit; the padding frames (n = 0) run."""
    lanes = (LANES[0], LANES[2])
    _, (fr, ctx, lens) = batch_contexts(lanes)
    assert list(lens) == [10, 7] and not fr["valid"][1, 7:].any()
    padded = tbatch.run_batch(fr, ctx, device="cpu")
    _, (fr7, ctx7, lens7) = batch_contexts(lanes, max_frames=7)
    assert list(lens7) == [7, 7]
    short = tbatch.run_batch(fr7, ctx7, device="cpu")
    for k in padded:
        torch.testing.assert_close(padded[k][:, :7], short[k], rtol=0,
                                   atol=0, equal_nan=True, msg=k)
    # a padding frame finds no candidate: the reset state, no score
    assert (np_(padded["n_candidates"])[1, 7:] == 0).all()
    assert np.isinf(np_(padded["score"])[1, 7:]).all()


def test_nan_lane_isolation():
    """The perfect-score NaN chain (seed 101) in lane 0 leaves lane 1
    (seed 100) bitwise equal to lane 1 of a clean-twin batch (the
    counterpart of tests/test_fuzz_parity.py:226)."""
    lanes_nan = ((101, 200, 260, 10), (100, 200, 260, 10))
    lanes_ok = ((100, 200, 260, 10), (100, 200, 260, 10))
    outs = []
    for lanes in (lanes_nan, lanes_ok):
        _, (fr, ctx, _l) = batch_contexts(lanes)
        outs.append({k: np_(v) for k, v in
                     tbatch.run_batch(fr, ctx, device="cpu").items()})
    with_nan, clean = outs
    assert np.isnan(with_nan["pose"][0]).any()
    assert np.isfinite(clean["pose"]).all()
    for k in with_nan:
        np.testing.assert_array_equal(with_nan[k][1], clean[k][1], err_msg=k)


def _split(ds, bounds):
    """Datasets of consecutive frame ranges of one sequence (one map)."""
    return [dataclasses.replace(ds, frames=ds.frames[a:b],
                                odom=ds.odom[a:b + 1])
            for a, b in zip(bounds[:-1], bounds[1:])]


def test_stack_concat_equals_standalone_rollouts():
    """Corpus replay of three sequences sharing one map: each slice of
    the concatenated rollout is bitwise its standalone rollout (the
    counterpart of tests/test_runtime_parallel.py:95)."""
    ds, art = scene(0)
    seqs = _split(ds, [0, 4, 7, 10])
    ctx = solo_context(ds, (art.lines_info, art.map_cache))
    frames, bounds = tbatch.stack_concat(seqs, dtype=np.float64)
    assert list(bounds) == [0, 4, 7, 10]
    assert frames["reset"].tolist() == [1, 0, 0, 0, 1, 0, 0, 1, 0, 0]
    outs = tloop.run_sequence(frames, ctx, device="cpu")
    for i, s in enumerate(seqs):
        alone = tloop.run_sequence(tloop.stack_frames(s, dtype=np.float64),
                                   ctx, device="cpu")
        for k in alone:
            torch.testing.assert_close(outs[k][bounds[i]:bounds[i + 1]],
                                       alone[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)


def test_featurize_lanes_equal_single_scans():
    """featurize over (B, N) lanes equals each scan featurized alone, bit
    for bit, with the RDP rounds run until no lane changed; an empty
    lane (n = 0) runs."""
    dss, _ = lane_scenes()
    fr = [tloop.stack_frames(d, dtype=np.float64) for d in dss]
    rows = [(0, 0), (1, 3), (2, 6)]
    t = torch.as_tensor

    def inputs(f, i):
        return (t(fr[f]["ranges"][i]), t(fr[f]["angles"][i]),
                t(fr[f]["valid"][i]), t(fr[f]["n"][i]))

    lane_in = [inputs(f, i) for f, i in rows]
    empty = tuple(torch.zeros_like(x) for x in lane_in[0])
    lane_in.append(empty)
    stacked = [torch.stack(x) for x in zip(*lane_in)]
    geo = [torch.tensor(v, dtype=torch.float64) for v in (0.05, -2.0, -1.5)]
    got = featurize(*stacked, *(g.expand(4) for g in geo))
    for b, x in enumerate(lane_in):
        want = featurize(*x, *geo)
        for f in dataclasses.fields(want):
            torch.testing.assert_close(getattr(got, f.name)[b],
                                       getattr(want, f.name), rtol=0,
                                       atol=0, equal_nan=True,
                                       msg=f"lane {b} {f.name}")
    assert int(got.lines_mask[3].sum()) == 0


def test_batched_plain_kernel_equals_per_lane_reference():
    """score_partials_batched on CPU tensors (its plain version) against
    B calls of score_partials_reference, bit for bit, on lanes whose
    fields are smaller than the canvas (rows/cols per lane), with and
    without survivor lists."""
    rng = np.random.default_rng(3)
    B, K, P, H, W = 3, 40, 300, 50, 64
    rows = torch.tensor([50, 41, 37], dtype=torch.int32)
    cols = torch.tensor([64, 60, 33], dtype=torch.int32)
    th = rng.uniform(-np.pi, np.pi, (B, K))
    cand = torch.from_numpy(np.stack([
        np.cos(th), np.sin(th), rng.uniform(20, 40, (B, K)),
        rng.uniform(20, 40, (B, K)), rng.uniform(0, 60, (B, K)),
        rng.uniform(0, 50, (B, K))], 1)).contiguous()
    px = torch.from_numpy(rng.uniform(0, 60, (B, P)))
    py = torch.from_numpy(rng.uniform(0, 60, (B, P)))
    cache = torch.from_numpy(rng.uniform(0, 1.2, (B, H, W)).clip(max=1.0))
    n_cand = torch.tensor([40, 7, 0], dtype=torch.int32)
    n_pix = torch.tensor([300, 120, 5], dtype=torch.int32)
    idx = torch.from_numpy(np.stack([rng.permutation(K) for _ in range(B)])
                           .astype(np.int32))
    for sel in (None, idx):
        got = osc.score_partials_batched(cand, sel, n_cand, px, py, n_pix,
                                         cache, rows, cols, 1.0, 10.0, 0.8)
        for b in range(B):
            want = osc.score_partials_reference(
                cand[b], None if sel is None else sel[b], n_cand[b], px[b],
                py[b], n_pix[b], cache[b], 0, int(rows[b]), int(cols[b]),
                1.0, 10.0, 0.8)
            for g, w in zip(got, want):
                assert torch.equal(g[b], w)
        assert not got[1][2].any()           # a lane with no live slot
    assert osc.score_partials_batched.launches == 0   # no kernel on CPU
    with pytest.raises(ValueError):
        osc.score_partials_batched(cand[0], None, n_cand, px, py, n_pix,
                                   cache, rows, cols, 1.0, 10.0, 0.8)


def test_batch_entry_points_default_to_the_card():
    _, (fr, ctx, _l) = batch_contexts()
    if torch.cuda.is_available():
        return
    dss, arts = lane_scenes()
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.stack_batch(dss, arts)
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.run_batch(fr, ctx)
    with pytest.raises(ValueError, match="batched"):
        tbatch.run_batch(fr, solo_context(dss[0], arts[0]), device="cpu")
    with pytest.raises(ValueError, match="max_map_lines"):
        tbatch.batch_context([(np.zeros((300, 10)), arts[0][1])],
                             [(0.05, 0.0, 0.0)], device="cpu")
