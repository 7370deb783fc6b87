"""Windowed scoring (match.score_window) of the port against its own
unwindowed scorer and the JAX package, on the CPU.

The scene: a short-range synthetic sequence at half data1's extent
(490x720 cells at 0.05 m/px, 6 m scans; lsdtpu_torch/io/synth.py), so a
tracking frame's scan radius fits a 384-px window and the window is
really used.  Tiers: windowed scores bitwise equal to the unwindowed
ones (the same pixels in the same order); f64 scores within rtol 1e-12
of the JAX package's windowed scorer, the same finite pattern; an
undersized window falls back; rollouts with and without the window
bitwise equal, with the window engaged."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.match import associate as jas
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.io import synth
from lsdtpu_torch.mapprep.distance import create_map_cache
from lsdtpu_torch.match import associate as tas
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import np_

WINDOW = 384


@pytest.fixture(scope="module")
def short_range():
    sc = synth.synth_dataset(2, F=6, H=490, W=720, resol=0.05, rmax=6.0,
                             n_walls=46, clear_m=2.5, wall_scale=1.5)
    ds = sc.dataset
    cache = create_map_cache(ds.map_value, 0.05, 1.0, device="cpu")
    return sc, cache


def _ctx(sc, cache, mode="f32", dtype=np.float64):
    p = sc.dataset.param
    return tloop.make_map_context(synth.wall_lines(sc.walls), cache, p.resol,
                                  p.ori_x, p.ori_y, dtype=dtype,
                                  cache_dtype=mode, device="cpu")


def _cfg(**kw):
    return dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, **kw))


def _tracking_frames(sc, ctx, n=3):
    """(features, candidates, last_pose) of tracking frames 1..n, the
    state from the port's own rollout step."""
    fr = tloop.stack_frames(sc.dataset, dtype=np.float64)
    state = tloop.init_state(torch.float64, "cpu")
    coarse = tloop.prepare_coarse(ctx)
    out = []
    for f in range(n + 1):
        inp = tuple(torch.as_tensor(fr[k][f]) for k in tloop._FRAME_KEYS)
        if f >= 1:
            fs = tloop.featurize_stage(inp, ctx)
            cand = tas.generate_candidates(
                fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
                tloop.geo.c_round(fs.lidar_pos), state.last_pose, 2048)
            out.append((fs, cand, state.last_pose))
        state, _ = tloop.localization_step(state, inp, ctx, coarse=coarse)
    return out


def _scan_radius(fs):
    lp = tloop.geo.c_round(fs.lidar_pos)
    dx = fs.pixels[:, 0].double() - lp[0]
    dy = fs.pixels[:, 1].double() - lp[1]
    return torch.where(fs.pixels_mask, (dx * dx + dy * dy).sqrt(), 0.0).amax()


@pytest.mark.parametrize("mode", ["f32", "u16"])
def test_window_engages_and_scores_equal(short_range, mode):
    sc, cache = short_range
    ctx = _ctx(sc, cache, mode)
    jcache = jnp.asarray(np_(ctx.cache)) if mode == "f32" else \
        jas.quantize_cache(np_(cache), "u16", 1.0)
    for fs, cand, last in _tracking_frames(sc, ctx):
        r_s = _scan_radius(fs)
        fits, row0, col0 = tas.window_origin(WINDOW, last[:2], r_s, 60.0,
                                             ctx.rows, ctx.cols)
        assert fits and (row0, col0) != (0, 0) and int(cand.count) > 0
        kw = dict(rows=ctx.rows, cols=ctx.cols)
        plain = tas.score_candidates(cand, fs.pixels, fs.pixels_mask,
                                     ctx.cache, **kw)
        wind = tas.score_candidates(cand, fs.pixels, fs.pixels_mask,
                                    ctx.cache, window=WINDOW,
                                    window_center=last[:2], scan_radius=r_s,
                                    **kw)
        assert torch.equal(wind, plain)
        assert torch.isfinite(plain).any()
        jc = jas.Candidates(**{k: jnp.asarray(np_(getattr(cand, k))) for k in
                               ("ca", "sa", "sx", "sy", "mx", "my", "pose",
                                "mask", "count")})
        want = np_(jas.score_candidates(
            jc, jnp.asarray(np_(fs.pixels)), jnp.asarray(np_(fs.pixels_mask)),
            jcache, rows=ctx.rows, cols=ctx.cols, window=WINDOW,
            window_center=jnp.asarray(np_(last[:2])),
            scan_radius=jnp.asarray(float(r_s))))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(np_(wind)), fin)
        np.testing.assert_allclose(np_(wind)[fin], want[fin], rtol=1e-12)


def test_partials_of_a_window_view_equal_the_field(short_range):
    """score_candidates_partial on the window (a strided view, read in
    place) gives the partials of a contiguous copy of it, and those of
    the whole field: the window holds every in-map pixel of the gated
    candidates."""
    sc, cache = short_range
    ctx = _ctx(sc, cache)
    fs, cand, last = _tracking_frames(sc, ctx, n=1)[0]
    fits, r0, c0 = tas.window_origin(WINDOW, last[:2], _scan_radius(fs), 60.0,
                                     ctx.rows, ctx.cols)
    assert fits and r0 > 0 and c0 > 0
    win = ctx.cache[r0:r0 + WINDOW, c0:c0 + WINDOW]
    assert not win.is_contiguous()
    full = tas.score_candidates_partial(cand, fs.pixels, fs.pixels_mask,
                                        ctx.cache, 0, ctx.rows, ctx.cols)
    part = tas.score_candidates_partial(cand, fs.pixels, fs.pixels_mask, win,
                                        r0, ctx.rows, ctx.cols, col0=c0)
    copy = tas.score_candidates_partial(cand, fs.pixels, fs.pixels_mask,
                                        win.contiguous(), r0, ctx.rows,
                                        ctx.cols, col0=c0)
    for a, b, c in zip(part, copy, full):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(part[1].max()) > 0


def test_undersized_window_falls_back(short_range):
    sc, cache = short_range
    ctx = _ctx(sc, cache)
    fs, cand, last = _tracking_frames(sc, ctx, n=1)[0]
    r_s = _scan_radius(fs)
    fits, _r, _c = tas.window_origin(128, last[:2], r_s, 60.0, ctx.rows,
                                     ctx.cols)
    assert not fits
    # relock frames fall back through the centre's -1 sentinel
    sentinel = torch.tensor([-1.0, -1.0], dtype=torch.float64)
    assert not tas.window_origin(WINDOW, sentinel, r_s * 0, 60.0, ctx.rows,
                                 ctx.cols)[0]
    kw = dict(rows=ctx.rows, cols=ctx.cols)
    assert torch.equal(
        tas.score_candidates(cand, fs.pixels, fs.pixels_mask, ctx.cache,
                             window=128, window_center=last[:2],
                             scan_radius=r_s, **kw),
        tas.score_candidates(cand, fs.pixels, fs.pixels_mask, ctx.cache, **kw))


@pytest.mark.parametrize("mode,window", [("u16", WINDOW), ("f32", 128)])
def test_windowed_rollout_equals_unwindowed(short_range, monkeypatch, mode,
                                            window):
    sc, cache = short_range
    ctx = _ctx(sc, cache, mode, dtype=np.float32)
    fr = tloop.stack_frames(sc.dataset, dtype=np.float32)
    decided = []
    origin = tas.window_origin

    def record(*a, **k):
        decided.append(origin(*a, **k)[0])
        return origin(*a, **k)

    monkeypatch.setattr(tas, "window_origin", record)
    ow = tloop.run_sequence(fr, ctx, _cfg(cache_dtype=mode,
                                          score_window=window), device="cpu")
    on = tloop.run_sequence(fr, ctx, _cfg(cache_dtype=mode), device="cpu")
    for k in ("pose", "score", "n_candidates", "measurement"):
        torch.testing.assert_close(ow[k], on[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    assert torch.isfinite(on["score"]).sum() >= 4
    # one decision a frame on the plain path (the relock frame's sweep
    # takes the pruned path); engaged only when the window fits
    assert 0 < len(decided) <= fr["ranges"].shape[0]
    assert any(decided) == (window == WINDOW)
