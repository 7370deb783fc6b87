"""lsdtpu_torch.match.associate against lsdtpu.match.associate (CPU).

The port's scorer runs its plain PyTorch version here (the CUDA kernel
is held against it on the card by test_torch_cuda.py and chip_smoke.py).
Tiers (f64 unless stated): candidate masks and counts identical,
features within 1e-12 (sin/cos differ by an ulp between XLA and torch);
partial counts exact, partial sums rtol 1e-12 (summation order);
coarse field bitwise; the f32 scorer within rtol/atol 2e-6 of the
Pallas kernel run in interpret mode, with the same finite pattern."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.match import associate as jas
from lsdtpu.ops.score_pallas import score_candidates_pallas
from lsdtpu.scan.featurize import featurize as jfeat
from lsdtpu_torch.io import synth
from lsdtpu_torch.mapprep.distance import create_map_cache
from lsdtpu_torch.match import associate as tas
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import frames, np_, port_candidates, scene

TRACK_POSE = (130.0, 100.0, 0.0)     # near the fuzz scenes' start pose


def _jax_frame(seed, f, dtype, max_pixels=4096):
    """JAX features of frame f and the scene's map artifacts."""
    ds, art = scene(seed)
    fr = frames(seed, dtype)
    p = ds.param
    fs = jfeat(*(jnp.asarray(fr[k][f]) for k in ("ranges", "angles",
                                                  "valid", "n")),
               jnp.asarray(p.resol, dtype), jnp.asarray(p.ori_x, dtype),
               jnp.asarray(p.ori_y, dtype), max_pixels=max_pixels)
    M = 64
    ml = np.zeros((M, 10), dtype)
    ml[:len(art.lines_info)] = art.lines_info
    mm = np.arange(M) < len(art.lines_info)
    return fs, ml, mm, art.map_cache.astype(dtype)


def _jax_cands(fs, ml, mm, last, K, dtype):
    lp = jnp.floor(fs.lidar_pos + 0.5)
    return jas.generate_candidates(
        fs.lines, fs.lines_mask, jnp.asarray(ml), jnp.asarray(mm), lp,
        jnp.asarray(last, dtype), max_candidates=K)


@pytest.mark.parametrize("seed,f,last", [
    (0, 0, (-1.0, -1.0, 0.0)), (1, 0, (-1.0, -1.0, 0.0)),
    (0, 1, TRACK_POSE), (2, 3, TRACK_POSE)])
def test_generate_candidates_matches_jax(seed, f, last):
    fs, ml, mm, _ = _jax_frame(seed, f, np.float64)
    want = _jax_cands(fs, ml, mm, last, 512, jnp.float64)
    t = lambda a: torch.tensor(np_(a))  # noqa: E731
    got = tas.generate_candidates(
        t(fs.lines), t(fs.lines_mask), t(ml), t(mm),
        torch.floor(t(fs.lidar_pos) + 0.5),
        torch.tensor(last, dtype=torch.float64), 512)
    np.testing.assert_array_equal(np_(got.mask), np_(want.mask))
    assert int(got.count) == int(want.count) > 0
    for k in ("ca", "sa", "sx", "sy", "mx", "my", "pose"):
        np.testing.assert_allclose(np_(getattr(got, k)),
                                   np_(getattr(want, k)), rtol=0,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("seed,omd", [(0, None), (1, None), (3, 0.4)])
def test_partials_and_scores_match_jax(seed, omd):
    fs, ml, mm, cache = _jax_frame(seed, 0, np.float64)
    jc = _jax_cands(fs, ml, mm, (-1.0, -1.0, 0.0), 512, jnp.float64)
    H, W = cache.shape
    want = jas.score_candidates_partial(
        jc, fs.pixels, fs.pixels_mask, jnp.asarray(cache), 0, H, W,
        obstacle_min_dist=omd)
    cand = port_candidates(jc)
    pix, pm = torch.as_tensor(np_(fs.pixels)), torch.as_tensor(
        np_(fs.pixels_mask))
    got = tas.score_candidates_partial(cand, pix, pm, torch.as_tensor(cache),
                                       0, H, W, obstacle_min_dist=omd)
    # live slots agree; dead slots are zero in the port (the reference
    # package scores whole chunks, so its dead slots hold don't-cares
    # that finalize_scores masks to inf)
    live = np_(jc.mask)
    for i in (1, 3):
        np.testing.assert_array_equal(np_(got[i])[live], np_(want[i])[live])
    for i in (0, 2):
        np.testing.assert_allclose(np_(got[i])[live], np_(want[i])[live],
                                   rtol=1e-12, atol=1e-12)
        assert not np_(got[i])[~live].any()
    assert np_(got[1]).max() > 0
    # finalize + fuse on top of the partials
    kw = dict(obstacle_tolerance=0.2) if omd else {}
    ws = jas.score_candidates(jc, fs.pixels, fs.pixels_mask,
                              jnp.asarray(cache), obstacle_min_dist=omd, **kw)
    gs = tas.score_candidates(cand, pix, pm, torch.as_tensor(cache),
                              obstacle_min_dist=omd, **kw)
    np.testing.assert_array_equal(np.isfinite(np_(gs)), np.isfinite(np_(ws)))
    fin = np.isfinite(np_(ws))
    np.testing.assert_allclose(np_(gs)[fin], np_(ws)[fin], rtol=1e-12)
    jf = jas.fuse(jc, ws)
    tf = tas.fuse(cand, gs)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("shape,block", [((200, 260), 16), ((979, 1440), 16),
                                         ((37, 53), 8)])
def test_coarse_field_bitwise(shape, block):
    rng = np.random.default_rng(block)
    cache = np.minimum(rng.uniform(0, 1.3, shape), 1.0)
    want = np.asarray(jas.coarse_field(jnp.asarray(cache), block))
    got = tas.coarse_field(torch.as_tensor(cache), block).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def relock_scene():
    """A relock frame with >= 192 candidates (the pruning gate): a
    half-resolution scene at data1's extent, walls as map lines."""
    sc = synth.synth_dataset(1, F=1, H=490, W=720, resol=0.05, rmax=13.0,
                             n_walls=46, clear_m=2.5, wall_scale=1.5)
    ds = sc.dataset
    cache = create_map_cache(ds.map_value, 0.05, 1.0, device="cpu")
    ctx = tloop.make_map_context(synth.wall_lines(sc.walls), cache, 0.05,
                                 ds.param.ori_x, ds.param.ori_y,
                                 dtype=np.float64, device="cpu")
    fr = tloop.stack_frames(ds, dtype=np.float64)
    fs = tloop.featurize_stage(tuple(torch.as_tensor(fr[k][0]) for k in
                                     tloop._FRAME_KEYS), ctx)
    cand = tas.generate_candidates(
        fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
        tloop.geo.c_round(fs.lidar_pos),
        tloop.init_state(torch.float64, "cpu").last_pose, 2048)
    return ctx, fs, cand


def test_pruned_equals_unpruned_on_relock_frame(relock_scene):
    ctx, fs, cand = relock_scene
    assert int(cand.count) >= 192
    coarse = tas.coarse_field(ctx.cache, 16)
    plain = tas.score_candidates(cand, fs.pixels, fs.pixels_mask, ctx.cache)
    pruned = tas.score_candidates(cand, fs.pixels, fs.pixels_mask, ctx.cache,
                                  coarse=coarse, prune_accept=3.0,
                                  prune_min_live=192)
    acc = np_(plain) < 3.0
    assert acc.any() and not acc.all()
    np.testing.assert_array_equal(np_(pruned)[acc], np_(plain)[acc])
    # everything else stays rejected, and the bound did prune
    assert not (np_(pruned)[~acc] < 3.0).any()
    assert np.isinf(np_(pruned)[np_(cand.mask)]).sum() > \
        np.isinf(np_(plain)[np_(cand.mask)]).sum()
    # the same accepted scores from the JAX package's pruned scorer
    jc = jas.Candidates(**{k: jnp.asarray(np_(getattr(cand, k))) for k in
                           ("ca", "sa", "sx", "sy", "mx", "my", "pose",
                            "mask", "count")})
    cj = jnp.asarray(np_(ctx.cache))
    ws = np_(jas.score_candidates_pruned(
        jc, jnp.asarray(np_(fs.pixels)), jnp.asarray(np_(fs.pixels_mask)),
        cj, jas.coarse_field(cj, 16)))
    np.testing.assert_array_equal(ws < 3.0, acc)
    np.testing.assert_allclose(np_(pruned)[acc], ws[acc], rtol=1e-12)


@pytest.mark.parametrize("seed,f,last", [(0, 0, (-1.0, -1.0, 0.0)),
                                         (1, 2, TRACK_POSE)])
def test_f32_scorer_matches_pallas_interpret(seed, f, last):
    fs, ml, mm, cache = _jax_frame(seed, f, np.float32, max_pixels=1024)
    jc = _jax_cands(fs, ml, mm, last, 256, jnp.float32)
    want = np_(score_candidates_pallas(jc, fs.pixels, fs.pixels_mask,
                                       jnp.asarray(cache), interpret=True))
    got = np_(tas.score_candidates(
        port_candidates(jc), torch.as_tensor(np_(fs.pixels)),
        torch.as_tensor(np_(fs.pixels_mask)), torch.as_tensor(cache)))
    assert got.dtype == np.float32
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=2e-6)


def test_fuse_perfect_score_nan_and_floor():
    rng = np.random.default_rng(5)
    K = 16
    pose = rng.normal(size=(K, 3)) * 50
    scores = np.full(K, np.inf)
    scores[:5] = [0.0, 1.0, 2.5, 3.5, 0.7]
    mask = np.arange(K) < 8
    jc = jas.Candidates(*(jnp.zeros(K) for _ in range(6)), jnp.asarray(pose),
                        jnp.asarray(mask), jnp.asarray(8))
    tc = port_candidates(jc)
    for floor in (0.0, 1e-6):
        want = jas.fuse(jc, jnp.asarray(scores), score_floor=floor)
        got = tas.fuse(tc, torch.as_tensor(scores), score_floor=floor)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12,
                                       equal_nan=True)
    assert np.isnan(np_(tas.fuse(tc, torch.as_tensor(scores))[0])).all()
    margins = [0.2, 3.0]
    for m in margins:
        a = tas.relock_ambiguity(tc, torch.as_tensor(scores),
                                 torch.as_tensor(pose[0]), torch.tensor(0.5),
                                 margin=m)
        b = jas.relock_ambiguity(jc, jnp.asarray(scores), jnp.asarray(pose[0]),
                                 jnp.asarray(0.5), margin=m)
        assert bool(a) == bool(b)


def test_unported_options_raise():
    cache = torch.zeros((4, 4))
    for dt in ("bf16", "u16", "u8"):
        with pytest.raises(NotImplementedError):
            tas.quantize_cache(cache, dt)
    with pytest.raises(ValueError):
        tas.quantize_cache(cache, "f16")
    with pytest.raises(NotImplementedError):
        tas.score_candidates(None, None, None, cache, window=64)
