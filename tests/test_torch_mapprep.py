"""Map prep of the port (lsdtpu_torch.mapprep) on the CPU in f64 against
the numpy oracle and the JAX package, on test_fuzz_parity's synthetic
maps, and the slice as a whole: the port's prepare_map feeding the
port's rollout.

Tiers:
  * blur bit-exact vs the oracle (lsdtpu/oracle/lsd.py:138), 1e-13 vs
    the JAX package (whose XLA contracts FMAs);
  * gradient, given the same blur: mag, banned, max_grad bit-exact vs
    the oracle; deg within 1e-12 where mag > 1e-8, off the +-pi branch;
  * rectangle fit, refiner, improver fed the same region: 1e-9;
  * the seed walk on the same field: the same n_lines, lines row for row
    with all ten linesInfo columns within 1e-6 px;
  * from the grid the JAX package's FMA blur turns level lines by pi at
    named pixels (ROADMAP.md, Queue 3), so line sets from the grid are
    held at the JAX wave tier's structural thresholds
    (tests/test_fuzz_parity.py:139-142) against the oracle, and the JAX
    package's set (a superset) against the port's; the remapped map is
    identical;
  * prepare_map: map_cache bit-exact;
  * the slice: identical n_candidates and tracked pattern, poses within
    1e-6 px, against the JAX rollout on the same map lines.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.mapprep import lsd as jlsd
from lsdtpu.mapprep import nfa as jnfa
from lsdtpu.mapprep import rect as jrect
from lsdtpu.mapprep.distance import create_map_cache as jcache
from lsdtpu.mapprep.gaussian import gaussian_sampler as jgauss
from lsdtpu.mapprep.gradient import gradient_field as jgrad
from lsdtpu.mapprep.pipeline import prepare_map as jprepare
from lsdtpu.oracle import lsd as olsd
from lsdtpu.runtime import artifacts as jart
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch import geometry as tgeo
from lsdtpu_torch.mapprep import lsd as tlsd
from lsdtpu_torch.mapprep import nfa as tnfa
from lsdtpu_torch.mapprep import rect as trect
from lsdtpu_torch.mapprep.gaussian import gaussian_sampler as tgauss
from lsdtpu_torch.mapprep.gradient import gradient_field as tgrad
from lsdtpu_torch.mapprep.pipeline import prepare_map as tprepare
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.runtime import artifacts as tart
from lsdtpu_torch.runtime import convert
from lsdtpu_torch.runtime import loop as tloop

from test_fuzz_parity import synth_dataset, synth_map
from torch_parity import (assert_lines_close, assert_structural,
                          jax_lines_on_field, np_, port_field, remap)

DEG_THRE = 22.5 / 180.0 * math.pi
SEEDS = (0, 1, 2)


def _blur_in(seed):
    return remap(synth_map(seed)).astype(np.float64)


@pytest.mark.parametrize("seed", SEEDS)
def test_gaussian_bit_exact_vs_oracle(seed):
    img = _blur_in(seed)
    got = tgauss(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, olsd.gaussian_sampler(img, 0.3, 0.6))
    np.testing.assert_allclose(got, np.asarray(jgauss(img)), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("seed", SEEDS)
def test_gradient_vs_oracle(seed):
    g = olsd.gaussian_sampler(_blur_in(seed), 0.3, 0.6)
    mag_o, deg_o, used_o, mg_o = olsd.gradient_field(g, DEG_THRE)
    mag, deg, banned, mg = tgrad(torch.from_numpy(g), DEG_THRE)
    np.testing.assert_array_equal(mag.numpy(), mag_o)
    np.testing.assert_array_equal(banned.numpy(), used_o == 1)
    assert float(mg) == mg_o and torch.is_tensor(mg)
    boundary = (np.abs(deg_o) < 1e-6) | (np.abs(np.abs(deg_o) - np.pi)
                                         < 1e-6)
    real = (mag_o > 1e-8) & ~boundary
    np.testing.assert_allclose(deg.numpy()[real], deg_o[real], rtol=0,
                               atol=1e-12)


def test_jax_blur_turns_level_lines_at_named_pixels():
    """The ulp flip: at pixel (3, 8) of every synth map the reference's
    gx is exactly 0 (level line +pi, snapped to 0), while the JAX
    package's FMA blur leaves gx at -1e-16 and a level line of -pi (to
    an ulp).  The port follows the reference.  Wave growth then takes
    other pixels along the horizontal walls, which is why line sets from
    the grid are compared structurally."""
    for seed in SEEDS:
        img = _blur_in(seed)
        deg = port_field(synth_map(seed))[1].numpy()
        jdeg = np.asarray(jgrad(jgauss(img), DEG_THRE)[1])
        assert deg[3, 8] == 0.0 and abs(jdeg[3, 8] + np.pi) < 1e-15
        flips = np.abs(deg - jdeg) > 1.0
        assert 100 < flips.sum() < 300


def _region(seed, k):
    """The k-th seed's grown region on the port's field of synth map
    ``seed`` (both packages are then fed this same mask)."""
    mag, deg, banned, mg = (np_(x) for x in port_field(synth_map(seed)))
    W = mag.shape[1]
    q = np.minimum(np.floor(mag * (1024 / mg)), 1024.0)
    q = np.where(mag == mg, 1024.0, q)
    live = (q >= 1) & ~banned
    order = np.lexsort((np.arange(q.size), -q.reshape(-1)))
    order = [i for i in order if live.reshape(-1)[i]]
    sy, sx = divmod(int(order[k]), W)
    cur, rd = jlsd._grow(jnp.int32(sy), jnp.int32(sx),
                         jnp.asarray(deg[sy, sx]), DEG_THRE,
                         jnp.asarray(banned), jnp.asarray(deg))
    return (mag, deg, banned), (sy, sx), np.array(cur), float(rd)


@pytest.mark.parametrize("k,den_thre", [(0, 0.7), (3, 0.7), (14, 0.7),
                                         (14, 1.5), (40, 1.5)])
def test_rectangle_converter_and_refiner_match_jax(k, den_thre):
    """The synthetic walls give dense regions; a density threshold of
    1.5 sends them through the refiner's regrowth and radius reducer."""
    (mag, deg, banned), (sy, sx), cur, rd = _region(1, k)
    jrec = jax.tree.map(float, jrect.rectangle_converter(
        jnp.asarray(cur), jnp.asarray(rd), jnp.asarray(mag), 0.125,
        DEG_THRE))
    st = MapPrepStats()
    tm, td = torch.from_numpy(mag), torch.from_numpy(deg)
    trec = trect.rectangle_converter(torch.from_numpy(cur),
                                     torch.tensor(rd, dtype=torch.float64),
                                     tm, 0.125, DEG_THRE, st)
    for key in jrec:
        np.testing.assert_allclose(trec[key], jrec[key], rtol=0, atol=1e-9,
                                   err_msg=key)

    def jgrow(cen, thre):
        return jlsd._grow(jnp.int32(sy), jnp.int32(sx), cen, thre,
                          jnp.asarray(banned), jnp.asarray(deg))

    def tgrow(cen, thre):
        return tlsd._grow(sy, sx, cen, thre, torch.from_numpy(~banned), td,
                          torch.sin(td), torch.cos(td), st)

    jok, jcur, _jrd, jrec2 = jrect.refiner(
        jnp.float64(sx), jnp.float64(sy), jnp.asarray(rd), jnp.asarray(cur),
        jax.tree.map(jnp.asarray, jrec), jnp.asarray(mag), jnp.asarray(deg),
        den_thre, DEG_THRE, jgrow)
    waves = st.waves
    tok, tcur, trec2 = trect.refiner(sx, sy, torch.from_numpy(cur),
                                     int(cur.sum()), trec, tm, td, den_thre,
                                     DEG_THRE, tgrow, st)
    assert (st.waves > waves) == (den_thre > 1.0)     # regrown
    assert bool(jok) == tok
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    for key in jrec2:
        np.testing.assert_allclose(trec2[key], float(jrec2[key]), rtol=0,
                                   atol=1e-9, err_msg=key)
    if not tok:
        return
    log_nt = 5 * (math.log10(mag.shape[0]) + math.log10(mag.shape[1])) / 2
    jn, jr = jax.tree.map(float, jnfa.rectangle_improver(
        jax.tree.map(jnp.asarray, jrec2), jnp.asarray(deg), log_nt))
    tn, tr = tnfa.rectangle_improver(trec2, td, log_nt, st)
    assert (tn > 0) == (jn > 0)
    np.testing.assert_allclose(tn, jn, rtol=1e-12)
    for key in jr:
        np.testing.assert_allclose(tr[key], jr[key], rtol=0, atol=1e-9,
                                   err_msg=key)


def test_radius_reducer_matches_jax():
    """A density threshold no region meets runs the radius reducer until
    fewer than 2 pixels are left."""
    (mag, deg, banned), (sy, sx), cur, rd = _region(1, 3)
    rec_t = trect.rectangle_converter(
        torch.from_numpy(cur), torch.tensor(rd, dtype=torch.float64),
        torch.from_numpy(mag), 0.125, DEG_THRE, MapPrepStats())
    jrec = jrect.rectangle_converter(jnp.asarray(cur), jnp.asarray(rd),
                                     jnp.asarray(mag), 0.125, DEG_THRE)
    jok, jcur, jrec2 = jrect.radius_reducer(
        jnp.float64(sx), jnp.float64(sy), jnp.asarray(rd), jnp.asarray(cur),
        jrec, jnp.asarray(mag), 5.0, DEG_THRE)
    st = MapPrepStats()
    tok, tcur, trec2 = trect.radius_reducer(
        sx, sy, torch.tensor(rd, dtype=torch.float64), torch.from_numpy(cur),
        int(cur.sum()), rec_t, torch.from_numpy(mag), 5.0, DEG_THRE, st)
    assert bool(jok) == tok is False and st.syncs > 2
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    for key in jrec2:
        np.testing.assert_allclose(trec2[key], float(jrec2[key]), rtol=0,
                                   atol=1e-9, err_msg=key)


def test_tree_sum_is_one_fixed_pairwise_order():
    """The rectangle fit's sums add in one order on every device:
    zero-padded to a power of two and halved, bit for bit the same as a
    plain pairwise loop (here on a 7x9 field, padded to 64)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, 9)) * 10.0 ** rng.uniform(-8, 8, (3, 7, 9))
    got = tgeo.tree_sum(torch.from_numpy(x)).tolist()

    def pairwise(v):
        v = list(v) + [0.0] * (64 - len(v))
        while len(v) > 1:
            h = len(v) // 2
            v = [a + b for a, b in zip(v[:h], v[h:])]
        return v[0]

    assert got == [pairwise(row) for row in x.reshape(3, -1).tolist()]
    assert got != [float(r.sum()) for r in torch.from_numpy(x).reshape(3, -1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_walk_on_same_field_matches_jax(seed):
    field = port_field(synth_map(seed))
    want = jax_lines_on_field(field)
    st = MapPrepStats()
    H, W = field[0].shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    ends, n = tlsd._seed_walk(*field, log_nt, 0.3, 22.5, 0.7, 1024, 256, st)
    assert n == len(want) > 4
    e = torch.from_numpy(np.stack(ends))
    got = tloop.geo.lines_info_from_endpoints(e[:, 0], e[:, 1], e[:, 2],
                                              e[:, 3]).numpy()
    assert_lines_close(got, want)
    assert st.seeds > n and st.waves > st.seeds and st.nfa_calls >= n


@pytest.mark.parametrize("seed", SEEDS)
def test_line_segment_detector_from_grid(seed):
    g = synth_map(seed)
    wi, wm, wn, wr = jax.tree.map(np.asarray, jlsd.line_segment_detector(g))
    gi, gm, gn, gr = tlsd.line_segment_detector(g, dtype=torch.float64,
                                                device="cpu")
    assert gi.shape == (256, 10) and gm.shape == (256,)
    assert int(gm.sum()) == gn and not gi[gn:].any()
    np.testing.assert_array_equal(gr.numpy(), wr)
    got = gi.numpy()[:gn]
    # the reference (FIFO growth, the oracle): the JAX package's own wave
    # tier; the JAX package's line set is a superset of the port's
    assert_structural(got, olsd.line_segment_detector(g.copy()).lines_info)
    assert_structural(wi[:int(wn)], got)


def test_line_count_past_the_cap_is_raw():
    g = synth_map(0)
    _, mask, n, _ = tlsd.line_segment_detector(g, max_lines=4,
                                               dtype=torch.float64,
                                               device="cpu")
    assert n > 4 and int(mask.sum()) == 4
    with pytest.raises(ValueError, match="max_lines"):
        tprepare(g, 0.05, max_lines=4, dtype=torch.float64, device="cpu")


def test_prepare_map_cache_and_lines():
    g = synth_map(1)
    art = tprepare(g, 0.05, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(art.map_cache.numpy(),
                                  np.asarray(jcache(jnp.asarray(g), 0.05,
                                                    1.0)))
    gi, _m, gn, _r = tlsd.line_segment_detector(g, dtype=torch.float64,
                                                device="cpu")
    np.testing.assert_array_equal(art.lines_info.numpy(), gi.numpy()[:gn])
    assert_structural(jprepare(g, 0.05).lines_info, art.lines_info.numpy())


def test_prepare_map_f32():
    """The working dtype is taken explicitly; f32 lines stay structural
    against f64."""
    g = synth_map(2)
    a32 = tprepare(g, 0.05, dtype=torch.float32, device="cpu")
    a64 = tprepare(g, 0.05, dtype=torch.float64, device="cpu")
    assert a32.lines_info.dtype == a32.map_cache.dtype == torch.float32
    assert_structural(a32.lines_info.numpy().astype(np.float64),
                      a64.lines_info.numpy())


def test_prepare_map_cached(tmp_path, monkeypatch):
    g = synth_map(0)
    lines, cache = tart.prepare_map_cached(g, 0.05, cache_dir=str(tmp_path),
                                           dtype=torch.float64, device="cpu")
    files = list(tmp_path.iterdir())
    assert len(files) == 1

    def fail(*a, **k):
        raise AssertionError("recomputed")

    monkeypatch.setattr(tart, "prepare_map", fail)
    lines2, cache2 = tart.prepare_map_cached(g, 0.05, cache_dir=str(tmp_path),
                                             dtype=torch.float64,
                                             device="cpu")
    assert torch.equal(lines, lines2) and torch.equal(cache, cache2)
    assert tart._key(g, 0.05, 1.0, torch.float64) != jart._key(
        g, 0.05, 1.0, "tpu", "wave", "xla")
    assert tart._key(g, 0.05, 1.0, torch.float64) != tart._key(
        g, 0.05, 1.0, torch.float32)


def test_unported_growth_and_default_device():
    """FIFO growth runs on the CPU; an unknown growth order raises."""
    g = synth_map(0)
    st = MapPrepStats()
    art = tprepare(g, 0.05, growth="fifo", dtype=torch.float64, device="cpu",
                   stats=st)
    assert art.lines_info.shape[0] > 4 and st.fifo_calls >= st.seeds > 0
    assert st.waves == 0 and st.pops > st.fifo_calls
    with pytest.raises(ValueError, match="growth"):
        tprepare(g, 0.05, growth="bfs", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tprepare(g, 0.05)


def test_map_artifacts_from_numpy():
    ds = synth_dataset(0)
    art = jprepare(ds.map_value, ds.param.resol)
    got = convert.map_artifacts_from_numpy(art.lines_info, art.map_cache,
                                           device="cpu")
    np.testing.assert_array_equal(got.lines_info.numpy(), art.lines_info)
    np.testing.assert_array_equal(got.map_cache.numpy(), art.map_cache)


@pytest.mark.parametrize("growth", ["wave", "fifo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_slice_prepare_map_to_rollout_matches_jax(seed, growth):
    """Grid -> the port's prepare_map -> the port's rollout, against the
    JAX package's seed walk (the same growth order) on the same field,
    its distance field and its rollout."""
    ds = synth_dataset(seed)
    p = ds.param
    art = tprepare(ds.map_value, p.resol, growth=growth, dtype=torch.float64,
                   device="cpu")
    tctx = tloop.make_map_context(art.lines_info, art.map_cache, p.resol,
                                  p.ori_x, p.ori_y, dtype=np.float64,
                                  device="cpu")
    fr = jloop.stack_frames(ds, dtype=np.float64)
    got = {k: np_(v) for k, v in
           tloop.run_sequence(fr, tctx, device="cpu").items()}
    jlines = jax_lines_on_field(port_field(ds.map_value), growth=growth)
    assert_lines_close(art.lines_info.numpy(), jlines)
    jctx = jloop.make_map_context(jlines, np.asarray(jcache(
        jnp.asarray(ds.map_value), p.resol, 1.0)), p.resol, p.ori_x, p.ori_y,
        dtype=np.float64)
    want = jax.tree.map(np.asarray, jloop.run_sequence(fr, jctx))
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    assert fin.sum() >= len(fin) // 2
    nan = np.isnan(want["pose"]).any(1)
    np.testing.assert_array_equal(np.isnan(got["pose"]).any(1), nan)
    np.testing.assert_allclose(got["pose"][~nan], want["pose"][~nan],
                               rtol=0, atol=1e-6)
