"""Exact FIFO growth of the port (lsdtpu_torch.ops.grow, the FIFO paths
of mapprep/rect.py and mapprep/lsd.py) on the CPU against the JAX
package and the numpy oracle.

The plain versions run here (the CUDA kernels are held against them on
the card by test_torch_cuda.py and chip_smoke.py).  Tiers:
  * grow_fifo vs the JAX _grow_fifo, f64: the same region mask, queue
    (acceptance order) and count; reg_deg within 1e-12 (XLA's and
    torch's CPU sin and atan2 differ by ulps);
  * the FIFO radius reducer vs the JAX radius_reducer_fifo fed the same
    queue, with and without the phantom-slot drop: the same decision
    and mask, the rectangle within 1e-9;
  * from the grid (f64): the numpy oracle's line set, endpoints within
    1e-9 px, in the oracle's order up to the tie order of two seeds of
    equal bin on synth map 2;
  * the seed walk on the port's field: the JAX FIFO seed walk's lines
    row for row (torch_parity.assert_lines_close);
  * f32: structural against f64 (the JAX wave tier's thresholds).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.mapprep import lsd as jlsd
from lsdtpu.mapprep import rect as jrect
from lsdtpu.oracle import lsd as olsd
from lsdtpu.runtime import artifacts as jart
from lsdtpu_torch.mapprep import lsd as tlsd
from lsdtpu_torch.mapprep import rect as trect
from lsdtpu_torch.mapprep.pipeline import prepare_map as tprepare
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import grow as ogrow
from lsdtpu_torch.runtime import artifacts as tart

from test_fuzz_parity import synth_map
from torch_parity import (assert_lines_close, assert_structural,
                          jax_lines_on_field, np_, port_field)

DEG_THRE = 22.5 / 180.0 * math.pi
_jgrow = jax.jit(jlsd._grow_fifo, static_argnames=("cap",))


def _field(seed, H=24, W=32):
    """A level-line field with coherent patches (a few smooth angle
    fields side by side plus noise) and a random ban mask."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    base = rng.uniform(-np.pi, np.pi, 4)
    tilt = rng.uniform(-0.08, 0.08, (4, 2))
    part = (xx * 4 // W).astype(int)
    deg = base[part] + tilt[part, 0] * yy + tilt[part, 1] * xx
    deg = deg + rng.normal(0, 0.15, (H, W))
    deg = (deg + np.pi) % (2 * np.pi) - np.pi
    ban = rng.random((H, W)) < 0.08
    return deg, ban


def _port_growth(sy, sx, thre, ban, deg, dtype=torch.float64):
    d = torch.as_tensor(deg, dtype=dtype)
    return ogrow.grow_fifo(sy, sx, thre, torch.as_tensor(ban), d,
                           torch.sin(d), torch.cos(d))


def _jax_growth(sy, sx, thre, ban, deg):
    cur, rd, qy, qx, n = _jgrow(jnp.int32(sy), jnp.int32(sx),
                                jnp.asarray(deg[sy, sx]), thre,
                                jnp.asarray(ban), jnp.asarray(deg))
    n = int(n)
    return np.asarray(cur), float(rd), np.asarray(qy)[:n], \
        np.asarray(qx)[:n], n


@pytest.mark.parametrize("seed", range(6))
def test_grow_fifo_matches_jax(seed):
    deg, ban = _field(seed)
    rng = np.random.default_rng(100 + seed)
    free = np.argwhere(~ban)
    grown = 0
    for sy, sx in free[rng.choice(len(free), 4, replace=False)]:
        for thre in (DEG_THRE, 0.6):
            g = _port_growth(int(sy), int(sx), thre, ban, deg)
            jcur, jrd, jqy, jqx, jn = _jax_growth(int(sy), int(sx), thre, ban,
                                                  deg)
            n, pops, passes = g.counts.tolist()
            assert n == jn and g.cur.sum() == n
            np.testing.assert_array_equal(g.cur.numpy(), jcur)
            np.testing.assert_array_equal(g.qy[:n].numpy(), jqy)
            np.testing.assert_array_equal(g.qx[:n].numpy(), jqx)
            assert abs(float(g.reg_deg) - jrd) <= 1e-12
            # every pass walks the whole queue; the last adds nothing
            assert passes >= 1 and pops >= n
            grown = max(grown, n)
    assert grown > 20


def test_grow_fifo_on_port_field_matches_jax():
    """Seeds of the LSD's own field (synth map 1), with the NFA-era ban
    of a half-used map."""
    mag, deg, banned, _mg = (np_(x) for x in port_field(synth_map(1)))
    order = np.argsort(-mag, axis=None, kind="stable")[:40:4]
    for flat in order:
        sy, sx = divmod(int(flat), deg.shape[1])
        g = _port_growth(sy, sx, DEG_THRE, banned, deg)
        jcur, jrd, jqy, jqx, jn = _jax_growth(sy, sx, DEG_THRE, banned, deg)
        n = int(g.counts[0])
        assert n == jn
        np.testing.assert_array_equal(g.cur.numpy(), jcur)
        np.testing.assert_array_equal(g.qy[:n].numpy(), jqy)
        np.testing.assert_array_equal(g.qx[:n].numpy(), jqx)
        assert abs(float(g.reg_deg) - jrd) <= 1e-12


def test_grow_fifo_full_flood_and_undersized_cap():
    """The counterpart of test_mapprep.py::
    test_fifo_growth_cap_is_never_silent: a uniform field floods every
    pixel (the cap H*W binds nowhere) and an undersized queue raises."""
    H = W = 16
    deg = np.zeros((H, W))
    ban = np.zeros((H, W), bool)
    g = _port_growth(8, 8, 0.5, ban, deg)
    assert g.counts.tolist() == [H * W, 2 * H * W, 2]
    assert bool(g.cur.all()) and float(g.reg_deg) == 0.0
    d = torch.zeros((H, W), dtype=torch.float64)
    small = (torch.zeros(64, dtype=torch.int32),
             torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="cap"):
        ogrow.grow_fifo(8, 8, 0.5, torch.zeros((H, W), dtype=torch.bool), d,
                        torch.sin(d), torch.cos(d), queue=small)


def test_grow_fifo_rejects_bad_inputs():
    d = torch.zeros((8, 8), dtype=torch.float64)
    ban = torch.zeros((8, 8), dtype=torch.bool)
    s, c = torch.sin(d), torch.cos(d)
    with pytest.raises(ValueError, match="seed"):
        ogrow.grow_fifo(8, 0, 0.4, ban, d, s, c)
    with pytest.raises(TypeError):
        ogrow.grow_fifo(1, 1, 0.4, ban.to(torch.uint8), d, s, c)
    with pytest.raises(TypeError):
        ogrow.grow_fifo(1, 1, 0.4, ban, d.half(), s, c)
    with pytest.raises(ValueError, match="contiguous"):
        ogrow.grow_fifo(1, 1, 0.4, ban, d.t(), s.t(), c.t())


def test_latency_probe_runs_on_the_card_only():
    """The chain bound's latency probe is a card measurement: a CPU
    device raises instead of returning a number."""
    with pytest.raises(ValueError, match="CUDA"):
        ogrow.latency_probe("cpu")


def _reducer_case(seed_yx, den_thre):
    """A region grown on a coherent field from seed_yx, its rectangle,
    and both packages' FIFO radius reducers."""
    H, W = 40, 48
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    deg = 0.3 + 0.004 * xx + rng.normal(0, 0.05, (H, W))
    mag = rng.uniform(0.5, 2.0, (H, W))
    ban = np.zeros((H, W), bool)
    ban[rng.random((H, W)) < 0.3] = True
    sy, sx = seed_yx
    ban[sy, sx] = False
    g = _port_growth(sy, sx, 0.5, ban, deg)
    n = int(g.counts[0])
    st = MapPrepStats()
    tm = torch.as_tensor(mag)
    rec = trect.rectangle_converter(g.cur, g.reg_deg, tm, 0.125, DEG_THRE, st)
    got = trect.radius_reducer_fifo(sx, sy, g.reg_deg, g, n, g.cur, rec, tm,
                                    den_thre, DEG_THRE, st)
    jcur, jrd, jqy, jqx, jn = _jax_growth(sy, sx, 0.5, ban, deg)
    cap = H * W
    jrec = jrect.rectangle_converter(jnp.asarray(jcur), jnp.asarray(jrd),
                                     jnp.asarray(mag), 0.125, DEG_THRE)
    want = jrect.radius_reducer_fifo(
        jnp.int32(sx), jnp.int32(sy), jnp.asarray(jrd),
        jnp.zeros(cap, jnp.int32).at[:jn].set(jqy),
        jnp.zeros(cap, jnp.int32).at[:jn].set(jqx), jnp.int32(jn),
        jnp.asarray(jcur), jrec, jnp.asarray(mag), den_thre, DEG_THRE)
    # the first pass's radius
    rad = 0.75 * max(math.hypot(sx - rec["x1"], sy - rec["y1"]),
                     math.hypot(sx - rec["x2"], sy - rec["y2"]))
    return n, rad, st, got, want


@pytest.mark.parametrize("seed_yx,phantom", [((30, 36), True),
                                             ((0, 0), False)])
@pytest.mark.parametrize("den_thre", [1.2, 50.0])
def test_radius_reducer_fifo_matches_jax(seed_yx, phantom, den_thre):
    """Far from the origin the phantom (0, 0) slot drops the real last
    point every pass (the pixel stays in the region mask); a seed at the
    origin never engages it.  A threshold of 50 shrinks to death, 1.2
    stops at a dense region."""
    n, rad, st, (tok, tcur, trec), (jok, jcur, jrec) = _reducer_case(
        seed_yx, den_thre)
    assert n > 30 and st.reducer_passes >= 1
    assert (math.hypot(*seed_yx) > rad) == phantom
    assert tok == bool(jok) == (den_thre < 10)
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    if tok:
        for key in jrec:
            np.testing.assert_allclose(trec[key], float(jrec[key]), rtol=0,
                                       atol=1e-9, err_msg=key)


def test_radius_reducer_pass_phantom_rule():
    """One pass by hand: the far points leave by swap-with-last (the
    swapped-in point is examined again), then the phantom drop takes the
    real last point off the list and the fit mask only, and clears
    cur[0, 0]; the count is updated in place."""
    H, W = 12, 12
    pts = [(6, 6), (6, 7), (9, 11), (6, 5), (0, 0), (7, 6), (11, 11)]
    qy = torch.tensor([p[0] for p in pts], dtype=torch.int32)
    qx = torch.tensor([p[1] for p in pts], dtype=torch.int32)
    n = torch.tensor([len(pts)], dtype=torch.int32)
    cur = torch.zeros((H, W), dtype=torch.bool)
    for y, x in pts:
        cur[y, x] = True
    fit = cur.clone()
    ogrow.radius_reducer_fifo(6, 6, np.float64(2.5), qy, qx, n, cur, fit)
    # (9, 11) and (11, 11) and (0, 0) are farther than 2.5 from (6, 6)
    assert qy[:4].tolist() == [6, 6, 7, 6] and qx[:4].tolist() == [6, 7, 6, 5]
    assert int(n) == 3                       # 4 kept, the phantom drops one
    assert not fit[6, 5] and cur[6, 5]      # the real last point
    assert not cur[0, 0] and not cur[9, 11] and not cur[11, 11]
    assert int(cur.sum()) == 4 and int(fit.sum()) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_line_segment_detector_fifo_matches_oracle(seed):
    g = synth_map(seed)
    gi, gm, gn, _ = tlsd.line_segment_detector(g, growth="fifo",
                                                dtype=torch.float64,
                                                device="cpu")
    got = gi.numpy()[:gn]
    want = olsd.line_segment_detector(g.copy()).lines_info
    assert len(got) == len(want) > 4
    # each port line is one oracle line (either direction), 1e-9 px
    perm = []
    for row in got:
        d = np.minimum(np.abs(want[:, 4:8] - row[4:8]).max(1),
                       np.abs(want[:, [6, 7, 4, 5]] - row[4:8]).max(1))
        assert d.min() <= 1e-9
        perm.append(int(np.argmin(d)))
    assert sorted(perm) == list(range(len(want)))
    # the order too, up to the oracle's tie order of two equal-bin seeds
    # (the reference package's stable descending order) on synth map 2
    expect = list(range(len(want)))
    if seed == 2:
        expect[:2] = [1, 0]
    assert perm == expect


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_walk_fifo_on_same_field_matches_jax(seed):
    field = port_field(synth_map(seed))
    want = jax_lines_on_field(field, growth="fifo")
    st = MapPrepStats()
    H, W = field[0].shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    ends, n = tlsd._seed_walk(*field, log_nt, 0.3, 22.5, 0.7, 1024, 256, st,
                              growth="fifo")
    assert n == len(want) > 4
    e = torch.from_numpy(np.stack(ends))
    got = tlsd.geo.lines_info_from_endpoints(e[:, 0], e[:, 1], e[:, 2],
                                             e[:, 3]).numpy()
    assert_lines_close(got, want)
    assert st.waves == 0 and st.fifo_calls >= st.seeds > n
    assert st.syncs >= st.fifo_calls + st.seeds


def test_prepare_map_fifo_f32_structural():
    g = synth_map(2)
    a32 = tprepare(g, 0.05, growth="fifo", dtype=torch.float32, device="cpu")
    a64 = tprepare(g, 0.05, growth="fifo", dtype=torch.float64, device="cpu")
    assert a32.lines_info.dtype == torch.float32
    assert_structural(a32.lines_info.numpy().astype(np.float64),
                      a64.lines_info.numpy())


def test_fifo_and_wave_artifacts_are_keyed_apart(tmp_path):
    g = synth_map(0)
    keys = {tart._key(g, 0.05, 1.0, torch.float64, gr) for gr in
            ("wave", "fifo")}
    assert len(keys) == 2
    assert not keys & {jart._key(g, 0.05, 1.0, "tpu", gr, "xla")
                       for gr in ("wave", "fifo")}
    lf, _ = tart.prepare_map_cached(g, 0.05, cache_dir=str(tmp_path),
                                    dtype=torch.float64, device="cpu",
                                    growth="fifo")
    lw, _ = tart.prepare_map_cached(g, 0.05, cache_dir=str(tmp_path),
                                    dtype=torch.float64, device="cpu")
    assert len(list(tmp_path.iterdir())) == 2
    for lines, growth in ((lf, "fifo"), (lw, "wave")):
        want = tprepare(g, 0.05, growth=growth, dtype=torch.float64,
                        device="cpu").lines_info
        assert torch.equal(lines, want)
