"""The NFA slice of the port on the CPU: lsdtpu_torch.ops.nfa (the plain
version of the rect_counts kernel) and lsdtpu_torch.mapprep.nfa against
lsdtpu.ops.nfa_pallas / lsdtpu.mapprep.nfa, and the port's LSD against
the reference package's on tests/test_nfa_pallas.py's two-wall grid.

Tiers: packed scalars bitwise; counts equal; -log10 NFA within rel
1e-12 with identical > 0 decisions; improved rectangles within 1e-9;
the two-wall line set row for row within 1e-6 px on the same field,
structural from the grid."""

import math

import jax
import numpy as np
import pytest
import torch

from lsdtpu.mapprep import nfa as jnfa
from lsdtpu.mapprep.gaussian import gaussian_sampler as jgauss
from lsdtpu.mapprep.gradient import gradient_field as jgrad
from lsdtpu.mapprep.lsd import line_segment_detector as jlsd
from lsdtpu.ops import nfa_pallas as jops
from lsdtpu.oracle import lsd as olsd
from lsdtpu_torch.mapprep import nfa as tnfa
from lsdtpu_torch.mapprep.lsd import line_segment_detector as tlsd
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import nfa as tops

from torch_parity import (assert_structural, jax_lines_on_field,
                          port_field, remap)
from test_nfa_pallas import _random_rects


@pytest.fixture(scope="module")
def deg_map():
    rng = np.random.default_rng(42)
    return rng.uniform(-math.pi, math.pi, size=(48, 72))


def _port_rec(rec):
    return {k: np.float64(v) for k, v in rec.items()}


def _rects(deg_map, seed=0):
    H, W = deg_map.shape
    return _random_rects(H, W, seed=seed)


def test_rects_cover_degenerate_cases(deg_map):
    recs = _rects(deg_map)
    assert len(recs) == 27
    with np.errstate(all="ignore"):
        sc = np.stack([tnfa.pack_rect_scalars(_port_rec(r)) for r in recs])
    assert not np.isfinite(sc[:, 10:14]).all()   # vertical/horizontal edges


def test_packed_scalars_bitwise(deg_map):
    for rec in _rects(deg_map):
        want = np.asarray(jnfa.pack_rect_scalars(jax.tree.map(np.float64,
                                                              rec)))
        with np.errstate(all="ignore"):
            got = tnfa.pack_rect_scalars(_port_rec(rec))
        np.testing.assert_array_equal(got, want)


def test_counts_equal_jax_batched(deg_map):
    """All 27 rectangles (vertical, horizontal, out of the image) in one
    call of the plain version, against rect_counts_math one by one."""
    count = jax.jit(lambda d, s: jops.rect_counts_math(
        d, [s[i] for i in range(jops.N_SCALARS)]))
    recs = _rects(deg_map)
    sc = np.stack([np.asarray(jnfa.pack_rect_scalars(
        jax.tree.map(np.float64, r))) for r in recs])
    want = np.array([[float(v) for v in count(deg_map, s)] for s in sc])
    a, b = tops.rect_counts_reference(torch.from_numpy(deg_map),
                                      torch.from_numpy(sc))
    assert a.dtype == b.dtype == torch.int32 and a.shape == (27,)
    np.testing.assert_array_equal(a.numpy(), want[:, 0])
    np.testing.assert_array_equal(b.numpy(), want[:, 1])
    assert (want[:, 0] > 0).sum() >= 20 and (want[:, 1] > 0).any()


def test_counts_f32_equal_jax(deg_map):
    """The same in float32: the column bounds round op by op in f32."""
    d32 = deg_map.astype(np.float32)
    count = jax.jit(lambda d, s: jops.rect_counts_math(
        d, [s[i] for i in range(jops.N_SCALARS)]))
    recs = _rects(deg_map, seed=3)
    sc = np.stack([np.asarray(jnfa.pack_rect_scalars(
        jax.tree.map(np.float32, r))) for r in recs]).astype(np.float32)
    want = np.array([[float(v) for v in count(d32, s)] for s in sc])
    a, b = tops.rect_counts_reference(torch.from_numpy(d32),
                                      torch.from_numpy(sc))
    np.testing.assert_array_equal(a.numpy(), want[:, 0])
    np.testing.assert_array_equal(b.numpy(), want[:, 1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("row0,block,n_rows", [
    (0, 48, None), (16, 16, 48), (32, 16, 48), (20, 24, 37), (40, 16, 44),
    (5, 11, 9)])
def test_row_block_counts_equal_jax(deg_map, dtype, row0, block, n_rows):
    """rect_counts over a row block (row0, n_rows: the sharded map prep's
    per-rank counts; blocks that cross n_rows and blocks past it) against
    rect_counts_math with the same row0/n_rows, counts equal; and the
    blocks of a field add up to its whole-field counts."""
    d = deg_map.astype(dtype)
    count = jax.jit(lambda d, s, r0, nr: jops.rect_counts_math(
        d, [s[i] for i in range(jops.N_SCALARS)], r0, nr))
    recs = _rects(deg_map, seed=5)
    sc = np.stack([np.asarray(jnfa.pack_rect_scalars(
        jax.tree.map(dtype, r))) for r in recs]).astype(dtype)
    blk = d[row0:row0 + block]
    nr = 48 if n_rows is None else n_rows
    want = np.array([[float(v) for v in count(blk, x, row0, nr)]
                     for x in sc])
    a, b = tops.rect_counts(torch.from_numpy(blk), torch.from_numpy(sc),
                            row0, n_rows)
    np.testing.assert_array_equal(a.numpy(), want[:, 0])
    np.testing.assert_array_equal(b.numpy(), want[:, 1])
    # the blocks of the first nr rows add up to that field's counts
    parts = [tops.rect_counts(torch.from_numpy(d[r:r + block]),
                              torch.from_numpy(sc), r, nr)
             for r in range(0, 48, block)]
    whole = tops.rect_counts(torch.from_numpy(d[:nr]), torch.from_numpy(sc))
    for i in range(2):
        assert torch.equal(sum(p[i] for p in parts), whole[i])


def test_wrapper_routes_cpu_to_plain_and_checks_inputs(deg_map):
    d = torch.from_numpy(deg_map)
    with np.errstate(all="ignore"):
        sc = torch.from_numpy(np.stack([tnfa.pack_rect_scalars(_port_rec(r))
                                        for r in _rects(deg_map)]))
    before = tops.rect_counts.launches
    got = tops.rect_counts(d, sc)
    want = tops.rect_counts_reference(d, sc)
    assert tops.rect_counts.launches == before   # no kernel on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        tops.rect_counts(d, sc.float())
    with pytest.raises(TypeError):
        tops.rect_counts(d.to(torch.int32), sc)
    with pytest.raises(ValueError):
        tops.rect_counts(d, sc[:, :15].contiguous())
    with pytest.raises(ValueError):
        tops.rect_counts(d.t(), sc)


def test_log_gamma_matches_jax():
    x = np.array([0.5, 1.0, 2.0, 7.5, 14.9, 15.0, 15.1, 40.0, 1e3, 5e4])
    want = np.asarray(jnfa.log_gamma(jax.numpy.asarray(x)))
    np.testing.assert_allclose(tnfa.log_gamma(x), want, rtol=1e-13)


@pytest.mark.parametrize("seed", [7, 11])
def test_rectangle_nfa_matches_jax(deg_map, seed):
    H, W = deg_map.shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    f = jax.jit(lambda r, d: jnfa.rectangle_nfa(r, d, log_nt))
    recs = _rects(deg_map, seed=seed)
    want = [float(f(jax.tree.map(np.float64, r), deg_map)) for r in recs]
    got = tnfa.rectangles_nfa([_port_rec(r) for r in recs],
                              torch.from_numpy(deg_map), log_nt,
                              MapPrepStats())
    for g, w, r in zip(got, want, recs):
        if math.isnan(w):
            assert math.isnan(g), r
            continue
        assert (g > 0) == (w > 0), r
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=str(r))


def test_binom_tail_branches_match_jax():
    """Every branch of the tail: edge cases, the tiny-term shortcut and
    the summed tail with its early exit."""
    log_nt = 12.0
    f = jax.jit(lambda a, b, p: jnfa._binom_tail_nfa(a, b, p, log_nt))
    for a, b, p in [(0, 0, 0.125), (40, 0, 0.125), (40, 40, 0.125),
                    (400, 390, 0.125), (300, 60, 0.125), (50, 7, 0.125),
                    (900, 200, 0.0625), (12, 3, 0.03125)]:
        w = float(f(np.float64(a), np.float64(b), np.float64(p)))
        g = tnfa._binom_tail_nfa(np.float64(a), np.float64(b), np.float64(p),
                                 log_nt)
        np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=str((a, b, p)))


def test_rectangle_improver_matches_jax(deg_map):
    """The greedy improver with the phases batched per rect_counts call
    reaches the reference package's NFA and rectangle; the launch count
    is one initial call plus at most one per phase."""
    H, W = deg_map.shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    f = jax.jit(lambda r, d: jnfa.rectangle_improver(r, d, log_nt))
    n_phases = 0
    for rec in _rects(deg_map, seed=5)[:10]:
        rec = dict(rec, wid=max(rec["wid"], 3.0))
        w_nfa, w_rec = jax.tree.map(float, f(jax.tree.map(np.float64, rec),
                                             deg_map))
        st = MapPrepStats()
        g_nfa, g_rec = tnfa.rectangle_improver(_port_rec(rec),
                                               torch.from_numpy(deg_map),
                                               log_nt, st)
        assert (g_nfa > 0) == (w_nfa > 0)
        np.testing.assert_allclose(g_nfa, w_nfa, rtol=1e-12)
        for k in w_rec:
            np.testing.assert_allclose(g_rec[k], w_rec[k], rtol=0, atol=1e-9,
                                       err_msg=k)
        assert 1 <= st.nfa_calls <= 6 and st.nfa_rects <= 26
        n_phases += st.nfa_calls - 1
    assert n_phases > 0          # the phases ran, batched


def _two_wall_grid():
    grid = np.full((120, 160), 255, np.uint8)
    grid[30, 20:140] = 1
    grid[30:100, 140] = 1
    grid[0, :] = 0
    return grid


def test_lsd_two_wall_grid_matches_jax():
    """On the same field the two seed walks give the same lines, row for
    row; from the grid the line sets are held structurally, because the
    reference package's blur differs from the reference's by FMA ulps
    and that flips the level-line branch at named pixels (ROADMAP.md,
    Queue 3)."""
    grid = _two_wall_grid()
    st = MapPrepStats()
    gi, gm, gn, gr = tlsd(grid, max_lines=32, dtype=torch.float64,
                          device="cpu", stats=st)
    gi = gi.numpy()[:gn]
    np.testing.assert_array_equal(gr.numpy(), remap(grid))
    want = jax_lines_on_field(port_field(grid), max_lines=32)
    assert gn == len(want) == 4
    np.testing.assert_allclose(gi, want, rtol=0, atol=1e-6)
    assert st.nfa_calls >= gn and st.seeds > 0 and st.waves > st.seeds
    # from the grid: the reference's level line at (10, 10) is the
    # reference package's turned by pi
    wi, wm, wn, wr = jax.tree.map(np.asarray, jlsd(grid, max_lines=32))
    np.testing.assert_array_equal(wr, gr.numpy())
    deg_thre = 22.5 / 180 * math.pi
    deg = port_field(grid)[1].numpy()
    jdeg = np.asarray(jgrad(jgauss(remap(grid).astype(np.float64)),
                            deg_thre)[1])
    odeg = olsd.gradient_field(olsd.gaussian_sampler(
        remap(grid).astype(np.float64), 0.3, 0.6), deg_thre)[1]
    assert deg[10, 10] == odeg[10, 10]
    assert abs(jdeg[10, 10] - odeg[10, 10]) == math.pi
    assert_structural(gi, wi[:int(wn)])
