"""The launch plans of the port's two CUDA kernels, on the CPU.

CalcScore (csrc/score.cu): ``ops/score.py:plan`` sizes the persistent
grid from the caps and ``split`` is how the kernel shares the live work
out.  The grid never exceeds the resident blocks, every live slot goes
to exactly one block and every live pixel to exactly one thread, rounds
start on 16-byte boundaries, and the per-pixel contributions added in
the kernel's order equal the plain version (counts exact, f64 sums to
1e-12); the kernel's C-round thresholds equal C-round.

NFA (csrc/nfa.cu): a plain torch mirror of the kernel's decomposition -
per-column clipped heights, their inclusive scan over column tiles of
the block's width, the flat covered index mapped back to (column, row) by
a binary search - equals ``rect_counts_reference`` on hypothesis-drawn
rectangles (out of the image, degenerate, non-finite slopes and scalars)
and on the random rectangles of tests/test_nfa_pallas.py."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.mapprep import nfa as tnfa
from lsdtpu_torch.ops import nfa as onfa
from lsdtpu_torch.ops import score as osc

from test_nfa_pallas import _random_rects

H100_SMS = 132


# --- CalcScore ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,P,n_sm", [(2048, 4096, H100_SMS),
                                      (4096, 4096, H100_SMS),
                                      (21, 300, H100_SMS), (8, 4096, 1),
                                      (1, 1, 7), (16384, 9000, 114)])
def test_score_plan_grid(K, P, n_sm, dtype):
    pl = osc.plan(K, P, n_sm, dtype)
    assert pl.blocks_per_sm == osc.RESIDENT[dtype]
    # persistent: never more blocks than the SMs keep resident at once,
    # nor than the slots
    assert 1 <= pl.grid <= min(n_sm * pl.blocks_per_sm, K)
    assert pl.rounds * osc.HELD >= P > (pl.rounds - 1) * osc.HELD
    with pytest.raises(ValueError):
        osc.plan(K, osc.MAX_PIXELS, n_sm, dtype)


@pytest.mark.parametrize("grid", [1, 21, 528, 264])
@pytest.mark.parametrize("n_live,n_pix", [(0, 1852), (21, 0), (21, 1852),
                                          (325, 1954), (1072, 1954),
                                          (4011, 2001), (3, 4096), (9, 2049),
                                          (1, 1), (17, 9001)])
def test_score_split_covers_each_pair_once(grid, n_live, n_pix):
    slots, pixels = osc.split(grid, n_live, n_pix)
    got = sorted(b for blk in slots for b in blk)
    assert got == list(range(n_live))          # each slot in one block
    flat = sorted(i for th in pixels for i in th)
    assert flat == list(range(n_pix))          # each pixel in one thread
    for th in pixels:
        assert th == sorted(th)                # a thread adds in order
        # a round starts on a 16-byte boundary of either working type,
        # and a warp's 32 threads read 32 consecutive pixels
        for i in th:
            q0 = i - i % osc.HELD
            assert q0 * 4 % 16 == 0 and q0 * 8 % 16 == 0
    # the blocks share the slots evenly
    sizes = [len(blk) for blk in slots]
    assert max(sizes) - min(sizes) <= 1
    # a warp handles fewer than 2^16 pixels of a slot (packed counts)
    per_warp = max(sum(len(pixels[t]) for t in range(w, w + 32))
                   for w in range(0, osc.THREADS, 32))
    assert per_warp < 1 << 16


def _frame(K, P, n_live, n_pix, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, K)
    feats = np.stack([np.cos(th), np.sin(th), rng.uniform(20, 40, K),
                      rng.uniform(20, 40, K), rng.uniform(0, 60, K),
                      rng.uniform(0, 50, K)])
    px = rng.uniform(0, 60, P)
    py = rng.uniform(0, 60, P)
    cache = rng.uniform(0, 1.2, (50, 64)).clip(max=1.0)
    idx = rng.permutation(K).astype(np.int32)
    t = torch.from_numpy
    return (t(feats), t(idx), torch.tensor(n_live, dtype=torch.int32), t(px),
            t(py), torch.tensor(n_pix, dtype=torch.int32), t(cache))


def _kernel_order_sum(vals, pixels):
    """The kernel's summation order for one slot: each thread adds its
    pixels in order, each warp adds its 32 threads in a butterfly (lane
    l adds lane l ^ o for o = 16, 8, 4, 2, 1), the block adds the warps
    in order."""
    per_thread = []
    for th in pixels:
        a = 0.0
        for i in th:
            a = a + float(vals[i])
        per_thread.append(a)
    total = 0.0
    for w in range(0, osc.THREADS, 32):
        lanes = per_thread[w:w + 32]
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
        total = total + lanes[0]
    return torch.tensor(total, dtype=torch.float64)


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("K,P,n_live,n_pix,grid", [
    (64, 700, 21, 613, 21), (64, 2100, 5, 2100, 528), (40, 300, 37, 1, 8),
    (24, 4096, 3, 2501, 2)])
def test_score_kernel_order_equals_plain(K, P, n_live, n_pix, grid,
                                         pruned):
    """The kernel's decomposition on the CPU: every slot's per-pixel
    terms added in the kernel's order equal the plain version's
    partials: counts exact, f64 sums within 1e-12."""
    feats, idx, n, px, py, n_pix_t, cache = _frame(K, P, n_live, n_pix,
                                                   seed=K + n_pix)
    idx = idx if pruned else None
    args = (1.0, 10.0, 0.8)
    want = osc.score_partials_reference(feats, idx, n, px, py, n_pix_t,
                                        cache, 0, 50, 64, *args)
    slots, pixels = osc.split(grid, n_live, n_pix)
    for blk in slots:
        for b in blk:
            c = int(idx[b]) if pruned else b
            ca, sa, sx, sy, mx, my = feats[:, c]
            # the plain version's per-pixel terms (score_partials_reference)
            tx = (px[:n_pix] - sx) * ca - (py[:n_pix] - sy) * sa + mx
            ty = (px[:n_pix] - sx) * sa + (py[:n_pix] - sy) * ca + my
            fx, fy = geo.c_round(tx), geo.c_round(ty)
            inside = (fx >= 0) & (fx < 64) & (fy >= 0) & (fy < 50)
            v = cache.reshape(-1)[(torch.where(inside, fy, 0).long() * 64
                                   + torch.where(inside, fx, 0).long())]
            contrib = torch.where(v >= 1.0, 10.0, v)
            far = inside & ((v >= 1.0) | (v >= 0.8))
            terms = (torch.where(inside, contrib, 0.0), inside.double(),
                     torch.where(far, contrib, 0.0), far.double())
            for k in range(4):
                got = _kernel_order_sum(terms[k], pixels)
                if k in (1, 3):
                    assert int(got) == int(want[k][b])
                else:
                    torch.testing.assert_close(got, want[k][b], rtol=1e-12,
                                               atol=1e-12)
    assert (want[1][n_live:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_score_round_thresholds_equal_c_round(dtype):
    """The kernel's bounds test: with a = v + copysign(0.5, v) (one
    rounded add), trunc(a) is C-round(v), and a > -1, a < hi, a >
    nextafter(lo, -1) are C-round(v) >= 0, < hi, >= lo - on ties, signed
    zeros, neighbours of the boundaries, NaN and infinities."""
    base = torch.tensor([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 7.0, 7.5,
                         8.0, 8.5, 1e7, 3e9], dtype=dtype)
    v = torch.cat([base, -base, torch.nextafter(base, base + 1),
                   torch.nextafter(base, base - 1),
                   torch.nextafter(-base, -base + 1),
                   torch.tensor([math.nan, math.inf, -math.inf, -0.0],
                                dtype=dtype)])
    a = v + torch.copysign(torch.tensor(0.5, dtype=dtype), v)
    r = geo.c_round(v)
    fin = torch.isfinite(a)
    assert torch.equal(torch.trunc(a[fin]), r[fin])
    for lo, hi in ((0, 8), (1, 8), (7, 9), (0, 1)):
        y_lo = torch.nextafter(torch.tensor(float(lo), dtype=dtype),
                               torch.tensor(-1.0, dtype=dtype)) if lo else -1.0
        got = (a > y_lo) & (a < hi)
        want = (r >= lo) & (r < hi)
        assert torch.equal(got, want), (lo, hi)


# --- NFA -----------------------------------------------------------------

def flat_rect_counts(deg_map, scalars, block=512):
    """The NFA kernel's decomposition in plain torch: for each column
    tile of ``block`` columns, the clipped row range of every column (the
    kernel's float expressions), an inclusive scan of the heights, and
    the flat covered index t mapped to the first column whose scanned end
    exceeds t (searchsorted is the kernel's binary search, over the
    columns between ceil(x_start) and floor(x_end)) and to the row
    lo + (t - offset)."""
    dt = deg_map.dtype
    H, W = deg_map.shape
    out_all, out_ali = [], []
    for s in scalars:
        (x_start, x_len, vx0, vx1, _vx2, vx3, vy0, vy1, _vy2, vy3,
         k0, k1, k2, k3, deg, prec) = s
        n_all = n_ali = 0
        for c0 in range(0, W, block):
            xx = torch.arange(c0, c0 + block).to(dt)
            col_ok = (xx < W) & (xx >= x_start) & (xx <= x_start + x_len - 1.0)
            lo_v = torch.where(xx < vx3, vy0 + (xx - vx0) * k3,
                               vy3 + (xx - vx3) * k2)
            hi_v = torch.where(xx < vx1, vy0 + (xx - vx0) * k0,
                               vy1 + (xx - vx1) * k1)
            lo = onfa.c_int(lo_v, up=True).clamp(min=0.0)
            hi = onfa.c_int(hi_v, up=False).clamp(max=float(H - 1))
            ok = col_ok & (lo <= hi)
            lo_i = torch.where(ok, lo, 0.0).long()
            h = torch.where(ok, hi - lo + 1.0, 0.0).long()
            end = torch.cumsum(h, 0)
            total = int(end[-1])
            n_all += total
            if not total:
                continue
            # the kernel searches only [ceil(x_start), floor(x_end)]
            first = torch.tensor(float(c0), dtype=dt)
            last = torch.tensor(float(c0 + block - 1), dtype=dt)
            c_a = max(int(torch.fmin(torch.fmax(torch.ceil(x_start), first),
                                     last)) - c0, 0)
            c_b = int(torch.fmax(torch.fmin(torch.floor(
                x_start + x_len - 1.0), last), first)) - c0
            t = torch.arange(total)
            col = c_a + torch.searchsorted(end[c_a:c_b + 1], t, right=True)
            row = lo_i[col] + t - (end[col] - h[col])
            d = torch.abs(deg - deg_map[row, c0 + col])
            d = torch.where(d > math.pi * 1.5, torch.abs(d - 2 * math.pi), d)
            n_ali += int((d < prec).sum())
        out_all.append(n_all)
        out_ali.append(n_ali)
    return (torch.tensor(out_all, dtype=torch.int32),
            torch.tensor(out_ali, dtype=torch.int32))


def _pack(rects, dtype):
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.stack([tnfa.pack_rect_scalars(
            {k: dtype(v) for k, v in r.items()}) for r in rects])
            .astype(dtype))


def _assert_flat_equal(deg_map, scalars, block):
    want = onfa.rect_counts_reference(deg_map, scalars)
    got = flat_rect_counts(deg_map, scalars, block)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block", [512, 32])
def test_nfa_flat_index_equals_plain_on_fixture_rects(dtype, block):
    """The 27 rectangles of tests/test_nfa_pallas.py over the 48x72
    field of tests/test_torch_nfa.py, at seeds 0, 3, 5, 7 and 11, and 61
    rectangles over a 293x432 field (the data1-sized map's)."""
    rng = np.random.default_rng(42)
    deg = torch.from_numpy(rng.uniform(-math.pi, math.pi, (48, 72))
                           .astype(dtype))
    for seed in (0, 3, 5, 7, 11):
        want = _assert_flat_equal(deg, _pack(_random_rects(48, 72, seed=seed),
                                             dtype), block)
        assert int((want[0] > 0).sum()) >= 20
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.uniform(-math.pi, math.pi, (293, 432))
                           .astype(dtype))
    _assert_flat_equal(big, _pack(_random_rects(293, 432, n=61, seed=1),
                                  dtype), block)


_coord = st.floats(-40.0, 140.0, allow_nan=False, width=32)
_odd = st.sampled_from([math.nan, math.inf, -math.inf, 3e9, -3e9, 0.0])


@settings(max_examples=60, deadline=None)
@given(x1=_coord, y1=_coord, x2=_coord, y2=_coord,
       wid=st.floats(0.5, 9.0, width=32),
       degenerate=st.sampled_from(["none", "vertical", "horizontal",
                                   "point"]),
       poke=st.one_of(st.none(), st.tuples(st.integers(0, 13), _odd)),
       f64=st.booleans(), block=st.sampled_from([512, 16]))
def test_nfa_flat_index_equals_plain_hypothesis(x1, y1, x2, y2, wid,
                                                degenerate, poke, f64,
                                                block):
    H, W = 61, 97
    dtype = np.float64 if f64 else np.float32
    if degenerate == "vertical":
        x2 = x1
    elif degenerate == "horizontal":
        y2 = y1
    elif degenerate == "point":
        x2, y2 = x1, y1
    th = math.atan2(y2 - y1, x2 - x1)
    rec = dict(x1=x1, y1=y1, x2=x2, y2=y2, wid=wid, dx=math.cos(th),
               dy=math.sin(th), deg=0.4, prec=0.125 * math.pi)
    sc = _pack([rec], dtype)
    if poke is not None:          # a non-finite or out-of-range scalar
        sc[0, poke[0]] = poke[1]
    rng = np.random.default_rng(7)
    deg = torch.from_numpy(rng.uniform(-math.pi, math.pi, (H, W))
                           .astype(dtype))
    _assert_flat_equal(deg, sc, block)


def test_nfa_flat_index_full_height_vertical_line():
    """A vertical rectangle down every row of a 293-row field: one
    column holds every covered pixel, the case one thread walked alone
    in the first design."""
    deg = torch.from_numpy(np.random.default_rng(3).uniform(
        -math.pi, math.pi, (293, 432)))
    th = math.atan2(305.0, 0.0)
    rec = dict(x1=200.0, y1=-5.0, x2=200.0, y2=300.0, wid=1.0,
               dx=math.cos(th), dy=math.sin(th), deg=0.3,
               prec=0.125 * math.pi)
    want = _assert_flat_equal(deg, _pack([rec], np.float64), 512)
    assert int(want[0][0]) >= 293
