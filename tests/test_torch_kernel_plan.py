"""The launch plans of the port's CUDA kernels, on the CPU.

CalcScore (csrc/score.cu): ``ops/score.py:plan`` sizes the persistent
grid from the caps and ``split`` is how the kernel shares the live work
out.  The grid never exceeds the resident blocks, every live slot goes
to exactly one block and every live pixel to exactly one thread, rounds
start on 16-byte boundaries, and the per-pixel contributions added in
the kernel's order equal the plain version (counts exact, f64 sums to
1e-12); the kernel's C-round thresholds equal C-round.  A batched
launch's lanes share the resident blocks, and ``split_lanes`` /
``zero_split`` write every (lane, slot) output once.

NFA (csrc/nfa.cu): a plain torch mirror of the kernel's decomposition -
per-column clipped heights, their inclusive scan over column tiles of
the block's width, the flat covered index mapped back to (column, row) by
a binary search - equals ``rect_counts_reference`` on hypothesis-drawn
rectangles (out of the image, degenerate, non-finite slopes and scalars)
and on the random rectangles of tests/test_nfa_pallas.py.

FIFO growth (csrc/grow.cu): one block whose warp 0 walks the queue
on the chip.  ``ops/grow.py:grow_plan`` puts the region bitmap and the
queue in the shared-memory budget (a global mask above it, a queue
spilling past its cap), ``reduce_plan`` the reducer's slots and flags,
and the block's threads clear the whole uint8 mask (each cell once, by
warps 1-7 beside the walk or by every thread before it).  Plain mirrors
of the two
kernels' walks - the packed queue with its spill, the bitmap, windows
of queue entries tested by a warp's lanes together, the next window
loaded ahead; the reducer's far flags decided first and the
swap-with-last walk taken in runs over the flag words, its slots past
the cap in the global queue - equal ``grow_fifo_reference`` and
``radius_reducer_fifo_reference``.

Wave growth (csrc/grow.cu): one block with two bitmaps and two lists on
the chip.  ``ops/grow.py:wave_plan`` puts the bitmaps and the lists in
the shared budget (the state in the global mask above it, the lists
spilling past their caps); its sorts order a wave's accepted cells (the
block's bitonic network with slots past the count skipped, one warp's
for at most 32); the final mask write spreads a bitmap word over 32
bytes; a plain mirror of its waves - the list tested in chunks and
packed in place, the accepted cells sorted and summed in the kernel's
order, their neighbours claimed once, warps in a random order - equals
``grow_wave_reference``."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.mapprep import nfa as tnfa
from lsdtpu_torch.ops import grow as ogrow
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,P,n_sm", [(2048, 4096, H100_SMS), (21, 300, 1),
                                      (16384, 9000, 114)])
@pytest.mark.parametrize("lanes", [1, 8, 16, 64, 300])
def test_score_plan_lanes_share_the_resident_blocks(K, P, n_sm, dtype,
                                                   lanes):
    """A batched launch's grid is (grid, lanes): the lanes share the
    resident blocks evenly (at least one block a lane), and one lane is
    the single-frame plan."""
    pl = osc.plan(K, P, n_sm, dtype, lanes=lanes)
    resident = n_sm * osc.RESIDENT[dtype]
    assert pl.grid == max(1, min(resident // lanes, K))
    assert pl.grid * lanes <= max(resident, lanes)
    if lanes == 1:
        assert pl == osc.plan(K, P, n_sm, dtype)
        assert pl.grid == max(1, min(resident, K))


@pytest.mark.parametrize("B,grid", [(8, 49), (16, 24), (64, 6), (1, 396),
                                    (3, 1)])
def test_score_lane_split_writes_each_lane_slot_once(B, grid):
    """The lane decomposition of the batched launch, for random per-lane
    live counts (one relocking lane of 325 survivors, an empty lane, a
    full one): every live (lane, slot) is scored by exactly one block of
    its lane, over each of its live pixels once, and every dead slot of
    every lane is zeroed exactly once, so each (lane, slot) output is
    written once."""
    rng = np.random.default_rng(B * 1000 + grid)
    K = 400
    n_live = rng.integers(0, 40, B)
    n_live[0] = 325
    n_live[-1] = 0 if B > 1 else n_live[-1]
    if B > 2:
        n_live[1] = K
    n_pix = rng.integers(0, 3000, B)
    lanes = osc.split_lanes(grid, n_live, n_pix)
    assert len(lanes) == B
    scored = []
    for ln, (slots, pixels) in enumerate(lanes):
        live = [b for blk in slots for b in blk]
        assert sorted(live) == list(range(n_live[ln]))
        assert sorted(i for th in pixels for i in th) == \
            list(range(n_pix[ln]))
        dead = [s for blk in osc.zero_split(grid, int(n_live[ln]), K)
                for th in blk for s in th]
        assert sorted(live + dead) == list(range(K))   # each slot once
        scored += [(ln, b) for b in live]
    assert len(scored) == len(set(scored)) == int(n_live.sum())


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


# --- FIFO growth -------------------------------------------------------

WARP = 32   # csrc/grow.cu's kWarp: warp 0 walks, warps 1-7 clear beside it


def _clear_split(cells, shared_mask):
    """The cells each thread of the grow_fifo block clears from the uint8
    mask (csrc/grow.cu:clear_mask): the clearing threads are warps 1-7
    beside the walk with the bitmap in shared memory, all threads before
    it with the global mask; clearing thread t takes 16-byte words t,
    t + n, ... and tail byte t below cells % 16."""
    first = WARP if shared_mask else 0
    n = ogrow.THREADS - first
    words = cells // 16
    return [[] for _ in range(first)] + [
        [c for w in range(t, words, n) for c in range(16 * w, 16 * w + 16)]
        + ([16 * words + t] if t < cells % 16 else []) for t in range(n)]


@pytest.mark.parametrize("cells", [1, 3, 4, 255, 1021, 24 * 32, 293 * 432])
def test_grow_clear_split_covers_each_cell_once(cells):
    """The whole mask of ``cells`` cells is cleared, each cell exactly
    once: by warps 1-7 beside the walk (warp 0, the walker's, clears
    nothing) or by every thread before it, whole 16-byte words first."""
    for shared_mask in (True, False):
        split = _clear_split(cells, shared_mask)
        assert len(split) == ogrow.THREADS
        assert sorted(c for t in split for c in t) == list(range(cells))
        if shared_mask:
            assert not any(split[:WARP])
        body = cells // 16 * 16
        for t in split:   # a thread's cells below the tail: aligned words
            head = [c for c in t if c < body]
            assert all(c % 16 == i % 16 for i, c in enumerate(head))


def test_grow_fifo_returns_a_mask_per_call():
    """Growth calls on one queue each return a mask of their own: a later
    call leaves an earlier region's mask as it was."""
    H, W = 12, 16
    deg, sn, cs, ban, _ = _coherent_field(5, H, W)
    t = [torch.from_numpy(v) for v in (ban, deg, sn, cs)]
    queue = ogrow.fifo_queue(H, W, "cpu")
    first = ogrow.grow_fifo(2, 3, 0.55, *t, queue)
    kept = first.cur.clone()
    second = ogrow.grow_fifo(H - 2, W - 3, 0.55, *t, queue)
    assert torch.equal(first.cur, kept)
    assert first.cur.data_ptr() != second.cur.data_ptr()
    assert int(first.counts[0]) == int(kept.sum())


@pytest.mark.parametrize("H,W,shared,cap", [
    (1, 1, True, 1), (3, 5, True, 15), (96, 128, True, 96 * 128),
    (293, 432, True, ogrow.QUEUE_CAP), (979, 1440, True, 14057),
    (1314, 1314, True, 4155), (1315, 1316, False, ogrow.QUEUE_CAP),
    (1600, 1600, False, ogrow.QUEUE_CAP), (1, 65535, True, ogrow.QUEUE_CAP)])
def test_grow_plan_fits_the_shared_budget(H, W, shared, cap):
    pl = ogrow.grow_plan(H, W)
    assert (pl.shared_mask, pl.queue_cap) == (shared, cap)
    words = -(-H * W // 32)
    assert pl.mask_words == (words if shared else 0)
    assert pl.smem_bytes == 4 * (pl.mask_words + pl.queue_cap) \
        <= ogrow.SMEM_MAX
    # the bitmap is in shared memory exactly when it fits beside the
    # fewest queue entries; the queue never exceeds the cells or its cap
    assert shared == (4 * (words + min(ogrow.QUEUE_MIN, H * W))
                      <= ogrow.SMEM_MAX)
    assert 1 <= pl.queue_cap <= min(ogrow.QUEUE_CAP, H * W)
    if shared and H * W > ogrow.QUEUE_CAP:
        assert pl.queue_cap >= ogrow.QUEUE_MIN


def test_grow_plan_map_prep_field_spills_only_a_large_flood():
    """The 293 x 432 map-prep field: a 16 KB bitmap beside a 64 KB queue,
    above the 48 KB a launch gets without the attribute; a region spills
    into the global queue only past 16384 pixels (a full flood)."""
    pl = ogrow.grow_plan(293, 432)
    assert pl.mask_words * 4 == 15824 and pl.smem_bytes == 81360 > 49152
    assert pl.queue_cap < 293 * 432


@pytest.mark.parametrize("H,W", [(0, 4), (4, 0), (65536, 2), (2, 65536),
                                 (65535, 65535)])
def test_grow_plan_rejects_fields_the_kernel_cannot_pack(H, W):
    with pytest.raises(ValueError):
        ogrow.grow_plan(H, W)


@pytest.mark.parametrize("entries,cap,shared", [
    (1, 1, True), (132, 132, True), (8192, 8192, True),
    (293 * 432, ogrow.REDUCE_CAP, True), (0, 1, True),
    (1600 * 1600, ogrow.REDUCE_CAP, False)])
def test_reduce_plan(entries, cap, shared):
    pl = ogrow.reduce_plan(entries)
    assert (pl.cap, pl.shared_flags) == (cap, shared)
    assert pl.flag_words * 32 >= entries > (pl.flag_words - 1) * 32 \
        or entries == 0
    assert pl.smem_bytes == 8 * pl.cap + 4 * pl.flag_words * shared \
        <= ogrow.SMEM_MAX


_NB = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _grow_mirror(sy, sx, thre, ban, deg, sn, cs, qcap, window=4):
    """csrc/grow.cu's walk in float64 host scalars: a shared queue of
    packed cells (y << 16 | x) of qcap entries spilling into qy/qx, the
    region as a bitmap, and the warp's windows: lane L tests neighbour
    L % 8 of entry L // 8 of a window of ``window`` entries against the
    running angle; the lowest passing lane is accepted and the later lanes
    drop its cell and are tested again.  The next window's entries that
    exist are loaded before the current one is decided, those it appends
    after.  Returns the outputs of Growth as lists and the count of
    windows completed after their decisions."""
    H, W = deg.shape
    bm = [0] * (-(-H * W // 32))
    sq, qy, qx = [0] * qcap, [0] * (H * W), [0] * (H * W)
    st = dict(grow=1, appended=0)

    def entry(j):
        return sq[j] if j < qcap else (qy[j] << 16) | qx[j]

    def bit(idx):
        return (bm[idx >> 5] >> (idx & 31)) & 1

    def lane(e, L, j):
        dy, dx = _NB[L % 8]
        m, n = (e >> 16) + dy, (e & 0xFFFF) + dx
        inb = 0 <= m < H and 0 <= n < W
        return dict(inb=inb, e=(m << 16) | (n & 0xFFFF),
                    idx=m * W + n if inb else 0,
                    ban=bool(ban[m, n]) if inb else True,
                    d=float(deg[m, n]) if inb else 0.0,
                    s=float(sn[m, n]) if inb else 0.0,
                    c=float(cs[m, n]) if inb else 0.0, src=(j, e))

    def load(base, keep=0, old=None):
        count = min(window, st["grow"] - base)
        return dict(base=base, count=count, lanes=[
            old["lanes"][L] if L // 8 < keep else
            lane(entry(base + L // 8), L, base + L // 8)
            if L // 8 < count else dict(inb=False, idx=0, src=None)
            for L in range(8 * window)])

    fold, two_pi = 1.5 * math.pi, 2.0 * math.pi

    def ok(d, nd):
        dif = abs(d - nd)
        return (abs(dif - two_pi) if dif > fold else dif) < thre

    s_sin, s_cos = float(sn[sy, sx]), float(cs[sy, sx])
    d = math.atan2(s_sin, s_cos)
    idx0 = sy * W + sx
    bm[idx0 >> 5] |= 1 << (idx0 & 31)
    sq[0] = (sy << 16) | sx
    i, ex, pops, passes = 0, 1, 0, 1
    a = load(0)
    while True:
        assert a["base"] == i and a["count"] == min(window, st["grow"] - i)
        for L, ln in enumerate(a["lanes"]):   # the window is the queue's
            if L // 8 < a["count"]:
                assert ln["src"] == (i + L // 8, entry(i + L // 8))
        opened = [ln["inb"] and not ln["ban"] and not bit(ln["idx"])
                  for ln in a["lanes"]]
        passing = [o and ok(d, ln["d"]) for o, ln in zip(opened, a["lanes"])]
        after = i + a["count"]
        b = load(after)
        acc = [L for L, p in enumerate(passing) if p]
        while acc:
            L = acc[0]
            ln = a["lanes"][L]
            s_sin, s_cos = s_sin + ln["s"], s_cos + ln["c"]
            bm[ln["idx"] >> 5] |= 1 << (ln["idx"] & 31)
            g = st["grow"]
            if g < qcap:
                sq[g] = ln["e"]
            else:
                qy[g], qx[g] = ln["e"] >> 16, ln["e"] & 0xFFFF
            st["grow"] = g + 1
            d = math.atan2(s_sin, s_cos)
            opened = [o and x["idx"] != ln["idx"]
                      for o, x in zip(opened, a["lanes"])]
            acc = [L2 for L2, (o, x) in enumerate(zip(opened, a["lanes"]))
                   if o and L2 > L and ok(d, x["d"])]
        pops += a["count"]
        i = after
        if after == st["grow"]:
            if st["grow"] == ex:
                break
            ex, passes, i = st["grow"], passes + 1, 0
            b = load(0)
        elif b["count"] < window and after + b["count"] < st["grow"]:
            b = load(after, b["count"], b)
            st["appended"] += 1
        a = b
    grow = st["grow"]
    for j in range(min(grow, qcap)):
        qy[j], qx[j] = sq[j] >> 16, sq[j] & 0xFFFF
    mask = [bit(k) for k in range(H * W)]
    return (mask, d, qy[:grow], qx[:grow], [grow, pops, passes]), \
        st["appended"]


def _coherent_field(seed, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    part = (xx * 3 // W).astype(int) + 3 * (yy * 2 // H).astype(int)
    base = rng.uniform(-np.pi, np.pi, 6)
    deg = base[part] + 0.02 * xx - 0.01 * yy + rng.normal(0, 0.15, (H, W))
    deg = (deg + np.pi) % (2 * np.pi) - np.pi
    ban = rng.random((H, W)) < 0.04
    return deg, np.sin(deg), np.cos(deg), ban, rng


@pytest.mark.parametrize("qcap", [1, 7, 64, 10 ** 6])
def test_grow_kernel_walk_equals_plain(qcap):
    """The kernel's walk (windows of queue entries tested together, the
    queue spilling past qcap entries, the next window loaded ahead and
    completed with the entries appended to it)
    equals grow_fifo_reference in f64 bit for bit, regions large and
    small, including the field's edges and a pi-wrapping angle."""
    H, W = 24, 30
    deg, sn, cs, ban, rng = _coherent_field(11, H, W)
    t = {k: torch.from_numpy(v) for k, v in
         (("deg", deg), ("sn", sn), ("cs", cs), ("ban", ban))}
    appended, largest = 0, 0
    seeds = [(0, 0), (H - 1, W - 1), (0, W - 1)] + [
        (int(rng.integers(0, H)), int(rng.integers(0, W))) for _ in range(9)]
    for k, (sy, sx) in enumerate(seeds):
        thre = (0.3, 0.55, 2.0)[k % 3]
        (mask, d, qy, qx, counts), app = _grow_mirror(
            sy, sx, thre, ban, deg, sn, cs, min(qcap, H * W))
        want = ogrow.grow_fifo_reference(
            sy, sx, thre, t["ban"], t["deg"], t["sn"], t["cs"],
            ogrow.fifo_queue(H, W, "cpu"))
        n = int(want.counts[0])
        assert counts == want.counts.tolist()
        assert mask == want.cur.reshape(-1).to(torch.uint8).tolist()
        assert qy == want.qy[:n].tolist() and qx == want.qx[:n].tolist()
        assert d == float(want.reg_deg)
        appended += app
        largest = max(largest, n)
    # spills, and windows the queue grew into
    assert largest > 64 and appended > 0


def _reduce_mirror(sx, sy, rad, qy, qx, m, cur, fit, W, cap):
    """csrc/grow.cu's reducer in float64 host scalars: a far flag bit for
    every live slot decided first (the far cells cleared), the first cap
    slots held aside, then the swap-with-last walk taken in runs over the
    flag words - the next far slot found at once, the last kept slot
    before the end found at once - with slots past cap in the global
    queue, then the phantom-slot rule."""
    fx, fy = float(sx), float(sy)
    ms = min(m, cap)
    fb = [0] * max(1, -(-m // 32))
    se = [None] * ms
    for j in range(m):
        dx, dy = fx - float(qx[j]), fy - float(qy[j])
        if math.sqrt(dx * dx + dy * dy) > rad:
            fb[j >> 5] |= 1 << (j & 31)
            cur[qy[j] * W + qx[j]] = fit[qy[j] * W + qx[j]] = 0
        if j < ms:
            se[j] = (qx[j], qy[j])

    def get(j):
        return se[j] if j < ms else (qx[j], qy[j])

    def put(j, e):
        if j < ms:
            se[j] = e
        else:
            qx[j], qy[j] = e

    def next_far(i, n):
        while i < n:
            bits = fb[i >> 5] >> (i & 31)
            if bits:
                f = i + (bits & -bits).bit_length() - 1
                return min(f, n)
            i = (i | 31) + 1
        return n

    def last_near(i, n):
        j = n - 1
        while j > i:
            near = ~fb[j >> 5] & (0xFFFFFFFF >> (31 - (j & 31)))
            if near:
                return max((j & ~31) + near.bit_length() - 1, i)
            j = (j & ~31) - 1
        return i

    n, i = m, 0
    while True:
        i = next_far(i, n)
        if i >= n:
            break
        j = last_near(i, n)
        if j > i:
            put(i, get(j))
            n, i = j, i + 1
        else:
            if i + 1 < n:
                put(i, get(i + 1))
            n = i
            break
    if math.sqrt(fx * fx + fy * fy) > rad and n > 0:
        x, y = get(n - 1)
        fit[y * W + x] = 0
        cur[0] = 0
        n -= 1
    for j in range(ms):
        qx[j], qy[j] = se[j]
    return n


@pytest.mark.parametrize("cap", [1, 5, 40, 10 ** 6])
def test_reduce_kernel_walk_equals_plain(cap):
    """The reducer's decomposition (flags first, the walk in runs over the
    flag words, slots past the cap in the global queue) equals
    radius_reducer_fifo_reference bit for bit over successive passes,
    with and without the phantom slot."""
    H, W = 24, 30
    deg, sn, cs, ban, _rng = _coherent_field(12, H, W)
    for (sy, sx) in ((12, 15), (0, 0)):
        ban[sy, sx] = False
        g = ogrow.grow_fifo_reference(
            sy, sx, 2.0, torch.from_numpy(ban), torch.from_numpy(deg),
            torch.from_numpy(sn), torch.from_numpy(cs),
            ogrow.fifo_queue(H, W, "cpu"))
        n0 = int(g.counts[0])
        assert n0 > 60
        qy, qx = g.qy.clone(), g.qx.clone()
        n, cur, fit = g.counts[:1].clone(), g.cur.clone(), g.cur.clone()
        mq = (qy.tolist(), qx.tolist())
        mcur = cur.reshape(-1).to(torch.uint8).tolist()
        mfit = list(mcur)
        m, rad = n0, 12.0
        for _ in range(5):
            rad *= 0.75
            m = _reduce_mirror(sx, sy, rad, mq[0], mq[1], m, mcur, mfit, W,
                               cap)
            ogrow.radius_reducer_fifo_reference(sx, sy, np.float64(rad), qy,
                                                qx, n, cur, fit)
            assert m == int(n[0])
            assert mq[0][:n0] == qy[:n0].tolist()
            assert mq[1][:n0] == qx[:n0].tolist()
            assert mcur == cur.reshape(-1).to(torch.uint8).tolist()
            assert mfit == fit.reshape(-1).to(torch.uint8).tolist()


# --- wave growth -------------------------------------------------------

@pytest.mark.parametrize("H,W,shared,cap", [
    (1, 1, True, 1), (3, 5, True, 15), (96, 128, True, 96 * 128),
    (293, 432, True, ogrow.QUEUE_CAP), (587, 433, True, ogrow.QUEUE_CAP),
    (979, 1440, False, ogrow.QUEUE_CAP), (1600, 1600, False, ogrow.QUEUE_CAP),
    (1, 65535, True, ogrow.QUEUE_CAP)])
def test_wave_plan_fits_the_shared_budget(H, W, shared, cap):
    """grow_wave's two bitmaps are in shared memory exactly when they fit
    beside QUEUE_MIN entries of each list, in the budget less the
    kernel's static bytes; the two lists share the rest, each up to
    QUEUE_CAP and the field's cells."""
    pl = ogrow.wave_plan(H, W)
    assert (pl.shared_mask, pl.list_cap, pl.acc_cap) == (shared, cap, cap)
    words = 2 * -(-H * W // 32)
    budget = ogrow.SMEM_MAX - ogrow.WAVE_STATIC
    assert shared == (4 * (words + 2 * min(ogrow.QUEUE_MIN, H * W))
                      <= budget)
    assert pl.smem_bytes == 4 * ((words if shared else 0) + 2 * cap) \
        <= budget


def test_wave_plan_map_prep_field():
    """The 293 x 432 map-prep field: two 16 KB bitmaps and two lists of
    16,384 entries; a list spills only past them."""
    pl = ogrow.wave_plan(293, 432)
    assert pl.shared_mask and pl.smem_bytes == 4 * (2 * 3956 + 2 * 16384)


@pytest.mark.parametrize("H,W", [(0, 4), (65536, 2), (65535, 65535)])
def test_wave_plan_rejects_fields_the_kernel_cannot_pack(H, W):
    with pytest.raises(ValueError):
        ogrow.wave_plan(H, W)


def _flip_steps(P, n):
    """csrc/grow.cu:block_sort's compare-exchanges on P slots (a power of
    two), step by step: pair p of a flip step of block size k is (lo,
    base + k - 1 - off), of a later step of size m (lo, lo + m / 2); an
    exchange whose upper slot lies past n is skipped."""
    steps, k = [], 2
    while k <= P:
        m = k
        while m >= 2:
            half, step = m >> 1, []
            for p in range(P >> 1):
                base, off = (p // half) * m, p % half
                lo = base + off
                hi = base + m - 1 - off if m == k else lo + half
                if hi < n:
                    step.append((lo, hi))
            steps.append(step)
            m >>= 1
        k <<= 1
    return steps


def _block_sort(vals):
    v, n, P = list(vals), len(vals), 2
    while P < n:
        P <<= 1
    for step in _flip_steps(P, n):
        slots = [s for pair in step for s in pair]
        assert len(slots) == len(set(slots))   # a step's threads never meet
        for lo, hi in step:
            if v[hi] < v[lo]:
                v[lo], v[hi] = v[hi], v[lo]
    return v


def _warp_sort(vals):
    """csrc/grow.cu:warp_sort: lane l holds vals[l] (~0 past them) and
    takes the min or max with lane l ^ mask."""
    e = list(vals) + [0xFFFFFFFF] * (WARP - len(vals))
    k = 2
    while k <= WARP:
        m = k
        while m >= 2:
            mask = k - 1 if m == k else m >> 1
            e = [min(e[lane], e[lane ^ mask]) if not lane & (m >> 1)
                 else max(e[lane], e[lane ^ mask]) for lane in range(WARP)]
            m >>= 1
        k <<= 1
    return e


@pytest.mark.parametrize("n", [2, 3, 5, 31, 32, 33, 64, 100, 256, 257, 1000,
                               4097])
def test_wave_sorts_order_the_accepted_cells(n):
    """The sorts grow_wave takes before it sums a wave: the block's
    bitonic network with the slots past n skipped, and for at most 32
    cells one warp's, each ascending over packed cells."""
    rng = np.random.default_rng(n)
    cells = [int(c) for c in rng.choice(2 ** 26, n, replace=False)]
    vals = [(c // 4096) << 16 | (c % 4096) for c in cells]
    assert _block_sort(vals) == sorted(vals)
    if n <= WARP:
        e = _warp_sort(vals)
        assert e[:n] == sorted(vals) and e[n:] == [0xFFFFFFFF] * (WARP - n)


def test_wave_mask_spread_writes_a_byte_a_bit():
    """The final mask write: bitmap word bits b..b+3 become four bytes of
    one 32-bit lane of a 16-byte store, little-endian."""
    def spread(b):
        return (b & 1) | ((b & 2) << 7) | ((b & 4) << 14) | ((b & 8) << 21)

    rng = np.random.default_rng(0)
    for bits in [0, 0xFFFFFFFF, 1, 1 << 31] + [
            int(x) for x in rng.integers(0, 2 ** 32, 50)]:
        words = [spread(bits >> s) & 0x01010101 for s in range(0, 32, 4)]
        got = np.frombuffer(np.array(words, dtype="<u4").tobytes(), np.uint8)
        assert got.tolist() == [(bits >> i) & 1 for i in range(32)]


def _warp_tree(x):
    """A warp's shuffle-down tree: lane l adds lane l + off (its own
    value past the warp), off = 16 .. 1; lane 0's sum."""
    x = list(x) + [0.0] * (WARP - len(x))
    off = WARP // 2
    while off:
        x = [x[i] + x[i + off] if i + off < WARP else x[i] + x[i]
             for i in range(WARP)]
        off >>= 1
    return x[0]


def _wave_sums(vals):
    """csrc/grow.cu:wave_sums' order over the sorted cells' values: one
    warp's tree for at most 32, else thread t adds cells t, t + 256, ...
    in turn, each warp's tree, then the eight warps' tree."""
    if len(vals) <= WARP:
        return _warp_tree(vals)
    part = [0.0] * ogrow.THREADS
    for j, v in enumerate(vals):
        part[j % ogrow.THREADS] += v
    w = [_warp_tree(part[i:i + WARP]) for i in range(0, ogrow.THREADS, WARP)]
    while len(w) > 1:
        h = len(w) // 2
        w = [a + b for a, b in zip(w[:h], w[h:])]
    return w[0]


def _wave_mirror(sy, sx, seed_deg, thre, free, deg, sn, cs, list_cap,
                 acc_cap, rng):
    """A plain mirror of csrc/grow.cu:grow_wave_kernel in f64: the list
    and the accepted cells as packed entries in shared slots below their
    caps and in the spill buffers past them, the seen and region sets; a
    wave tests the list in chunks of 256, the warps of a chunk moving
    their passes and fails in a random order (the atomics' order), the
    accepted cells sorted and summed in the kernel's order, their
    neighbours claimed and appended warp by warp in a random order.
    Returns (mask, angle, [n, waves, tests], the largest list, the
    largest wave)."""
    H, W = deg.shape
    fold, two_pi = 1.5 * math.pi, 2.0 * math.pi
    freef, degf, snf, csf = (a.reshape(-1) for a in (free, deg, sn, cs))
    store = {"list": ([0] * list_cap, [0] * (H * W), list_cap),
             "acc": ([0] * acc_cap, [0] * (H * W), acc_cap)}

    def get(name, j):
        sh, gl, cap = store[name]
        return sh[j] if j < cap else gl[j]

    def put(name, j, e):
        sh, gl, cap = store[name]
        if j < cap:
            sh[j] = e
        else:
            gl[j] = e

    def cell(e):
        return (e >> 16) * W + (e & 0xFFFF)

    region, seen = {sy * W + sx}, {sy * W + sx}
    warps = ogrow.THREADS // WARP

    def expand(na, nk):
        app, total = 0, 8 * na
        for base in range(0, total, ogrow.THREADS):
            for w in rng.permutation(warps):
                new = []
                for lane in range(WARP):
                    j = base + w * WARP + lane
                    if j >= total:
                        continue
                    e = get("acc", j >> 3)
                    k = (j & 7) + ((j & 7) >= 4)
                    y, x = (e >> 16) + k // 3 - 1, (e & 0xFFFF) + k % 3 - 1
                    if 0 <= y < H and 0 <= x < W and freef[y * W + x] \
                            and y * W + x not in seen:
                        seen.add(y * W + x)
                        new.append(y << 16 | x)
                for i, c in enumerate(new):
                    put("list", nk + app + i, c)
                app += len(new)
        return nk + app

    s_sin, s_cos = math.sin(seed_deg), math.cos(seed_deg)
    d = math.atan2(s_sin, s_cos)
    put("acc", 0, sy << 16 | sx)
    nl = expand(1, 0)
    n, waves, tests, most_list, most_acc = 1, 0, 0, nl, 0
    while True:
        waves += 1
        tests += nl
        na = nk = 0
        for base in range(0, nl, ogrow.THREADS):
            chunk = [get("list", j) for j in range(base, min(nl, base +
                                                             ogrow.THREADS))]
            for w in rng.permutation(warps):
                lanes = chunk[w * WARP:(w + 1) * WARP]
                ok = []
                for e in lanes:
                    dif = abs(d - degf[cell(e)])
                    wrapped = abs(dif - two_pi)
                    ok.append((wrapped if dif > fold else dif) < thre)
                for e in [e for e, p in zip(lanes, ok) if p]:
                    put("acc", na, e)
                    region.add(cell(e))
                    na += 1
                for e in [e for e, p in zip(lanes, ok) if not p]:
                    put("list", nk, e)
                    nk += 1
        if na == 0:
            break
        n += na
        most_acc = max(most_acc, na)
        cells = [get("acc", j) for j in range(na)]
        cells = _warp_sort(cells)[:na] if na <= WARP else _block_sort(cells)
        for j, e in enumerate(cells):
            put("acc", j, e)
        s_sin = s_sin + _wave_sums([float(snf[cell(e)]) for e in cells])
        s_cos = s_cos + _wave_sums([float(csf[cell(e)]) for e in cells])
        d = math.atan2(s_sin, s_cos)
        nl = expand(na, nk)
        most_list = max(most_list, nl)
    mask = np.zeros(H * W, bool)
    mask[list(region)] = True
    return mask.reshape(H, W), d, [n, waves, tests], most_list, most_acc


@pytest.mark.parametrize("list_cap,acc_cap", [(1, 1), (7, 40), (64, 5),
                                              (10 ** 6, 10 ** 6)])
def test_wave_kernel_walk_equals_plain(list_cap, acc_cap):
    """The wave kernel's decomposition - the candidate list tested in
    chunks and packed in place, the accepted cells moved out, sorted and
    summed in a fixed order, their neighbours claimed once - with its
    lists spilling past their caps, equals grow_wave_reference in f64:
    the same region and counts, the angle within 1e-12 (the sums' order
    is not torch's), regions large and small, at the field's edges, a
    wave of more than 32 cells among them."""
    H, W = 24, 30
    deg, sn, cs, ban, rng = _coherent_field(13, H, W)
    free = ~ban
    t = {k: torch.from_numpy(v) for k, v in
         (("deg", deg), ("sn", sn), ("cs", cs), ("free", free))}
    seeds = [(0, 0), (H - 1, W - 1), (0, W - 1)] + [
        (int(rng.integers(0, H)), int(rng.integers(0, W))) for _ in range(9)]
    most_list = most_acc = 0
    for k, (sy, sx) in enumerate(seeds):
        thre = (0.3, 0.55, 2.0)[k % 3]
        a0 = deg[sy, sx] + (0.05 if k % 4 == 1 else 0.0)
        mask, d, counts, ml, ma = _wave_mirror(
            sy, sx, a0, thre, free, deg, sn, cs, list_cap, acc_cap,
            np.random.default_rng(k))
        want = ogrow.grow_wave_reference(
            sy, sx, torch.tensor(a0, dtype=torch.float64), thre, t["free"],
            t["deg"], t["sn"], t["cs"])
        assert counts == want.counts.tolist()
        assert np.array_equal(mask, want.cur.numpy())
        assert abs(d - float(want.reg_deg)) <= 1e-12
        most_list, most_acc = max(most_list, ml), max(most_acc, ma)
    assert most_acc > WARP and most_list > 64
