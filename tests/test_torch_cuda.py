"""The CalcScore kernel (lsdtpu_torch/csrc/score.cu, on every field
storage type and on a window), the NFA rect_counts kernel
(lsdtpu_torch/csrc/nfa.cu) and the FIFO growth, radius-reducer and
wave growth kernels (lsdtpu_torch/csrc/grow.cu) against their plain PyTorch versions
on the card; map prep, the streaming OnlineLocalizer (tracking and
legacy), the pose polish and a checkpoint resume on the card against
the CPU; the lane-batched CalcScore launch against its plain version
and against single-lane launches (bitwise), batched rollouts and the
serving pool against their solo counterparts on the card.  Marked
``cuda``: each test decides inside itself whether a card is present and
skips where there is none.  Run on the card with
``python -m pytest -m cuda tests/test_torch_*.py``.

Tiers: counts exact; f64 sums rtol 1e-12; f32 sums rtol/atol 2e-6
(different summation order); repeated launches bitwise equal; a batched
launch's lanes bitwise equal to single-lane launches; f64 map lines card
vs CPU within 1e-6 px
(CUDA's sin/cos/atan2 and reduction order differ from the CPU's); FIFO
growth in f64: the same region, queue and count, reg_deg within 1e-12
(only atan2 differs: both read the same sin/cos tables); wave growth:
the same region and counts, reg_deg within 1e-12 in f64 and 1e-5 in
f32 (CUDA's sin, cos and atan2, and the kernel's sums in row-major order
against torch's); streaming on
the card bitwise equal to run_sequence there; f64 sessions card vs CPU
with identical decisions (tracking poses within 1e-6 px, the legacy
first-minimum pose identical); a row block's counts (NFA and CalcScore)
exact, and four row blocks' f32 sums within rel 1e-5 of the whole
field's (four partial sums added: another summation order)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _frame(dtype, last):
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.distance import create_map_cache
    from lsdtpu_torch.match import associate as tas
    from lsdtpu_torch.runtime import loop
    sc = synth.synth_dataset(1, F=2, H=490, W=720, resol=0.05, rmax=13.0,
                             n_walls=46, clear_m=2.5, wall_scale=1.5)
    ds = sc.dataset
    cache = create_map_cache(ds.map_value, 0.05, 1.0, device="cuda")
    ctx = loop.make_map_context(synth.wall_lines(sc.walls), cache, 0.05,
                                ds.param.ori_x, ds.param.ori_y, dtype=dtype,
                                device="cuda")
    fr = loop.stack_frames(ds, dtype=dtype)
    fs = loop.featurize_stage(tuple(torch.as_tensor(fr[k][0], device="cuda")
                                    for k in loop._FRAME_KEYS), ctx)
    lp = torch.tensor(last, dtype=ctx.cache.dtype, device="cuda")
    cand = tas.generate_candidates(fs.lines, fs.lines_mask, ctx.lines,
                                   ctx.lines_mask,
                                   loop.geo.c_round(fs.lidar_pos), lp, 2048)
    return ctx, fs, cand


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float32, 2e-6, 2e-6),
                                             (np.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize("pruned", [False, True])
def test_kernel_matches_plain_on_card(dtype, rtol, atol, pruned):
    _need_card()
    from lsdtpu_torch.match import associate as tas
    from lsdtpu_torch.ops import score as sc
    ctx, fs, cand = _frame(dtype, (-1.0, -1.0, 0.0))
    K = cand.ca.shape[0]
    px, py, n_pix = tas.pixel_args(fs.pixels, fs.pixels_mask, ctx.cache.dtype)
    if pruned:
        idx = torch.randperm(K, device="cuda").to(torch.int32)
        n = torch.tensor(min(int(cand.count), K) // 2, dtype=torch.int32,
                         device="cuda")
    else:
        idx, n = None, cand.count.clamp(0, K).to(torch.int32)
    args = (cand.feats(), idx, n, px, py, n_pix, ctx.cache, 0, ctx.rows,
            ctx.cols, 1.0, 10.0, 0.8)
    before = sc.score_partials.launches
    got = sc.score_partials(*args)
    torch.cuda.synchronize()
    assert sc.score_partials.launches == before + 1
    want = sc.score_partials_reference(*args)
    for i in (1, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=rtol, atol=atol)
    assert int(got[1].max()) > 0


def test_kernel_rejects_bad_inputs_on_card():
    _need_card()
    from lsdtpu_torch.ops import score as sc
    f = torch.zeros((6, 8), device="cuda")
    v = torch.zeros(4, device="cuda")
    n = torch.zeros((), dtype=torch.int32, device="cuda")
    c = torch.zeros((4, 4), device="cuda")
    with pytest.raises(TypeError):
        sc.score_partials(f, None, n, v, v, n, c.double(), 0, 4, 4, 1.0,
                          10.0, 1.0)
    with pytest.raises(ValueError):
        sc.score_partials(f, None, n, v, v, n, c.t(), 0, 4, 4, 1.0, 10.0, 1.0)
    with pytest.raises(ValueError):
        sc.score_partials(f, None, n, v.cpu(), v, n, c, 0, 4, 4, 1.0, 10.0,
                          1.0)


def _synthetic_args(K, P, n_live, n_pix, dtype, idx=False, seed=0):
    """score_partials arguments on the card from a seed: K slots of
    random rigid transforms over a 979x1440 field, P pixel slots."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, K)
    feats = np.stack([np.cos(th), np.sin(th), rng.uniform(300, 600, K),
                      rng.uniform(300, 600, K), rng.uniform(0, 1440, K),
                      rng.uniform(0, 979, K)]).astype(dtype)
    px = rng.uniform(200, 700, P).astype(dtype)
    py = rng.uniform(200, 700, P).astype(dtype)
    cache = rng.uniform(0.0, 1.3, (979, 1440)).clip(max=1.0).astype(dtype)
    dev = "cuda"
    sel = (torch.from_numpy(rng.permutation(K).astype(np.int32)).to(dev)
           if idx else None)
    return (torch.from_numpy(feats).to(dev), sel,
            torch.tensor(n_live, dtype=torch.int32, device=dev),
            torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev),
            torch.tensor(n_pix, dtype=torch.int32, device=dev),
            torch.from_numpy(cache).to(dev), 0, 979, 1440, 1.0, 10.0, 0.8)


def _assert_matches_plain(args, rtol, atol):
    from lsdtpu_torch.ops import score as sc
    got = sc.score_partials(*args)
    torch.cuda.synchronize()
    want = sc.score_partials_reference(*args)
    for i in (1, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=rtol, atol=atol)
    return got


_TOL = {np.float32: (2e-6, 2e-6), np.float64: (1e-12, 1e-12)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K,P,n_live,n_pix,idx", [
    (4096, 4096, 21, 1852, False),     # tracking at the end-to-end cap
    (4096, 4096, 21, 1852, True),
    (2048, 4096, 0, 1852, False),      # no live candidate
    (2048, 4096, 325, 0, True),        # no live pixel
    (2048, 4096, 1072, 1954, False),   # relock, several slots a block
    (2048, 4096, 325, 1954, True),     # survivors, n_surv < K
    (37, 3001, 37, 2999, False),       # n_pix not a multiple of a warp
    (100, 5000, 99, 4999, True),       # more pixels than a block holds
    (16384, 4096, 16000, 1852, True),  # more slots than a block's batch
])
def test_kernel_edges_match_plain_on_card(K, P, n_live, n_pix, idx, dtype):
    """Dead slots exactly zero, ragged counts, the survivor list."""
    _need_card()
    args = _synthetic_args(K, P, n_live, n_pix, dtype, idx=idx, seed=K + P)
    got = _assert_matches_plain(args, *_TOL[dtype])
    for g in got:
        assert not g[n_live:].any()
    if n_live and n_pix:
        assert int(got[1].max()) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_live", [21, 1072])
def test_kernel_repeats_bitwise_on_card(dtype, n_live):
    """50 back-to-back launches give the same bits (each block adds its
    threads, lanes and warps in a fixed order)."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    args = _synthetic_args(4096, 4096, n_live, 1852, dtype, idx=True,
                           seed=n_live)
    runs = [sc.score_partials(*args) for _ in range(50)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    _assert_matches_plain(args, *_TOL[dtype])


def _nfa_cases(dtype):
    """(deg_map, packed scalars) on the card: test_nfa_pallas's 27
    rectangles over its 48x72 field, and 64 rectangles over a 293x432
    field (the data1-sized map's downsampled field)."""
    from lsdtpu_torch.mapprep import nfa as tnfa
    from test_nfa_pallas import _random_rects
    out = []
    for (H, W), n, seed in (((48, 72), 24, 0), ((293, 432), 61, 1)):
        rng = np.random.default_rng(seed)
        deg = rng.uniform(-np.pi, np.pi, size=(H, W)).astype(dtype)
        with np.errstate(all="ignore"):
            sc = np.stack([tnfa.pack_rect_scalars(
                {k: dtype(v) for k, v in r.items()})
                for r in _random_rects(H, W, n=n, seed=seed)])
        out.append((torch.from_numpy(deg).cuda(),
                    torch.from_numpy(sc.astype(dtype)).cuda()))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nfa_kernel_matches_plain_on_card(dtype):
    _need_card()
    from lsdtpu_torch.ops import nfa as onfa
    for deg, sc in _nfa_cases(dtype):
        before = onfa.rect_counts.launches
        got = onfa.rect_counts(deg, sc)
        torch.cuda.synchronize()
        assert onfa.rect_counts.launches == before + 1
        want = onfa.rect_counts_reference(deg, sc)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
        assert int(got[0].max()) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("row0,block,n_rows", [
    (0, None, None), (100, 100, 293), (200, 100, 293), (147, 100, 200),
    (250, 100, 260), (280, 50, 270)])
def test_nfa_kernel_row_block_matches_plain_on_card(dtype, row0, block,
                                                    n_rows):
    """rect_counts on a row block (row0 > 0, a block that crosses n_rows,
    one past it) equals its plain version, counts exact; row0 = 0 with
    n_rows = H is the whole-field launch."""
    _need_card()
    from lsdtpu_torch.ops import nfa as onfa
    deg, sc = _nfa_cases(dtype)[1]
    blk = deg[row0:] if block is None else deg[row0:row0 + block]
    blk = blk.contiguous()
    before = onfa.rect_counts.launches
    got = onfa.rect_counts(blk, sc, row0, n_rows)
    torch.cuda.synchronize()
    assert onfa.rect_counts.launches == before + 1
    want = onfa.rect_counts_reference(blk, sc, row0, n_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if block is None:
        for g, w in zip(got, onfa.rect_counts(deg, sc)):
            assert torch.equal(g, w)


def _nfa_rect(x1, y1, x2, y2, wid, dtype):
    th = np.arctan2(y2 - y1, x2 - x1)
    return {k: dtype(v) for k, v in dict(
        x1=x1, y1=y1, x2=x2, y2=y2, wid=wid, dx=np.cos(th), dy=np.sin(th),
        deg=0.3, prec=0.125 * np.pi).items()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nfa_kernel_shapes_match_plain_on_card(dtype):
    """A vertical rectangle down every row of a 293x432 field, an R = 5
    batch of five trials over one line (an improver phase), non-finite
    slopes and scalars; 50 launches repeat bit for bit."""
    _need_card()
    from lsdtpu_torch.mapprep import nfa as tnfa
    from lsdtpu_torch.ops import nfa as onfa
    H, W = 293, 432
    rng = np.random.default_rng(5)
    deg = torch.from_numpy(rng.uniform(-np.pi, np.pi, (H, W)).astype(dtype)
                           ).cuda()
    full = [_nfa_rect(200.0, -5.0, 200.0, H + 5.0, w, dtype)
            for w in (1.0, 3.0)]
    trials = [_nfa_rect(40.0, 30.0, 41.5, 250.0, w, dtype)
              for w in (1.0, 1.5, 2.0, 2.5, 3.0)]
    with np.errstate(all="ignore"):
        pack = [np.stack([tnfa.pack_rect_scalars(r) for r in rs])
                for rs in (full, trials,
                           [_nfa_rect(10.0, 50.0, 10.0, 50.0, 2.0, dtype),
                            _nfa_rect(-12.0, 7.0, 500.0, 7.0, 4.0, dtype)])]
    odd = pack[1].copy()
    odd[0, 10] = np.inf
    odd[1, 12] = np.nan
    odd[2, 0] = -np.inf
    odd[3, 7] = 3e9
    odd[4, 13] = -np.inf
    for sc in pack + [odd]:
        sc = torch.from_numpy(sc.astype(dtype)).cuda()
        runs = [onfa.rect_counts(deg, sc) for _ in range(50)]
        torch.cuda.synchronize()
        want = onfa.rect_counts_reference(deg, sc)
        for r in runs:
            assert torch.equal(r[0], want[0]) and torch.equal(r[1], want[1])
    full_counts = onfa.rect_counts_reference(
        deg, torch.from_numpy(pack[0].astype(dtype)).cuda())[0]
    assert int(full_counts.min()) >= H


def test_nfa_kernel_rejects_bad_inputs_on_card():
    _need_card()
    from lsdtpu_torch.ops import nfa as onfa
    d = torch.zeros((8, 8), device="cuda")
    s = torch.zeros((2, 16), device="cuda")
    with pytest.raises(TypeError):
        onfa.rect_counts(d, s.double())
    with pytest.raises(ValueError):
        onfa.rect_counts(d[:, ::2], s)
    with pytest.raises(ValueError):
        onfa.rect_counts(d, s.cpu())


def test_prepare_map_card_matches_cpu():
    """A small map through the port's prepare_map on the card and on the
    CPU in f64: the same lines (endpoints within 1e-6 px), the same
    distance field, and one kernel launch per count call."""
    _need_card()
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.ops import nfa as onfa
    from test_fuzz_parity import synth_map
    g = synth_map(1)
    st_cpu, st_gpu = MapPrepStats(), MapPrepStats()
    cpu = prepare_map(g, 0.05, dtype=torch.float64, device="cpu",
                      stats=st_cpu)
    before = onfa.rect_counts.launches
    gpu = prepare_map(g, 0.05, dtype=torch.float64, device="cuda",
                      stats=st_gpu)
    assert gpu.lines_info.is_cuda and gpu.map_cache.is_cuda
    assert onfa.rect_counts.launches - before == st_gpu.nfa_calls \
        == st_cpu.nfa_calls
    assert torch.equal(gpu.map_cache.cpu(), cpu.map_cache)
    a, b = gpu.lines_info.cpu().numpy(), cpu.lines_info.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, 4:8], b[:, 4:8], rtol=0, atol=1e-6)


@pytest.mark.parametrize("storage", ["bf16", "u16", "u8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("window", [False, True])
def test_kernel_storage_types_and_window_match_plain_on_card(storage, dtype,
                                                             window):
    """The compressed fields (dequantized in the gather, at-cap on the
    top code) and a window of the field read in place (row pitch, col0),
    against the plain version on the same inputs."""
    _need_card()
    from lsdtpu_torch.match import associate as tas
    args = list(_synthetic_args(2048, 4096, 1072, 1954, dtype, idx=True,
                                seed=7))
    field = tas.quantize_cache(args[6], storage, 1.0)
    if window:
        r0, c0 = 150, 420
        args[6] = field[r0:r0 + 768, c0:c0 + 768]
        assert not args[6].is_contiguous()
        from lsdtpu_torch.ops import score as sc
        kw = dict(col0=c0)
        args[7] = r0
        got = sc.score_partials(*args, **kw)
        torch.cuda.synchronize()
        want = sc.score_partials_reference(*args, **kw)
        for i in (1, 3):
            assert torch.equal(got[i], want[i])
        for i in (0, 2):
            torch.testing.assert_close(got[i], want[i], rtol=_TOL[dtype][0],
                                       atol=_TOL[dtype][1])
    else:
        args[6] = field
        got = _assert_matches_plain(args, *_TOL[dtype])
    assert int(got[1].max()) > 0 and int(got[3].max()) > 0


def _grow_case(seed, dtype, H=96, W=128):
    """A coherent level-line field with a random ban, on the card."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    part = (xx * 4 // W).astype(int) + 4 * (yy * 3 // H).astype(int)
    base = rng.uniform(-np.pi, np.pi, 12)
    deg = base[part] + 0.01 * xx - 0.007 * yy + rng.normal(0, 0.12, (H, W))
    deg = ((deg + np.pi) % (2 * np.pi) - np.pi).astype(dtype)
    d = torch.from_numpy(deg).cuda()
    ban = torch.from_numpy(rng.random((H, W)) < 0.05).cuda()
    return d, torch.sin(d), torch.cos(d), ban, rng


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_fifo_kernel_matches_plain_on_card(dtype):
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, rng = _grow_case(0, dtype)
    H, W = d.shape
    queue = og.fifo_queue(H, W, "cuda")
    largest = 0
    for k in range(12):
        sy, sx = int(rng.integers(0, H)), int(rng.integers(0, W))
        thre = 0.3927 if k % 2 else torch.tensor(0.55, dtype=d.dtype,
                                                 device="cuda")
        before = og.grow_fifo.launches
        g = og.grow_fifo(sy, sx, thre, ban, d, s, c, queue)
        torch.cuda.synchronize()
        assert og.grow_fifo.launches == before + 1
        n = int(g.counts[0])
        want = og.grow_fifo_reference(
            sy, sx, thre.cpu() if torch.is_tensor(thre) else thre, ban.cpu(),
            d.cpu(), s.cpu(), c.cpu(), og.fifo_queue(H, W, "cpu"))
        assert g.counts.tolist() == want.counts.tolist()
        assert torch.equal(g.cur.cpu(), want.cur)
        assert torch.equal(g.qy[:n].cpu(), want.qy[:n])
        assert torch.equal(g.qx[:n].cpu(), want.qx[:n])
        tol = 1e-12 if dtype == np.float64 else 1e-5
        assert abs(float(g.reg_deg) - float(want.reg_deg)) <= tol
        largest = max(largest, n)
    assert largest > 100


def test_grow_fifo_kernel_repeats_bitwise_and_floods_on_card():
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d = torch.zeros((293, 432), dtype=torch.float64, device="cuda")
    ban = torch.zeros_like(d, dtype=torch.bool)
    s, c = torch.sin(d), torch.cos(d)
    queue = og.fifo_queue(293, 432, "cuda")
    g = og.grow_fifo(100, 200, 0.4, ban, d, s, c, queue)
    assert g.counts.tolist() == [293 * 432, 2 * 293 * 432, 2]
    assert bool(g.cur.all())
    first = g.qy.clone(), g.qx.clone()
    d2, s2, c2, ban2, _ = _grow_case(3, np.float64)
    ref = og.grow_fifo(40, 60, 0.5, ban2, d2, s2, c2)
    n = int(ref.counts[0])
    ref = (ref.cur.clone(), ref.reg_deg.clone(), ref.qy[:n].clone(),
           ref.qx[:n].clone())
    for _ in range(50):
        r = og.grow_fifo(40, 60, 0.5, ban2, d2, s2, c2)
        assert torch.equal(r.cur, ref[0]) and torch.equal(r.reg_deg, ref[1])
        assert torch.equal(r.qy[:n], ref[2]) and torch.equal(r.qx[:n], ref[3])
    assert torch.equal(first[0], g.qy) and torch.equal(first[1], g.qx)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_radius_reducer_fifo_kernel_matches_plain_on_card(dtype):
    """Shrink passes over a grown region's queue, far from the origin
    (the phantom slot drops a point every pass) and at it (never)."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, rng = _grow_case(1, dtype)
    H, W = d.shape
    for sy, sx in ((70, 90), (0, 0)):
        ban[sy, sx] = False
        g = og.grow_fifo(sy, sx, 0.6, ban, d, s, c)
        n = int(g.counts[0])
        assert n > 30
        dev = (g.qy.clone(), g.qx.clone(), g.counts[:1].clone(),
               g.cur.clone(), g.cur.clone())
        cpu = tuple(t.cpu() for t in dev)
        rad = np.dtype(dtype).type(40.0)
        for _ in range(4):
            rad = rad * np.dtype(dtype).type(0.75)
            before = og.radius_reducer_fifo.launches
            og.radius_reducer_fifo(sx, sy, rad, *dev)
            torch.cuda.synchronize()
            assert og.radius_reducer_fifo.launches == before + 1
            og.radius_reducer_fifo_reference(sx, sy, rad, *cpu)
            m = int(cpu[2])
            assert int(dev[2]) == m
            assert torch.equal(dev[0][:n].cpu(), cpu[0][:n])
            assert torch.equal(dev[1][:n].cpu(), cpu[1][:n])
            assert torch.equal(dev[3].cpu(), cpu[3])
            assert torch.equal(dev[4].cpu(), cpu[4])


def _maze_case(dtype, H, W, box, seed):
    """A field whose open cells (angle 0.1 +- 0.01, 75% of the box of
    rows x cols at its top-left corner box[0:2]) grow into one large
    region and whose other cells, each one of six angles 0.9 apart (also
    from 0.1 and across the wrap), form small clusters: every decision
    under the threshold 0.4 is far from it, so the f32 region is exact
    too.  Returns the card's (deg, sin, cos, ban) and a seed cell inside
    the box."""
    rng = np.random.default_rng(seed)
    y0, x0, h, w = box
    levels = np.array([-2.6, -1.7, -0.8, 1.0, 1.9, 2.8])
    deg = levels[rng.integers(0, 6, (H, W))]
    patch = np.where(rng.random((h, w)) < 0.75,
                     0.1 + rng.normal(0, 0.01, (h, w)),
                     levels[rng.integers(0, 6, (h, w))])
    deg[y0:y0 + h, x0:x0 + w] = patch
    sy, sx = y0 + h // 2, x0 + w // 2
    deg[sy, sx] = 0.1
    d = torch.from_numpy(deg.astype(dtype)).cuda()
    ban = torch.from_numpy(rng.random((H, W)) < 0.01).cuda()
    ban[sy, sx] = False
    return d, torch.sin(d), torch.cos(d), ban, (sy, sx)


def _assert_grow_equals_plain(og, sy, sx, thre, d, s, c, ban):
    H, W = d.shape
    g = og.grow_fifo(sy, sx, thre, ban, d, s, c)
    torch.cuda.synchronize()
    n = int(g.counts[0])
    want = og.grow_fifo_reference(sy, sx, thre, ban.cpu(), d.cpu(), s.cpu(),
                                  c.cpu(), og.fifo_queue(H, W, "cpu"))
    assert g.counts.tolist() == want.counts.tolist()
    assert torch.equal(g.cur.cpu(), want.cur)
    assert torch.equal(g.qy[:n].cpu(), want.qy[:n])
    assert torch.equal(g.qx[:n].cpu(), want.qx[:n])
    tol = 1e-12 if d.dtype == torch.float64 else 1e-5
    assert abs(float(g.reg_deg) - float(want.reg_deg)) <= tol
    return g, n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_fifo_kernel_spills_the_shared_queue_on_card(dtype):
    """A region of more pixels than the shared queue holds (its later
    entries live in the global qy/qx): the plain version's region, queue
    and counts."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 200, 200, (0, 0, 200, 200), 4)
    assert og.grow_plan(200, 200).shared_mask
    _g, n = _assert_grow_equals_plain(og, sy, sx, 0.4, d, s, c, ban)
    assert n > og.grow_plan(200, 200).queue_cap


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_fifo_kernel_field_above_bitmap_budget_on_card(dtype):
    """A 1600 x 1600 field, whose bitmap would not fit in shared memory:
    the mask lives in global memory, and a region near the far corner
    that also spills the queue equals the plain version; so does a small
    one at the origin."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 1600, 1600,
                                        (1420, 1390, 180, 150), 5)
    assert not og.grow_plan(1600, 1600).shared_mask
    _g, n = _assert_grow_equals_plain(og, sy, sx, 0.4, d, s, c, ban)
    assert n > og.grow_plan(1600, 1600).queue_cap
    _g, n0 = _assert_grow_equals_plain(og, 0, 0, 0.4, d, s, c, ban)
    assert 1 <= n0 < 1000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_radius_reducer_fifo_kernel_spills_on_card(dtype):
    """Shrink passes over a queue longer than the reducer's shared
    entries (the later slots walked in the global queue), far from the
    origin: the plain version's queue, count and masks."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 200, 200, (0, 0, 200, 200), 6)
    g = og.grow_fifo(sy, sx, 0.4, ban, d, s, c)
    n = int(g.counts[0])
    assert n > og.reduce_plan(g.qy.numel()).cap
    dev = (g.qy.clone(), g.qx.clone(), g.counts[:1].clone(), g.cur.clone(),
           g.cur.clone())
    cpu = tuple(t.cpu() for t in dev)
    rad = np.dtype(dtype).type(120.0)
    for _ in range(4):
        rad = rad * np.dtype(dtype).type(0.75)
        og.radius_reducer_fifo(sx, sy, rad, *dev)
        og.radius_reducer_fifo_reference(sx, sy, rad, *cpu)
        assert int(dev[2]) == int(cpu[2]) < n
        assert torch.equal(dev[0][:n].cpu(), cpu[0][:n])
        assert torch.equal(dev[1][:n].cpu(), cpu[1][:n])
        assert torch.equal(dev[3].cpu(), cpu[3])
        assert torch.equal(dev[4].cpu(), cpu[4])


FIFO_THRE = 0.4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_fifo_kernel_reuses_the_queue_on_card(dtype):
    """One queue through growths of every size, as map prep uses it: each
    region (after a spilling one, a one-pixel one, and a reducer pass on
    a clone of the mask) is the plain version's, in a mask of its own
    that the next call leaves as it was."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 200, 200, (0, 0, 200, 200), 7)
    H, W = d.shape
    queue = og.fifo_queue(H, W, "cuda")
    rng = np.random.default_rng(7)
    seeds = [(sy, sx)] + [(int(rng.integers(0, H)), int(rng.integers(0, W)))
                          for _ in range(6)] + [(sy, sx), (0, 0)]
    sizes, prev = [], None
    for k, (y, x) in enumerate(seeds):
        g = og.grow_fifo(y, x, FIFO_THRE, ban, d, s, c, queue)
        if prev is not None:
            assert torch.equal(prev[0], prev[1].cpu())
        n = int(g.counts[0])
        want = og.grow_fifo_reference(y, x, FIFO_THRE, ban.cpu(), d.cpu(),
                                      s.cpu(), c.cpu(),
                                      og.fifo_queue(H, W, "cpu"))
        assert g.counts.tolist() == want.counts.tolist()
        assert torch.equal(g.cur.cpu(), want.cur)
        assert torch.equal(g.qy[:n].cpu(), want.qy[:n])
        assert torch.equal(g.qx[:n].cpu(), want.qx[:n])
        sizes.append(n)
        prev = want.cur, g.cur
        if k == 0:   # a reducer pass on a clone, as the refiner runs it
            og.radius_reducer_fifo(sx, sy, np.dtype(dtype).type(50.0), g.qy,
                                   g.qx, g.counts[:1].clone(), g.cur.clone(),
                                   g.cur.clone())
    assert sizes[0] > og.grow_plan(H, W).queue_cap and min(sizes) < 10


def test_prepare_map_fifo_card_matches_cpu():
    """FIFO map prep of a small map on the card and on the CPU in f64:
    the same lines (endpoints within 1e-9 px) and one grow_fifo launch
    per growth call."""
    _need_card()
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.ops import grow as og
    from test_fuzz_parity import synth_map
    g = synth_map(1)
    st_cpu, st_gpu = MapPrepStats(), MapPrepStats()
    cpu = prepare_map(g, 0.05, growth="fifo", dtype=torch.float64,
                      device="cpu", stats=st_cpu)
    before = og.grow_fifo.launches
    gpu = prepare_map(g, 0.05, growth="fifo", dtype=torch.float64,
                      device="cuda", stats=st_gpu)
    assert og.grow_fifo.launches - before == st_gpu.fifo_calls \
        == st_cpu.fifo_calls
    assert (st_gpu.pops, st_gpu.passes) == (st_cpu.pops, st_cpu.passes)
    a, b = gpu.lines_info.cpu().numpy(), cpu.lines_info.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, 4:8], b[:, 4:8], rtol=0, atol=1e-9)


def _assert_wave_equals_plain(og, sy, sx, a0, thre, d, s, c, free,
                              queue=None):
    """One grow_wave launch against its plain version on the CPU: the
    same region and counts [n, waves, tests]; reg_deg within 1e-12 in f64
    and 1e-5 in f32 (CUDA's sin, cos and atan2, and the kernel's sums in
    row-major order against torch's order)."""
    before = og.grow_wave.launches
    g = og.grow_wave(sy, sx, a0, thre, free, d, s, c, queue)
    torch.cuda.synchronize()
    assert og.grow_wave.launches == before + 1
    want = og.grow_wave_reference(
        sy, sx, a0.cpu(), thre.cpu() if torch.is_tensor(thre) else thre,
        free.cpu(), d.cpu(), s.cpu(), c.cpu())
    assert g.counts.tolist() == want.counts.tolist()
    assert torch.equal(g.cur.cpu(), want.cur)
    tol = 1e-12 if d.dtype == torch.float64 else 1e-5
    assert abs(float(g.reg_deg) - float(want.reg_deg)) <= tol
    return g


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_wave_kernel_matches_plain_on_card(dtype):
    """Growths from random seeds of a coherent field with a random ban,
    at float and tensor tolerances, from the seed's angle and from
    another one: one launch each, the plain version's region and
    counts."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, rng = _grow_case(0, dtype)
    H, W = d.shape
    free = ~ban
    queue = og.fifo_queue(H, W, "cuda")
    largest = 0
    for k in range(12):
        sy, sx = int(rng.integers(0, H)), int(rng.integers(0, W))
        thre = 0.3927 if k % 2 else torch.tensor(0.55, dtype=d.dtype,
                                                 device="cuda")
        a0 = d[sy, sx] if k % 3 else d[sy, sx] + 0.05
        g = _assert_wave_equals_plain(og, sy, sx, a0, thre, d, s, c, free,
                                      queue)
        largest = max(largest, int(g.counts[0]))
    assert largest > 100


def test_grow_wave_kernel_repeats_bitwise_and_floods_on_card():
    """A launch repeats bit for bit (50 launches); a free field of one
    angle floods whole, a wave a ring."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d = torch.zeros((293, 432), dtype=torch.float64, device="cuda")
    free = torch.ones_like(d, dtype=torch.bool)
    g = _assert_wave_equals_plain(og, 100, 200, d[100, 200], 0.4, d,
                                  torch.sin(d), torch.cos(d), free)
    assert bool(g.cur.all()) and g.counts.tolist()[:2] == [293 * 432, 232]
    d2, s2, c2, ban2, (sy, sx) = _maze_case(np.float64, 200, 200,
                                            (0, 0, 200, 200), 3)
    queue = og.fifo_queue(200, 200, "cuda")
    ref = og.grow_wave(sy, sx, d2[sy, sx], 0.4, ~ban2, d2, s2, c2, queue)
    ref = ref.cur.clone(), ref.reg_deg.clone(), ref.counts.clone()
    assert int(ref[2][0]) > 20000
    for _ in range(50):
        r = og.grow_wave(sy, sx, d2[sy, sx], 0.4, ~ban2, d2, s2, c2, queue)
        assert torch.equal(r.cur, ref[0]) and torch.equal(r.reg_deg, ref[1])
        assert torch.equal(r.counts, ref[2])


def _comb_case(dtype, H, W):
    """Even rows and column 0 at one angle, the other cells a second one
    far from it: growth from (0, 0) runs down the spine and along every
    tooth, and lists every cell between the teeth."""
    deg = np.full((H, W), 1.9)
    deg[::2] = 0.1
    deg[:, 0] = 0.1
    d = torch.from_numpy(deg.astype(dtype)).cuda()
    return d, torch.sin(d), torch.cos(d)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_wave_kernel_spills_the_shared_lists_on_card(dtype,
                                                         monkeypatch):
    """A comb whose candidate list outgrows the shared list (its later
    entries in the global spill buffer), and a maze region under a plan
    of 16 shared entries a list (QUEUE_CAP cut to 16: both lists and the
    block's sort past them): the plain version's region and counts."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    H, W = 200, 400
    d, s, c = _comb_case(dtype, H, W)
    free = torch.ones((H, W), dtype=torch.bool, device="cuda")
    g = _assert_wave_equals_plain(og, 0, 0, d[0, 0], 0.4, d, s, c, free)
    plan = og.wave_plan(H, W)
    listed = int((~g.cur).sum())       # every cell between the teeth
    assert plan.shared_mask and listed > plan.list_cap
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 200, 200, (0, 0, 200, 200), 4)
    monkeypatch.setattr(og, "QUEUE_CAP", 16)
    small = og.wave_plan(200, 200)
    assert small.shared_mask and small.list_cap == small.acc_cap == 16
    g = _assert_wave_equals_plain(og, sy, sx, d[sy, sx], 0.4, d, s, c, ~ban)
    assert int(g.counts[0]) > 20000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_wave_kernel_field_above_bitmap_budget_on_card(dtype):
    """A 1600 x 1600 field, whose bitmaps would not fit in shared memory:
    the state lives in the global mask, and a region near the far corner
    and a small one at the origin equal the plain version."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 1600, 1600,
                                        (1500, 1480, 60, 80), 5)
    assert not og.wave_plan(1600, 1600).shared_mask
    g = _assert_wave_equals_plain(og, sy, sx, d[sy, sx], 0.4, d, s, c, ~ban)
    assert int(g.counts[0]) > 1000
    g = _assert_wave_equals_plain(og, 0, 0, d[0, 0], 0.4, d, s, c, ~ban)
    assert 1 <= int(g.counts[0]) < 1000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grow_wave_kernel_reuses_the_buffers_on_card(dtype):
    """One per-map queue through growths of every size, as map prep uses
    it: each region is the plain version's, in a mask of its own that the
    next call leaves as it was."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    d, s, c, ban, (sy, sx) = _maze_case(dtype, 200, 200, (0, 0, 200, 200), 7)
    H, W = d.shape
    queue = og.fifo_queue(H, W, "cuda")
    rng = np.random.default_rng(7)
    seeds = [(sy, sx)] + [(int(rng.integers(0, H)), int(rng.integers(0, W)))
                          for _ in range(6)] + [(sy, sx), (0, 0)]
    sizes, prev = [], None
    for y, x in seeds:
        g = _assert_wave_equals_plain(og, y, x, d[y, x], FIFO_THRE, d, s, c,
                                      ~ban, queue)
        if prev is not None:
            assert torch.equal(prev[0], prev[1])
        sizes.append(int(g.counts[0]))
        prev = g.cur.clone(), g.cur
    assert sizes[0] > og.wave_plan(H, W).list_cap and min(sizes) < 10


def test_prepare_map_wave_card_matches_cpu():
    """Wave map prep of a small map on the card and on the CPU in f64:
    the same seeds, waves and growth calls, the same lines (endpoints
    within 1e-9 px), and one grow_wave launch per growth call."""
    _need_card()
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.ops import grow as og
    from test_fuzz_parity import synth_map
    g = synth_map(1)
    st_cpu, st_gpu = MapPrepStats(), MapPrepStats()
    cpu = prepare_map(g, 0.05, growth="wave", dtype=torch.float64,
                      device="cpu", stats=st_cpu)
    before = og.grow_wave.launches
    gpu = prepare_map(g, 0.05, growth="wave", dtype=torch.float64,
                      device="cuda", stats=st_gpu)
    assert og.grow_wave.launches - before == st_gpu.wave_calls \
        == st_cpu.wave_calls > 0
    assert (st_gpu.seeds, st_gpu.waves) == (st_cpu.seeds, st_cpu.waves)
    a, b = gpu.lines_info.cpu().numpy(), cpu.lines_info.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, 4:8], b[:, 4:8], rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rectangle_fit_card_equals_cpu_bitwise(dtype):
    """The rectangle fit sums on the device in one fixed order and solves
    its 2x2 system on host scalars: the card's rectangle is the CPU's bit
    for bit, at the map-prep field's size."""
    _need_card()
    from lsdtpu_torch.mapprep import rect
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    rng = np.random.default_rng(5)
    H, W = 293, 432
    mag = torch.from_numpy(rng.uniform(0.1, 3.0, (H, W))).to(dtype)
    yy, xx = np.mgrid[0:H, 0:W]
    cur = torch.from_numpy((np.abs((yy - 140) - 0.37 * (xx - 200)) < 2.5)
                           & (np.abs(xx - 200) < 90))
    seed = torch.tensor(0.35, dtype=dtype)
    want = rect.rectangle_converter(cur, seed, mag, 0.125, 0.3927,
                                    MapPrepStats())
    st = MapPrepStats()
    got = rect.rectangle_converter(cur.cuda(), seed.cuda(), mag.cuda(), 0.125,
                                   0.3927, st)
    assert st.syncs == 2
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_latency_probe_on_card():
    """The chain bound's latencies: positive, an atan2 slower than a
    dependent on-chip load, and an acceptance step (its add, atan2 and
    angle test) no faster than its atan2."""
    _need_card()
    from lsdtpu_torch.ops import grow as og
    lat = og.latency_probe("cuda", steps=512)
    assert set(lat) == {"smem_load", "l1_load", "atan2_float64",
                        "atan2_float32", "accept_float64", "accept_float32",
                        "dist_float64", "dist_float32"}
    assert all(v > 0 for v in lat.values())
    assert lat["atan2_float64"] > min(lat["smem_load"], lat["l1_load"])
    for dt in ("float64", "float32"):
        assert lat[f"accept_{dt}"] >= lat[f"atan2_{dt}"]


# --- the streaming entry point (runtime/online.py), the legacy matcher and
# the pose polish on the card ----------------------------------------------

def _session(seed, mode, dtype, device, cfg=None):
    """An OnlineLocalizer on ``device`` over a synthetic scene's oracle
    artifacts (the z = 2 m field in legacy mode)."""
    from lsdtpu.oracle import lsd as olsd
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    from torch_parity import scene
    ds, art = scene(seed)
    p = ds.param
    cache = art.map_cache if mode == "tracking" else \
        olsd.create_map_cache(ds.map_value, p.resol, 2.0)
    loc = OnlineLocalizer(cfg or DEFAULT, mode=mode, dtype=dtype,
                          device=device)
    loc.set_map_artifacts(art.lines_info, cache, p.resol, p.ori_x, p.ori_y)
    return ds, loc


def _stream(loc, ds, frames=None):
    from torch_parity import INC, ros_scan
    frames = range(len(ds.frames)) if frames is None else frames
    outs = [loc.push_laser_scan(ros_scan(ds.frames[f]), 0.0, INC,
                                ds.odom[f + 1]) for f in frames]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_online_on_card_equals_run_sequence(dtype):
    """Pushing the ROS-shaped scans one at a time on the card gives what
    run_sequence gives on the compacted frames, bit for bit, with one
    CalcScore launch per scan."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.online import laser_scan_to_polar
    from torch_parity import INC, ros_scan
    ds, loc = _session(1, "tracking", dtype, "cuda")
    before = sc.score_partials.launches
    got = _stream(loc, ds)
    assert sc.score_partials.launches - before == len(ds.frames)
    fr = loop.stack_frames(ds, dtype=dtype)
    for f, frame in enumerate(ds.frames):
        r, a = laser_scan_to_polar(ros_scan(frame), 0.0, INC)
        fr["ranges"][f, :len(r)], fr["angles"][f, :len(a)] = r, a
    fr["odom_prev"][0] = fr["odom_cur"][0]
    want = loop.run_sequence(fr, loc.ctx, loc.cfg, device="cuda")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.cpu().numpy(), err_msg=k)


@pytest.mark.parametrize("polish", [False, True])
def test_online_card_matches_cpu_f64(polish):
    """Tracking sessions on the card and the CPU in f64, with and
    without the pose polish: identical decisions, poses within 1e-6 px."""
    _need_card()
    import dataclasses
    from lsdtpu_torch.config import DEFAULT
    cfg = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, polish_pose=polish))
    ds, gpu = _session(0, "tracking", np.float64, "cuda", cfg)
    _, cpu = _session(0, "tracking", np.float64, "cpu", cfg)
    a, b = _stream(gpu, ds), _stream(cpu, ds)
    np.testing.assert_array_equal(a["n_candidates"], b["n_candidates"])
    np.testing.assert_array_equal(np.isfinite(a["score"]),
                                  np.isfinite(b["score"]))
    np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_legacy_card_matches_cpu_f64(seed):
    """The legacy first minimum on the card is the CPU's on every frame:
    the same candidate (the same floored pixel; its heading within 1e-12
    rad, the card's atan ulps) and scores within 1e-12."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    ds, gpu = _session(seed, "legacy", np.float64, "cuda")
    _, cpu = _session(seed, "legacy", np.float64, "cpu")
    before = sc.score_partials.launches
    a, b = _stream(gpu, ds), _stream(cpu, ds)
    assert sc.score_partials.launches == before      # no CalcScore
    np.testing.assert_array_equal(a["pose"][:, :2], b["pose"][:, :2])
    np.testing.assert_allclose(a["pose"][:, 2], b["pose"][:, 2], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(a["n_candidates"], b["n_candidates"])
    np.testing.assert_allclose(a["score"], b["score"], rtol=1e-12)


def test_polish_pose_card_matches_cpu():
    """polish_pose on the card and the CPU (f64): the same accepted
    steps after every number of iterations, poses within 1e-12 px."""
    _need_card()
    from lsdtpu_torch.match import polish
    rng = np.random.default_rng(3)
    H, W = 96, 128
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    field = np.minimum(np.minimum(np.abs(xx - 64), np.abs(yy - 48)) * 0.05,
                       1.0)
    P = 512
    pix = np.zeros((P, 2), np.int32)
    pix[:60, 0] = rng.integers(-20, 25, 60)
    pix[60:120, 1] = rng.integers(-30, 30, 60)
    mask = np.zeros(P, bool)
    mask[:120] = True
    args = [torch.tensor([66.2, 46.3, 2.5], dtype=torch.float64),
            torch.zeros(2, dtype=torch.float64), torch.from_numpy(pix),
            torch.from_numpy(mask), torch.from_numpy(field)]
    for iters in range(7):
        a = polish.polish_pose(*(x.cuda() for x in args), iters=iters)
        b = polish.polish_pose(*args, iters=iters)
        np.testing.assert_allclose(a[0].cpu().numpy(), b[0].numpy(), rtol=0,
                                   atol=1e-12, err_msg=f"iters={iters}")


def test_checkpoint_resume_on_card(tmp_path):
    """A session saved on the card resumes on the card bit for bit, and
    on the CPU within the rollout tier."""
    _need_card()
    ds, ref = _session(0, "tracking", np.float64, "cuda")
    want = _stream(ref, ds)
    _, a = _session(0, "tracking", np.float64, "cuda")
    _stream(a, ds, range(4))
    path = str(tmp_path / "state.npz")
    a.save(path)
    F = len(ds.frames)
    _, b = _session(0, "tracking", np.float64, "cuda")
    b.restore(path)
    assert b.state.kalman_x.is_cuda
    got = _stream(b, ds, range(4, F))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k][4:], err_msg=k)
    _, c = _session(0, "tracking", np.float64, "cpu")
    c.restore(path)
    np.testing.assert_allclose(_stream(c, ds, range(4, F))["pose"],
                               want["pose"][4:], rtol=0, atol=1e-6)


# --- the lane-batched CalcScore launch, batched rollouts and the serving
# pool on the card -----------------------------------------------------------

def _lane_args(dtype, storage, idx, B=5, K=2048, P=4096, seed=11):
    """score_partials_batched arguments on the card: B lanes of random
    rigid transforms over a (B, 979, 1440) canvas whose lanes hold maps
    of their own extents (each padded with the cap), ragged live counts
    (a relocking lane of 1072 beside tracking lanes of ~21, an empty
    lane)."""
    from lsdtpu_torch.match import associate as tas
    rng = np.random.default_rng(seed)
    H, W = 979, 1440
    rows = np.array([979, 700, 979, 512, 300][:B], np.int32)
    cols = np.array([1440, 1440, 900, 700, 300][:B], np.int32)
    th = rng.uniform(-np.pi, np.pi, (B, K))
    feats = np.stack([np.cos(th), np.sin(th), rng.uniform(300, 600, (B, K)),
                      rng.uniform(300, 600, (B, K)),
                      rng.uniform(0, 1440, (B, K)),
                      rng.uniform(0, 979, (B, K))], 1).astype(dtype)
    px = rng.uniform(200, 700, (B, P)).astype(dtype)
    py = rng.uniform(200, 700, (B, P)).astype(dtype)
    cache = np.ones((B, H, W), dtype)
    for b in range(B):
        cache[b, :rows[b], :cols[b]] = rng.uniform(
            0.0, 1.3, (rows[b], cols[b])).clip(max=1.0)
    n_cand = np.array([1072, 21, 25, 0, 19][:B], np.int32)
    n_pix = np.array([1954, 1852, 1800, 1700, 4000][:B], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    sel = (t(np.stack([rng.permutation(K) for _ in range(B)])
             .astype(np.int32)) if idx else None)
    field = tas.quantize_cache(t(cache), storage, 1.0,
                               float_dtype=t(px).dtype).contiguous()
    return (t(feats), sel, t(n_cand), t(px), t(py), t(n_pix), field,
            t(rows), t(cols), 1.0, 10.0, 0.8)


@pytest.mark.parametrize("storage", ["f32", "bf16", "u16", "u8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("idx", [False, True])
def test_batched_kernel_matches_plain_and_single_lanes_on_card(storage,
                                                               dtype, idx):
    """One launch for all lanes equals its plain version (counts exact,
    sums within the kernel tier) and, lane by lane, a single-lane launch
    on that lane's inputs bit for bit; dead slots are zero per lane."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    args = _lane_args(dtype, storage, idx)
    cand, sel, n_cand, px, py, n_pix, field, rows, cols = args[:9]
    before = sc.score_partials_batched.launches
    got = sc.score_partials_batched(*args)
    torch.cuda.synchronize()
    assert sc.score_partials_batched.launches == before + 1
    want = sc.score_partials_batched_reference(*args)
    for i in (1, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=_TOL[dtype][0],
                                   atol=_TOL[dtype][1])
    for b in range(cand.shape[0]):
        one = sc.score_partials(cand[b], None if sel is None else sel[b],
                                n_cand[b:b + 1], px[b], py[b], n_pix[b:b + 1],
                                field[b], 0, int(rows[b]), int(cols[b]),
                                *args[9:])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
            assert not g[b, int(n_cand[b]):].any()
    assert int(got[1][0].max()) > 0
    # 50 repeats give the same bits
    for _ in range(50):
        again = sc.score_partials_batched(*args)
    torch.cuda.synchronize()
    for a, g in zip(again, got):
        assert torch.equal(a, g)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_batched_kernel_row_block_matches_plain_on_card(dtype, storage):
    """The lane-batched launch over the row block [row0, row0 + 245) of
    every lane's field (a map-block-sharded rank's launch; lanes whose
    map ends inside or before the block) equals its plain version, and the
    four blocks' partials add up to the whole canvas's (counts exact)."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    args = _lane_args(dtype, storage, False)
    field = args[6]
    H = field.shape[1]
    bh = -(-H // 4)
    whole = sc.score_partials_batched(*args)
    acc = [torch.zeros_like(w) for w in whole]
    for row0 in range(0, H, bh):
        blk = field[:, row0:row0 + bh].contiguous()
        a = (*args[:6], blk, *args[7:])
        before = sc.score_partials_batched.launches
        got = sc.score_partials_batched(*a, row0=row0)
        torch.cuda.synchronize()
        assert sc.score_partials_batched.launches == before + 1
        want = sc.score_partials_batched_reference(*a, row0=row0)
        for i in (1, 3):
            assert torch.equal(got[i], want[i])
        for i in (0, 2):
            torch.testing.assert_close(got[i], want[i], rtol=_TOL[dtype][0],
                                       atol=_TOL[dtype][1])
        acc = [x + g for x, g in zip(acc, got)]
    for i in (1, 3):
        assert torch.equal(acc[i], whole[i])
    # four block sums added against one sum over all pixels: another
    # order, so f32 carries a few more ulps than one launch's tier
    tol = (1e-5, 1e-5) if dtype == np.float32 else _TOL[dtype]
    for i in (0, 2):
        torch.testing.assert_close(acc[i], whole[i], rtol=tol[0],
                                   atol=tol[1])


def test_batched_kernel_rejects_bad_inputs_on_card():
    _need_card()
    from lsdtpu_torch.ops import score as sc
    args = list(_lane_args(np.float32, "f32", False, B=2, K=64, P=128))
    with pytest.raises(TypeError):          # rows must be int32 (B,)
        sc.score_partials_batched(*args[:7], args[7].long(), *args[8:])
    with pytest.raises(ValueError):         # a canvas per lane
        sc.score_partials_batched(*args[:6], args[6][:1], *args[7:])
    with pytest.raises(ValueError):         # one device
        sc.score_partials_batched(*args[:3], args[3].cpu(), *args[4:])


def test_run_batch_lanes_match_solo_rollouts_on_card():
    """run_batch on the card (one batched CalcScore launch a frame)
    against each lane's solo run_sequence on the card, f64: identical
    decisions, poses within 1e-6 px (the f64 rollout's tier)."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import batch as tbatch
    from lsdtpu_torch.runtime import loop
    from torch_parity import lane_scenes
    dss, arts = lane_scenes()
    fr, ctx, lens = tbatch.stack_batch(dss, arts, dtype=np.float64,
                                       device="cuda")
    before = sc.score_partials_batched.launches
    got = {k: v.cpu().numpy() for k, v in
           tbatch.run_batch(fr, ctx, device="cuda").items()}
    assert sc.score_partials_batched.launches - before == fr["n"].shape[1]
    for b, (ds, art) in enumerate(zip(dss, arts)):
        p = ds.param
        c1 = loop.make_map_context(art[0], art[1], p.resol, p.ori_x, p.ori_y,
                                   dtype=np.float64, device="cuda")
        solo = {k: v.cpu().numpy() for k, v in loop.run_sequence(
            loop.stack_frames(ds, dtype=np.float64), c1,
            device="cuda").items()}
        L = lens[b]
        np.testing.assert_array_equal(got["n_candidates"][b, :L],
                                      solo["n_candidates"])
        np.testing.assert_array_equal(np.isfinite(got["score"][b, :L]),
                                      np.isfinite(solo["score"]))
        np.testing.assert_allclose(got["pose"][b, :L], solo["pose"], rtol=0,
                                   atol=1e-6)


def test_pool_matches_online_sessions_on_card():
    """SessionPool on the card against per-robot OnlineLocalizer sessions
    on the card, f64: identical decisions, poses within 1e-6 px."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    from lsdtpu_torch.runtime.serving import SessionPool
    from torch_parity import lane_scenes
    dss, arts = lane_scenes()
    pool = SessionPool(4, (200, 260), dtype=np.float64, device="cuda")
    locs = {}
    for i in (0, 1):
        p = dss[i].param
        args = (arts[i][0], arts[i][1], p.resol, p.ori_x, p.ori_y)
        pool.open_session(str(i), *args)
        locs[str(i)] = OnlineLocalizer(dtype=np.float64, device="cuda")
        locs[str(i)].set_map_artifacts(*args)
    before = sc.score_partials_batched.launches
    for f in range(6):
        want = {}
        for sid, loc in locs.items():
            ds = dss[int(sid)]
            scan = (ds.frames[f][:, 0], ds.frames[f][:, 1], ds.odom[f + 1])
            pool.submit_scan(sid, *scan)
            want[sid] = loc.push_scan(*scan)
        got = pool.step()
        for sid in locs:
            assert got[sid]["n_candidates"] == want[sid]["n_candidates"]
            np.testing.assert_allclose(got[sid]["pose"], want[sid]["pose"],
                                       rtol=0, atol=1e-6)
    assert sc.score_partials_batched.launches - before == 6


# --- refinement, the stage timer and the CLI on the card --------------------

def test_refine_card_matches_cpu_f64():
    """The pose-graph solve on the card against the CPU in f64 (cuSOLVER's
    and LAPACK's LU differ in the last ulps): within 1e-9 px/deg,
    sequential and segment-parallel, lost frames included."""
    _need_card()
    from lsdtpu_torch.refine import pose_graph
    rng = np.random.default_rng(5)
    F = 96
    t = np.arange(F)
    truth = np.stack([10 + 2.0 * t, 5 + 1.5 * t, 3.7 * t - 170], 1)
    u = np.diff(truth, axis=0, prepend=truth[:1])
    u[0] = 0
    meas = truth + rng.normal(0, 1.5, (F, 3))
    meas[:, 2] = (meas[:, 2] + 180) % 360 - 180
    scores = rng.uniform(0.05, 1.0, F)
    scores[20:31] = np.inf
    meas[20:31] = np.nan
    for P in (1, 8):
        if P == 1:
            fn = pose_graph.refine_trajectory
        else:
            fn = lambda *a, **k: pose_graph.refine_trajectory_distributed(
                *a, n_segments=P, **k)
        a, ia = fn(meas, scores, u, device="cuda")
        b, ib = fn(meas, scores, u, device="cpu")
        assert a.is_cuda and a.dtype == torch.float64
        a, b = a.cpu().numpy(), b.numpy()
        np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=0, atol=1e-9)
        d = (a[:, 2] - b[:, 2] + 180) % 360 - 180
        assert np.abs(d).max() <= 1e-9, (P, np.abs(d).max())
        assert int(ia["n_measured"]) == int(ib["n_measured"]) == F - 11


def test_stage_timings_on_card():
    """Every stage timed on the card; the score stage launches the
    CalcScore kernel once a repeat."""
    _need_card()
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop, trace
    from torch_parity import scene
    ds, art = scene(1)
    ctx = loop.make_map_context(art.lines_info, art.map_cache,
                                ds.param.resol, ds.param.ori_x,
                                ds.param.ori_y, device="cuda")
    fr = loop.stack_frames(ds)
    before = sc.score_partials.launches
    st = trace.stage_timings(tuple(fr[k][3] for k in loop._FRAME_KEYS), ctx,
                             repeats=3, device="cuda")
    assert sorted(st) == ["candidates_ms", "featurize_ms", "fuse_ms",
                          "score_ms", "ukf_ms"]
    assert all(np.isfinite(v) and v > 0 for v in st.values()), st
    assert sc.score_partials.launches - before == 4


def test_cli_run_on_card(tmp_path, capsys):
    """`lsdtpu-torch run` on the card (the default device): 10 records,
    one CalcScore launch a frame, the map prep's NFA and FIFO kernels
    launched, and the records equal the library rollout on the same
    artifacts."""
    _need_card()
    import json
    from lsdtpu_torch import cli
    from lsdtpu_torch.io import load_dataset
    from lsdtpu_torch.ops import grow, nfa
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop
    from lsdtpu_torch.runtime.artifacts import prepare_map_cached
    from lsdtpu_torch.runtime.online import to_host
    from torch_parity import write_dataset
    data = tmp_path / "data"
    data.mkdir()
    write_dataset(data, 1, F=10)
    ds = load_dataset(str(data))
    cache_dir = str(tmp_path / "cache")
    for w in (sc.score_partials, nfa.rect_counts, grow.grow_fifo):
        w.launches = 0
    assert cli.main(["run", "--data", str(data), "--cache-dir",
                     cache_dir, "--frames", "10"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == 10
    assert sc.score_partials.launches == 10
    assert nfa.rect_counts.launches > 0 and grow.grow_fifo.launches > 0
    lines, cache = prepare_map_cached(ds.map_value, ds.param.resol,
                                      cache_dir=cache_dir, device="cuda",
                                      growth="fifo")
    ctx = loop.make_map_context(lines, cache, ds.param.resol,
                                ds.param.ori_x, ds.param.ori_y,
                                device="cuda")
    out = to_host(loop.run_sequence(loop.stack_frames(ds), ctx))
    for f, rec in enumerate(recs):
        assert rec["pose"] == [round(float(v), 3) for v in out["pose"][f]]
        assert rec["n_candidates"] == int(out["n_candidates"][f])
