"""The CalcScore kernel (lsdtpu_torch/csrc/score.cu) and the NFA
rect_counts kernel (lsdtpu_torch/csrc/nfa.cu) against their plain
PyTorch versions on the card, and map prep on the card against the CPU.
Marked ``cuda``: each test decides inside itself whether a card is
present and skips where there is none.  Run on the card with
``python -m pytest -m cuda tests/test_torch_*.py``.

Tiers: counts exact; f64 sums rtol 1e-12; f32 sums rtol/atol 2e-6
(different summation order); repeated launches bitwise equal; f64 map lines card vs CPU within 1e-6 px
(CUDA's sin/cos/atan2 and reduction order differ from the CPU's)."""

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
