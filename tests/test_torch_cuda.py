"""The CalcScore kernel (lsdtpu_torch/csrc/score.cu) against its plain
PyTorch version on the card.  Marked ``cuda``: each test decides inside
itself whether a card is present and skips where there is none.  Run on
the card with ``python -m pytest -m cuda tests/test_torch_*.py``.

Tiers: counts exact; f64 sums rtol 1e-12; f32 sums rtol/atol 2e-6
(different summation order)."""

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
