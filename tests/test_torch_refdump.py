"""Reference-format dumps: lsdtpu_torch.io.refdump writes the same bytes
as lsdtpu.io.refdump on the same arrays, and its files read back
(lines and field exactly to %.15g, within rel 1e-14; the line image
with the 1-based shift)."""

import os

import numpy as np
import pytest
import torch

from lsdtpu.io import refdump as jdump
from lsdtpu_torch.io import loaders as tio
from lsdtpu_torch.io import refdump as tdump
from lsdtpu_torch.render import render_line_image

from torch_parity import scene


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _arrays(seed):
    """(lines, field, lineIm) of a synthetic scene (oracle artifacts,
    the port's rasterizer)."""
    ds, art = scene(seed)
    H, W = ds.map_value.shape
    img = render_line_image(torch.as_tensor(art.lines_info),
                            torch.ones(len(art.lines_info), dtype=torch.bool),
                            H, W).numpy()
    return art.lines_info, art.map_cache, img


@pytest.mark.parametrize("seed", [0, 2])
def test_dump_bytes_match_reference(tmp_path, seed):
    lines, cache, img = _arrays(seed)
    got = tdump.dump_map_artifacts(str(tmp_path / "port"), lines, cache, img)
    want = jdump.dump_map_artifacts(str(tmp_path / "jax"), lines, cache, img)
    assert sorted(got) == sorted(want) == ["line_im", "lines_info",
                                           "map_cache"]
    for k in got:
        assert os.path.basename(got[k]) == os.path.basename(want[k])
        assert _bytes(got[k]) == _bytes(want[k]), k


def test_writers_match_reference_with_mask_and_no_shift(tmp_path):
    rng = np.random.default_rng(0)
    lines = rng.normal(size=(17, 10)) * 100
    mask = rng.random(17) > 0.4
    img = (rng.random((9, 13)) > 0.7).astype(np.uint8) * 255
    for name, fn, args in (
            ("lines.txt", "save_lines_info", (lines, mask)),
            ("img.txt", "save_line_im", (img, False)),
            ("grid.txt", "save_grid", (img, "%d"))):
        p, q = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        getattr(tdump, fn)(p, *args)
        getattr(jdump, fn)(q, *args)
        assert _bytes(p) == _bytes(q), fn


def test_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    lines = rng.normal(size=(17, 10)) * 100
    p = str(tmp_path / "lines.txt")
    assert tdump.save_lines_info(p, lines) == 17
    np.testing.assert_allclose(tio.load_lines_info(p), lines, rtol=1e-14,
                               atol=0)
    assert tdump.save_lines_info(p, lines, lines[:, 0] > 0) == \
        int((lines[:, 0] > 0).sum())
    cache = rng.uniform(0, 1, (37, 53))
    p = str(tmp_path / "mapCache.txt")
    tdump.save_map_cache(p, cache)
    np.testing.assert_allclose(tdump.load_map_cache(p), cache, rtol=1e-14)
    # float32 artifacts come back exactly once cast to float32
    c32 = cache.astype(np.float32)
    tdump.save_map_cache(p, c32)
    np.testing.assert_array_equal(tdump.load_map_cache(p).astype(np.float32),
                                  c32)


def test_line_im_shift(tmp_path):
    _, _, img = _arrays(0)
    p = str(tmp_path / "MaplineIm.txt")
    tdump.save_line_im(p, img)
    back = np.loadtxt(p, dtype=np.int64)
    assert back.shape == img.shape and set(np.unique(back)) <= {0, 1}
    np.testing.assert_array_equal(back[:-1, :-1], img[1:, 1:] > 0)
    assert not back[-1].any() and not back[:, -1].any()
