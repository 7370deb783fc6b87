"""lsdtpu_torch.scan.featurize against lsdtpu.scan.featurize (f64, CPU)
on every frame of test_fuzz_parity's synthetic scenes.

Tier: pixels, masks, counts and the overflow flag identical; line rows
within 1e-9 (their direction fields go through sin/cos/arctan, where
XLA's and torch's CPU results differ by an ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.scan.featurize import featurize as jfeat
from lsdtpu_torch.scan.featurize import featurize as tfeat

from torch_parity import frames, np_, scene

KW = dict(least_point=3, thre_line=0.08, least_dist=0.5, max_lines=64,
          max_pixels=4096, max_steps=512)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_featurize_matches_jax(seed):
    ds, _ = scene(seed)
    fr = frames(seed)
    p = ds.param
    for f in range(fr["ranges"].shape[0]):
        args = [fr[k][f] for k in ("ranges", "angles", "valid", "n")]
        want = jfeat(*(jnp.asarray(a) for a in args),
                     jnp.asarray(p.resol), jnp.asarray(p.ori_x),
                     jnp.asarray(p.ori_y), **KW)
        dt = torch.float64
        got = tfeat(*(torch.as_tensor(a) for a in args),
                    torch.tensor(p.resol, dtype=dt),
                    torch.tensor(p.ori_x, dtype=dt),
                    torch.tensor(p.ori_y, dtype=dt), **KW)
        for k in ("pixels", "pixels_mask", "lines_mask", "n_pixels",
                  "overflow", "lidar_pos"):
            np.testing.assert_array_equal(np_(getattr(got, k)),
                                          np_(getattr(want, k)),
                                          err_msg=f"frame {f} {k}")
        np.testing.assert_allclose(np_(got.lines), np_(want.lines),
                                   rtol=0, atol=1e-9,
                                   err_msg=f"frame {f} lines")
        assert int(got.n_pixels) > 0 and bool(got.lines_mask.any())


def test_featurize_flags_pixel_overflow():
    """A pixel cap below the frame's pixel count truncates and flags."""
    ds, _ = scene(0)
    fr = frames(0)
    p = ds.param
    dt = torch.float64
    args = [torch.as_tensor(fr[k][0]) for k in ("ranges", "angles", "valid",
                                                 "n")]
    kw = dict(KW, max_pixels=64)
    got = tfeat(*args, torch.tensor(p.resol, dtype=dt),
                torch.tensor(p.ori_x, dtype=dt),
                torch.tensor(p.ori_y, dtype=dt), **kw)
    assert bool(got.overflow) and int(got.n_pixels) > 64
    assert bool(got.pixels_mask.all())
