"""The lineIm rasterizer of the port (lsdtpu_torch/render.py) bit-exact
against the JAX package's (lsdtpu/render.py) on the CPU: random lines
that leave the canvas, lines on row and column 0, near-vertical and
degenerate lines, the port's own LSD lines on their map, and masked
rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu import geometry as jgeo
from lsdtpu.render import render_line_image as jrender
from lsdtpu_torch.mapprep.pipeline import prepare_map
from lsdtpu_torch.render import render_line_image as trender

from test_fuzz_parity import synth_map


def _both(lines, mask, rows, cols, max_steps=None):
    with np.errstate(all="ignore"):
        want = np.asarray(jrender(jnp.asarray(lines), jnp.asarray(mask), rows,
                                  cols, max_steps=max_steps))
    got = trender(torch.as_tensor(lines), torch.as_tensor(mask), rows, cols,
                  max_steps=max_steps)
    assert got.dtype == torch.uint8 and got.shape == (rows, cols)
    return got.numpy(), want


def _lines(ends):
    e = jnp.asarray(np.asarray(ends, np.float64))
    with np.errstate(all="ignore"):
        return np.asarray(jgeo.lines_info_from_endpoints(e[:, 0], e[:, 1],
                                                         e[:, 2], e[:, 3]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_lines_bit_exact(seed):
    rng = np.random.default_rng(seed)
    rows, cols = 48, 64
    ends = rng.uniform(-15, 80, (40, 4))
    ends[:5] = [[3.0, 0.0, 40.0, 0.0],          # along row 0
                [0.0, 2.0, 0.0, 40.0],          # along column 0
                [10.0, 3.0, 10.4, 45.0],        # near-vertical
                [20.0, 5.0, 20.0, 30.0],        # vertical (k = inf)
                [7.0, 7.0, 7.0, 7.0]]           # degenerate (k = 0/0)
    mask = rng.random(40) < 0.9
    mask[:5] = True
    got, want = _both(_lines(ends), mask, rows, cols)
    np.testing.assert_array_equal(got, want)
    assert (got == 255).sum() > 200 and set(np.unique(got)) <= {0, 255}
    assert not got[0].any() or want[0].any()


def test_short_step_cap_bit_exact():
    """A max_steps below a line's run truncates both the same way."""
    ends = [[2.0, 2.0, 60.0, 30.0], [5.0, 40.0, 6.0, 1.0]]
    got, want = _both(_lines(ends), np.ones(2, bool), 48, 64, max_steps=20)
    np.testing.assert_array_equal(got, want)


def test_port_lsd_lines_bit_exact():
    """The port's FIFO LSD lines rendered on their own map."""
    g = synth_map(1)
    art = prepare_map(g, 0.05, growth="fifo", dtype=torch.float64,
                      device="cpu")
    lines = art.lines_info.numpy()
    got, want = _both(lines, np.ones(len(lines), bool), *g.shape)
    np.testing.assert_array_equal(got, want)
    # the walls are drawn
    assert (got == 255).sum() > g.shape[0] + g.shape[1]
