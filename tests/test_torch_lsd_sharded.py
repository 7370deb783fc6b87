"""Row-block-sharded map lines: lsdtpu_torch.mapprep.lsd_sharded against
the port's single-card LSD and against lsdtpu.mapprep.lsd_sharded, on
synthetic maps (CPU).

The sharded prologue (remap, Gaussian downsample, gradient) is the
unsharded one bit for bit, in this process with several slabs (also on
small and skewed maps where tail slabs are all padding) and over two
spawned gloo ranks.  The sharded wave seed walk over two ranks - a full
map and one whose downsampled height is odd (padding rows prebanned and
cut from the NFA counts by n_rows), f64 and f32 - gives the single-card
wave tier's lines at tests/test_lsd_sharded.py's thresholds (the same
count and mask, endpoints within rtol 1e-4 / atol 1e-3: block sums
psummed against whole-field sums), the same remapped map, and the same
lines as the JAX package's sharded walk on the same field (the port's
field: the JAX blur turns level lines where the reference's gx is 0,
ROADMAP.md Queue 3).  FIFO growth is refused."""

import functools
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu import geometry as jgeo
from lsdtpu.mapprep import lsd_sharded as jls
from lsdtpu_torch.mapprep import lsd as tlsd
from lsdtpu_torch.mapprep import lsd_sharded as tls
from lsdtpu_torch.mapprep.gaussian import gaussian_sampler
from lsdtpu_torch.mapprep.gradient import gradient_field
from lsdtpu_torch.mapprep.stats import MapPrepStats

import torch_ranks
from test_fuzz_parity import synth_map
from torch_parity import port_field, remap

DEG_THRE = 22.5 / 180.0 * math.pi
MAPS = {"full": lambda: synth_map(0), "odd_rows": lambda: synth_map(1)[:187]}
TIER = dict(rtol=1e-4, atol=1e-3)      # tests/test_lsd_sharded.py


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    jobs = [("lsd", dict(grid=MAPS["full"](), dtype="float64")),
            ("lsd", dict(grid=MAPS["odd_rows"](), dtype="float64")),
            ("lsd", dict(grid=MAPS["full"](), dtype="float32")),
            ("prologue", dict(grid=MAPS["odd_rows"](), blocks_per_device=2))]
    group = torch_ranks.Group(tmp_path_factory.mktemp("ranks"), 2, jobs)
    return jobs, group


def _unsharded_prologue(grid, dtype):
    gauss = gaussian_sampler(torch.from_numpy(remap(grid)).to(dtype))
    return gradient_field(gauss, DEG_THRE)


@pytest.mark.parametrize("shape,blocks", [((200, 260), 3), ((41, 333), 4),
                                          ((96, 96), 2), ((267, 55), 5)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_prologue_bitwise(shape, blocks, dtype):
    rng = np.random.default_rng(sum(shape))
    grid = np.full(shape, 255, np.uint8)
    grid[rng.random(shape) < 0.05] = 1
    if shape == (200, 260):
        grid = synth_map(2)
    rm, mag, deg, ban, mg, new = tls.prologue_sharded(
        grid, 0.3, 0.6, DEG_THRE, blocks_per_device=blocks, dtype=dtype,
        device="cpu")
    want = _unsharded_prologue(grid, dtype)
    np.testing.assert_array_equal(rm, remap(grid))
    for g, w in zip((mag, deg, ban, mg), want):
        assert torch.equal(g, w)
    assert new == tuple(want[0].shape)


def test_prologue_two_ranks_bitwise(two_ranks):
    jobs, group = two_ranks
    grid = jobs[3][1]["grid"]
    want = _unsharded_prologue(grid, torch.float64)
    for r in group.results():
        rm, mag, deg, ban, mg, _new = r[3]
        np.testing.assert_array_equal(rm, remap(grid))
        for g, w in zip((mag, deg, ban, mg), want):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("job", [0, 1, 2])
def test_two_ranks_match_single_card_wave(two_ranks, job):
    jobs, group = two_ranks
    kw = jobs[job][1]
    dt = getattr(torch, kw["dtype"])
    st = MapPrepStats()
    wl, wm, wn, wr = tlsd.line_segment_detector(kw["grid"], dtype=dt,
                                                device="cpu", stats=st)
    assert wn > 5
    for r in group.results():
        got = r[job]
        assert got["n"] == wn
        np.testing.assert_array_equal(got["mask"], wm.numpy())
        np.testing.assert_allclose(got["lines"][:wn, 4:8],
                                   wl.numpy()[:wn, 4:8], **TIER)
        np.testing.assert_array_equal(got["remapped"], wr.numpy())
        assert got["seeds"] == st.seeds and got["nfa_calls"] == st.nfa_calls


@functools.lru_cache(maxsize=None)
def _jax_walk(n_dev, shape):
    return jls._runner(jls.make_mesh_lsd(n_dev), 0.3, 0.6, 22.5, 0.7, 1024,
                       256, "xla")


def test_lines_match_jax_sharded_on_same_field(two_ranks):
    """The JAX package's row-block-sharded walk over 4 virtual devices on
    the port's field (odd downsampled height, padded as its detector pads)
    against the port's walk over two ranks."""
    jobs, group = two_ranks
    grid = jobs[1][1]["grid"]
    mag, deg, ban, mg = (t.numpy() for t in port_field(grid))
    H, W = mag.shape
    pad = (-H) % 4
    args = (np.pad(mag, ((0, pad), (0, 0))), np.pad(deg, ((0, pad), (0, 0))),
            np.pad(ban, ((0, pad), (0, 0)), constant_values=True),
            np.reshape(mg, (1,)),
            np.full((1,), 5 * (math.log10(H) + math.log10(W)) / 2.0),
            np.full((1,), H, np.int32))
    with jls.make_mesh_lsd(4):
        ends, n = _jax_walk(4, mag.shape)(*args)
    n = int(n)
    e = np.asarray(ends)[:n]
    want = np.asarray(jgeo.lines_info_from_endpoints(
        jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]), jnp.asarray(e[:, 2]),
        jnp.asarray(e[:, 3])))
    got = group.results()[0][1]
    assert got["n"] == n > 5
    np.testing.assert_allclose(got["lines"][:n, 4:8], want[:, 4:8], **TIER)


def test_fifo_rejected():
    mag = torch.ones((8, 8), dtype=torch.float64)
    # a row block of two ranks; the walk raises before any collective, so
    # a stand-in axis will do
    two_ranks = types.SimpleNamespace(size=2, index=0)
    with pytest.raises(ValueError, match="fifo"):
        tlsd._seed_walk(mag, mag, mag > 2, torch.tensor(1.0), 5.0, 1.0, 22.5,
                        0.7, 1024, 16, MapPrepStats(), growth="fifo",
                        axis=two_ranks)
    with pytest.raises(ValueError, match="fifo"):
        tls.line_segment_detector_sharded(synth_map(0), growth="fifo",
                                          device="cpu")
