"""lsdtpu_torch.mapprep.distance.create_map_cache bit-exact against
lsdtpu.mapprep.distance on test_fuzz_parity's synthetic maps, and the
port's synthetic-scene generator against the fuzz test's."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsdtpu.mapprep.distance import create_map_cache as jcache
from lsdtpu_torch.io import synth
from lsdtpu_torch.mapprep.distance import create_map_cache as tcache

from test_fuzz_parity import synth_dataset, synth_map


@pytest.mark.parametrize("seed", range(5))
def test_map_cache_bit_exact(seed):
    g = synth_map(seed)
    want = np.asarray(jcache(jnp.asarray(g), 0.05, 1.0))
    got = tcache(g, 0.05, 1.0, device="cpu").numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_map_cache_other_cap_and_resolution():
    g = synth_map(7)
    want = np.asarray(jcache(jnp.asarray(g), 0.025, 0.7))
    np.testing.assert_array_equal(
        tcache(g, 0.025, 0.7, device="cpu").numpy(), want)


@pytest.mark.parametrize("seed", [0, 3, 101])
def test_synth_reproduces_fuzz_scenes(seed):
    want = synth_dataset(seed)
    sc = synth.synth_dataset(seed)
    got = sc.dataset
    np.testing.assert_array_equal(got.map_value, want.map_value)
    np.testing.assert_array_equal(got.odom, want.odom)
    assert len(got.frames) == len(want.frames)
    for a, b in zip(got.frames, want.frames):
        np.testing.assert_array_equal(a, b)
    assert got.param == synth.MapParam(*want.param.__dict__.values())
    # the wall segments it reports are the occupied cells it drew
    g = np.zeros_like(got.map_value)
    for x1, y1, x2, y2 in sc.walls.astype(int):
        g[y1:y2 + 1, x1:x2 + 1] = 1
    np.testing.assert_array_equal(g == 1, got.map_value == 1)
    assert sc.true_pos.shape == (len(got.frames), 2)
