"""lsdtpu_torch.io.loaders against lsdtpu.io.loaders on a dataset
directory written from a synthetic scene (the reference file formats)."""

import numpy as np
import pytest

from lsdtpu.io import loaders as jio
from lsdtpu.io import native as jnative
from lsdtpu_torch.io import loaders as tio

from torch_parity import write_dataset


@pytest.mark.parametrize("seed,suffix", [(0, ""), (2, "_map1")])
def test_load_dataset_matches_reference_loader(tmp_path, monkeypatch, seed,
                                               suffix):
    src = write_dataset(tmp_path, seed, suffix)
    # the reference loader's numpy path (this keeps the test from
    # building the reference package's extension); the port's loader
    # takes its own route (native where it builds)
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_mod", None)
    want = jio.load_dataset(str(tmp_path), map_suffix=suffix)
    got = tio.load_dataset(str(tmp_path), map_suffix=suffix)
    assert got.param == tio.MapParam(*want.param.__dict__.values())
    np.testing.assert_array_equal(got.map_value, want.map_value)
    np.testing.assert_array_equal(got.map_value, src.map_value)
    np.testing.assert_array_equal(got.odom, want.odom)
    assert got.odom[0, 0] == 0.0 and len(got.odom) == len(src.odom)
    assert len(got.frames) == len(want.frames) == 4
    for a, b, c in zip(got.frames, want.frames, src.frames):
        np.testing.assert_array_equal(a, b)
        assert len(a) == len(c)
    np.testing.assert_array_equal(got.real_pos, want.real_pos)
    np.testing.assert_array_equal(got.recorded_odom, want.recorded_odom)
    assert got.name == want.name
