"""lsdtpu_torch.io.loaders against lsdtpu.io.loaders on a dataset
directory written from a synthetic scene (the reference file formats)."""

import numpy as np
import pytest

from lsdtpu.io import loaders as jio
from lsdtpu.io import native as jnative
from lsdtpu_torch.io import loaders as tio
from lsdtpu_torch.io import synth


def _write_dataset(root, seed, suffix=""):
    ds = synth.synth_dataset(seed, F=4).dataset
    p = ds.param
    (root / f"mapParam{suffix}.txt").write_text(
        f"{p.col} {p.row} {p.resol} {p.ori_x} {p.ori_y}\n")
    np.savetxt(root / f"mapValue{suffix}.txt", ds.map_value, fmt="%d")
    np.savetxt(root / "Odom.txt", ds.odom[1:], fmt="%.9f")
    rows = []
    for fr in ds.frames:
        full = np.full((360, 2), np.inf)
        full[:len(fr)] = fr
        full[len(fr):, 1] = 0.0
        rows.append(full)
    np.savetxt(root / "Lidar.txt", np.concatenate(rows), fmt="%.9f")
    np.savetxt(root / "realPos.txt", ds.odom[1:, :2], fmt="%.6f",
               delimiter="\t")
    np.savetxt(root / "recored_Odom.txt", np.arange(1, 5), fmt="%d")
    return ds


@pytest.mark.parametrize("seed,suffix", [(0, ""), (2, "_map1")])
def test_load_dataset_matches_reference_loader(tmp_path, monkeypatch, seed,
                                               suffix):
    src = _write_dataset(tmp_path, seed, suffix)
    # the reference loader's numpy path (the port has no native parser;
    # this also keeps the test from building the reference's extension)
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
