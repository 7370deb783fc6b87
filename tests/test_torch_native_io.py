"""The port's native C++ parser (lsdtpu_torch.io.native) against numpy on
written grids and float tables (inf rows included), the loaders' numpy
route where the parser cannot be built, and the prefetching feeder
(order, laziness).  Exact equality throughout."""

import numpy as np
import pytest

from lsdtpu_torch.io import feeder, loaders, native

from torch_parity import write_dataset


@pytest.fixture
def numpy_route(monkeypatch):
    """The loaders as on a machine without a C++ compiler."""
    monkeypatch.setitem(native._state, "tried", True)
    monkeypatch.setitem(native._state, "mod", None)


def test_native_parser_builds_here():
    assert native.available(), native.build_error()
    assert native.build_error() is None


def test_native_grid_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    grid = rng.choice(np.array([0, 1, 255]), size=(37, 53))
    path = str(tmp_path / "mapValue.txt")
    np.savetxt(path, grid, fmt="%d")
    before = native.load_grid_native.calls
    got = native.load_grid_native(path, 37, 53)
    assert native.load_grid_native.calls == before + 1
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, grid.astype(np.uint8))
    with pytest.raises(ValueError, match="expected"):
        native.load_grid_native(path, 38, 53)


def test_native_doubles_match_numpy_with_inf(tmp_path):
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(720, 2)) * 10
    rows[rng.random(720) > 0.8, 0] = np.inf
    path = str(tmp_path / "Lidar.txt")
    np.savetxt(path, rows, fmt="%.9f")
    want = np.loadtxt(path, dtype=np.float64, ndmin=2)
    before = native.load_doubles_native.calls
    got = native.load_doubles_native(path).reshape(-1, 2)
    assert native.load_doubles_native.calls == before + 1
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, 0]).sum() == np.isinf(rows[:, 0]).sum()


def test_loaders_native_and_numpy_routes_agree(tmp_path, monkeypatch):
    write_dataset(tmp_path, 1, F=5)
    before = (native.load_grid_native.calls, native.load_doubles_native.calls)
    a = loaders.load_dataset(str(tmp_path))
    after = (native.load_grid_native.calls, native.load_doubles_native.calls)
    # mapValue natively; Odom, Lidar and realPos natively
    assert (after[0] - before[0], after[1] - before[1]) == (1, 3)
    monkeypatch.setitem(native._state, "tried", True)
    monkeypatch.setitem(native._state, "mod", None)
    assert not native.available()
    b = loaders.load_dataset(str(tmp_path))
    assert (native.load_grid_native.calls,
            native.load_doubles_native.calls) == after
    assert a.param == b.param
    for k in ("map_value", "odom", "real_pos", "recorded_odom"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert len(a.frames) == len(b.frames) == 5
    for x, y in zip(a.frames, b.frames):
        np.testing.assert_array_equal(x, y)


def test_lines_info_loader_routes(tmp_path, numpy_route):
    rng = np.random.default_rng(2)
    lines = rng.normal(size=(9, 10))
    path = str(tmp_path / "lines.txt")
    np.savetxt(path, lines, fmt="%.17g")
    np.testing.assert_array_equal(loaders.load_lines_info(path), lines)


def test_build_failure_is_reported(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_state",
                        {"mod": None, "tried": False, "error": None})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    assert "no-such-compiler" in native.build_error()
    assert native.load_grid_native("unused", 1, 1) is None
    assert native.load_doubles_native("unused") is None


def test_prefetch_feeder_order_and_laziness():
    calls = []

    def slowish(x):
        calls.append(x)
        return x * 2

    f = feeder.PrefetchFeeder(slowish, list(range(10)), workers=3,
                              lookahead=2)
    assert len(f) == 10 and calls == []
    it = iter(f)
    assert next(it) == 0
    assert len(calls) <= 2
    assert list(it) == [x * 2 for x in range(1, 10)]
    assert sorted(calls) == list(range(10))


def test_load_datasets_prefetched(tmp_path):
    roots = []
    for seed in (0, 1, 2):
        root = tmp_path / f"d{seed}"
        root.mkdir()
        write_dataset(root, seed, F=3)
        roots.append(str(root))
    got = list(feeder.load_datasets_prefetched(roots, workers=2))
    assert [d.name for d in got] == ["d0", "d1", "d2"]
    for d, r in zip(got, roots):
        np.testing.assert_array_equal(d.map_value,
                                      loaders.load_dataset(r).map_value)
