"""lsdtpu_torch.runtime.collectives.Axis, the port's named-axis
collectives: the identity at one rank (Axis.none() and a one-rank mesh
in this process), and psum / pmin / pmax / all_gather / the [(i, i+1)]
shift / the +-1 halo over two gloo ranks (spawned processes,
tests/torch_ranks.py) against their definitions: rank-order sums, the
shift's and halo's zeros past the ends."""

import numpy as np
import pytest
import torch

from lsdtpu_torch.runtime import shard
from lsdtpu_torch.runtime.collectives import Axis, gather_lanes, rank_slice

import torch_ranks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return torch_ranks.run_group(tmp_path_factory.mktemp("ranks"), 2,
                                 [("axis", {})])


@pytest.mark.parametrize("axis", ["none", "mesh"])
def test_one_rank_is_the_identity(axis):
    ax = Axis.none() if axis == "none" else \
        Axis.of(shard.make_mesh_1d(device="cpu"), "dp")
    assert (ax.size, ax.index) == (1, 0)
    x = torch.tensor([1.0, -2.5, float("nan")], dtype=torch.float64)
    for op in (ax.psum, ax.pmin, ax.pmax):
        assert op(x) is x
    assert torch.equal(ax.all_gather(x)[0].nan_to_num(), x.nan_to_num())
    assert not ax.shift_next(x).any()
    up, dn = ax.halo(x, -x)
    assert not up.any() and not dn.any()
    outs = {"a": torch.arange(6).reshape(3, 2), "b": torch.ones(3, 1) > 0}
    got = gather_lanes(ax, outs, n=2)
    assert torch.equal(got["a"], outs["a"][:2])
    assert got["b"].dtype == torch.bool
    assert rank_slice(8, ax) == slice(0, 8)


def test_two_ranks(two_ranks):
    xs = [np.array([1.5 * (r + 1), -float(r)]) for r in range(2)]
    for r, (res,) in enumerate(two_ranks):
        assert (res["size"], res["index"]) == (2, r)
        np.testing.assert_array_equal(res["psum"], xs[0] + xs[1])
        np.testing.assert_array_equal(res["pmin"], np.minimum(*xs))
        np.testing.assert_array_equal(res["pmax"], np.maximum(*xs))
        np.testing.assert_array_equal(res["bool"], [[True], [False]])
        np.testing.assert_array_equal(res["shift"],
                                      xs[0] if r == 1 else 0 * xs[0])
        # the previous rank's last row, the next rank's first row
        np.testing.assert_array_equal(res["up"], -1.0 if r == 1 else 0.0)
        np.testing.assert_array_equal(res["dn"], 2.0 if r == 0 else 0.0)
    # every rank holds the same bits
    for k in ("psum", "pmin", "pmax"):
        np.testing.assert_array_equal(two_ranks[0][0][k], two_ranks[1][0][k])
