"""The block-built distance field: lsdtpu_torch.mapprep.distance_sharded
bit for bit against the port's single-card create_map_cache and against
lsdtpu.mapprep.distance_sharded (tests/test_distance_sharded.py's tier),
on random occupancy grids (contested wavefronts everywhere) with several
block counts, blocks smaller than the halo among them, and the ROS cap
z = 2 (a larger halo): in this process (one rank, several blocks) and
over two spawned gloo ranks."""

import numpy as np
import pytest
import torch

from lsdtpu.mapprep.distance_sharded import (create_map_cache_sharded as
                                             jax_sharded, make_mesh_prep)
from lsdtpu_torch.mapprep.distance import create_map_cache
from lsdtpu_torch.mapprep.distance_sharded import create_map_cache_sharded

import torch_ranks


def _grid(seed, shape=(97, 61), p=0.04):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.uint8)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    jobs = [("field", dict(grid=_grid(7), res=0.05, z=1.0,
                           blocks_per_device=b)) for b in (1, 3)]
    jobs.append(("field", dict(grid=_grid(8, (83, 70)), res=0.05, z=2.0,
                               blocks_per_device=2)))
    return jobs, torch_ranks.Group(tmp_path_factory.mktemp("ranks"), 2, jobs)


@pytest.mark.parametrize("blocks", [1, 2, 5, 13])
def test_blocks_bitwise_single_card(blocks):
    g = _grid(7)
    want = create_map_cache(g, 0.05, 1.0, device="cpu")
    got = create_map_cache_sharded(g, 0.05, 1.0, blocks_per_device=blocks,
                                   device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("z", [1.0, 2.0])
def test_bitwise_jax_sharded(z):
    g = _grid(9, (120, 90), 0.03)
    want = jax_sharded(g, 0.05, z, mesh=make_mesh_prep(n_devices=4))
    got = create_map_cache_sharded(g, 0.05, z, blocks_per_device=4,
                                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_two_ranks_bitwise(two_ranks):
    jobs, group = two_ranks
    res = group.results()
    for i, (_name, kw) in enumerate(jobs):
        want = create_map_cache(kw["grid"], kw["res"], kw["z"],
                                device="cpu").numpy()
        for r in res:
            np.testing.assert_array_equal(r[i], want)
