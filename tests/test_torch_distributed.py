"""lsdtpu_torch.runtime.distributed, the port of
lsdtpu/runtime/distributed.py: initialize does nothing at world size 1
and raises without a rank; the pod mesh's shape and axes in this process
(one rank) and over two gloo ranks of one host (spawned processes), where
its tp and mp rollouts hold the single rollout's poses within 1e-9 px
and its n_candidates exactly (tests/test_distributed.py's tier), and
globalize_batch gives each rank its shard."""

import numpy as np
import pytest
import torch.distributed as dist

from lsdtpu_torch.runtime import distributed, loop
from lsdtpu_torch.runtime.distributed import DP_AXIS, MP_AXIS, TP_AXIS

import torch_ranks
from torch_parity import batch_contexts, np_

NF = 6
LANE = ((1, 180, 240, NF),)


def test_initialize_single_process_is_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    was = dist.is_initialized()
    assert distributed.initialize(device="cpu") is None
    assert distributed.initialize(world_size=1, device="cpu") is None
    assert dist.is_initialized() == was


def test_initialize_without_rank_raises(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize(world_size=2, device="cpu")
    assert distributed.default_backend("cpu", 1) == "gloo"


def test_pod_mesh_shape_and_axes():
    mesh = distributed.make_pod_mesh(device="cpu")
    assert mesh.mesh_dim_names == (DP_AXIS, TP_AXIS)
    assert tuple(mesh.shape) == (1, dist.get_world_size())
    mesh_mp = distributed.make_pod_mesh(inner=MP_AXIS, device="cpu")
    assert mesh_mp.mesh_dim_names == (DP_AXIS, MP_AXIS)
    with pytest.raises(ValueError, match="inner"):
        distributed.make_pod_mesh(inner="bogus", device="cpu")


def test_pod_mesh_rollouts_on_two_ranks(tmp_path):
    _, (frames, ctxs, lens) = batch_contexts(LANE)
    res = torch_ranks.run_group(tmp_path, 2, [("pod", dict(
        frames=frames, ctxs=torch_ranks.host(ctxs)))])
    ds_ctx = loop.MapContext(*(v[0] for v in (
        ctxs.lines, ctxs.lines_mask, ctxs.cache, ctxs.rows, ctxs.cols,
        ctxs.resol, ctxs.ori_x, ctxs.ori_y)))
    ds_ctx.rows, ds_ctx.cols = int(ds_ctx.rows), int(ds_ctx.cols)
    want = {k: np_(v) for k, v in loop.run_sequence(
        {k: v[0] for k, v in frames.items()}, ds_ctx, device="cpu").items()}
    for (got,) in res:
        for inner in ("tp", "mp"):
            g = got[inner]
            assert g["shape"] == (1, 2)
            assert g["names"] == (DP_AXIS, inner)
            np.testing.assert_allclose(g["outs"]["pose"][0], want["pose"],
                                       rtol=0, atol=1e-9)
            np.testing.assert_array_equal(g["outs"]["n_candidates"][0],
                                          want["n_candidates"])
        M = ctxs.lines.shape[1]
        H, W = ctxs.cache.shape[1:]
        assert got["tp"]["local"] == ((1, NF, 360), (1, M // 2, 10),
                                      (1, H, W))
        assert got["mp"]["local"] == ((1, NF, 360), (1, M, 10),
                                      (1, -(-H // 2), W))
