"""The two-stage pipelined rollout: lsdtpu_torch.runtime.pipeline over
two spawned gloo ranks (featurization on rank 0, matching on rank 1)
against the port's sequential rollout - bit for bit, every output key,
as tests/test_pipeline.py holds the reference's - and against the JAX
package's run_sequence at the f64 rollout tier of
tests/test_torch_loop.py (poses within 1e-6 px, identical decisions),
on a synthetic scene, f64 (CPU).  One rank cannot form the mesh."""

import jax
import numpy as np
import pytest

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime import pipeline

import torch_ranks
from torch_parity import contexts, frames, np_, scene

NF = 8


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    ds, art = scene(1)
    p = ds.param
    fr = {k: v[:NF] for k, v in frames(1).items()}
    group = torch_ranks.Group(tmp_path_factory.mktemp("ranks"), 2, [(
        "pipeline", dict(frames=fr, ctx=(art.lines_info, art.map_cache,
                                         p.resol, p.ori_x, p.ori_y)))])
    jctx, tctx = contexts(1)
    want = {k: np_(v) for k, v in tloop.run_sequence(fr, tctx,
                                                     device="cpu").items()}
    jwant = jax.tree.map(np.asarray, jloop.run_sequence(fr, jctx, JDEFAULT))
    return [r[0] for r in group.results()], want, jwant


def test_pipelined_equals_sequential_bitwise(piped):
    got_by_rank, want, _j = piped
    for got in got_by_rank:
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pipelined_matches_jax(piped):
    got, _w, jwant = piped[0][1], piped[1], piped[2]
    for k in ("n_candidates", "candidate_overflow", "n_scan_lines"):
        np.testing.assert_array_equal(got[k], jwant[k], err_msg=k)
    np.testing.assert_array_equal(np.isfinite(got["score"]),
                                  np.isfinite(jwant["score"]))
    np.testing.assert_allclose(got["pose"], jwant["pose"], rtol=0, atol=1e-6)


def test_one_rank_cannot_pipeline():
    with pytest.raises(ValueError, match="2 ranks"):
        pipeline.make_mesh_pp(device="cpu")
