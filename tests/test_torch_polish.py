"""Sub-pixel pose polish: lsdtpu_torch.match.polish against
lsdtpu.match.polish on the CPU, and match.polish_pose inside the port's
rollout against the JAX rollout.

Tiers: polish_pose f64 - poses within 1e-9 px and costs within 1e-12
after every number of iterations 0..8 (so the same steps are accepted
in the same order); rollouts f64 with the polish on - identical
decisions, poses within 1e-6 px (the rollout tier of
tests/test_torch_loop.py); iters=0 bitwise equal to the polish off."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.match import polish as jpolish
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch import geometry as tgeo
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.match import polish as tpolish
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import contexts, frames, np_


def _wall_field(H=96, W=128, wall_x=64.0, wall_y=48.0, cap=1.0, res=0.05):
    """Distance (m) to an L-shaped wall pair x=wall_x, y=wall_y
    (tests/test_polish.py's field)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.minimum(np.abs(xx - wall_x), np.abs(yy - wall_y)) * res
    return np.minimum(d, cap)


def _wall_cloud(P=96):
    """A scan-local pixel cloud on both walls at pose (64, 48, 0) with
    the lidar at local (0, 0)."""
    xs = np.concatenate([np.zeros(30), np.arange(-20, 25, 1.5)])
    ys = np.concatenate([np.arange(-30, 30, 2.0), np.zeros(30)])
    pix = np.zeros((P, 2), np.int32)
    pix[:len(xs), 0] = np.round(xs)
    pix[:len(xs), 1] = np.round(ys)
    mask = np.zeros(P, bool)
    mask[:len(xs)] = True
    return pix, mask


def _both(pose, lidar, pix, mask, cache, **kw):
    """(port, JAX) polish_pose outputs as numpy."""
    t = tpolish.polish_pose(torch.as_tensor(pose), torch.as_tensor(lidar),
                            torch.as_tensor(pix), torch.as_tensor(mask),
                            torch.as_tensor(cache), **kw)
    j = jpolish.polish_pose(jnp.asarray(pose), jnp.asarray(lidar),
                            jnp.asarray(pix), jnp.asarray(mask),
                            jnp.asarray(cache), **kw)
    return [np_(x) for x in t], [np.asarray(x) for x in j]


def _scene_case(seed, f, shift):
    """A frame's real pixel cloud on its scene's field, the lidar pose
    as the rollout rounds it, and the frame's fused measurement shifted
    by ``shift``."""
    _, tctx = contexts(seed)
    fr = frames(seed)
    meas = np_(tloop.run_sequence(fr, tctx, DEFAULT,
                                  device="cpu")["measurement"][f])
    inp = tuple(torch.as_tensor(fr[k][f]) for k in tloop._FRAME_KEYS)
    fs = tloop.featurize_stage(inp, tctx)
    return (meas + np.asarray(shift), np_(tgeo.c_round(fs.lidar_pos)),
            np_(fs.pixels), np_(fs.pixels_mask), np_(tctx.cache))


@pytest.mark.parametrize("case", ["walls", "walls_rotated", "scene0",
                                  "scene1"])
def test_polish_pose_matches_jax_step_by_step(case):
    if case.startswith("walls"):
        pix, mask = _wall_cloud()
        th = 2.5 if case == "walls_rotated" else 0.0
        args = (np.array([66.2, 46.3, th]), np.zeros(2), pix, mask,
                _wall_field())
    else:
        args = _scene_case(int(case[-1]), 5, (1.3, -0.8, 0.7))
    moved = 0
    prev = args[0]
    for iters in range(9):
        (tp, tc0, tc1), (jp, jc0, jc1) = _both(*args, iters=iters)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9,
                                   err_msg=f"iters={iters}")
        np.testing.assert_allclose([tc0, tc1], [jc0, jc1], rtol=1e-12,
                                   atol=1e-12, err_msg=f"iters={iters}")
        moved += not np.array_equal(jp, prev)
        prev = jp
    assert moved >= 2      # steps were accepted (and held in order)


def test_polish_recovers_perturbed_pose():
    """tests/test_polish.py's synthetic recovery case, in the port."""
    pix, mask = _wall_cloud()
    cache = torch.as_tensor(_wall_field(), dtype=torch.float32)
    true_pose = torch.tensor([64.0, 48.0, 0.0])
    start = true_pose + torch.tensor([2.2, -1.7, 0.0])
    out, c0, c1 = tpolish.polish_pose(
        start, torch.zeros(2), torch.as_tensor(pix), torch.as_tensor(mask),
        cache, iters=8)
    assert out.dtype == torch.float32
    assert float(c1) < float(c0)
    np.testing.assert_allclose(np_(out[:2]), np_(true_pose[:2]), atol=0.35)


def test_polish_degenerate_passthrough():
    cache = torch.as_tensor(_wall_field(), dtype=torch.float32)
    pix = torch.zeros((8, 2), dtype=torch.int32)
    pose = torch.tensor([10.0, 10.0, 5.0])
    out, _, _ = tpolish.polish_pose(pose, torch.zeros(2), pix,
                                    torch.zeros(8, dtype=torch.bool), cache)
    assert torch.equal(out, pose)
    nan_pose = torch.full((3,), torch.nan)
    out, _, _ = tpolish.polish_pose(nan_pose, torch.zeros(2), pix,
                                    torch.ones(8, dtype=torch.bool), cache)
    assert torch.isnan(out).all()


def test_polish_rejects_pushing_pixels_off_map():
    """tests/test_polish.py's off-map case: the off-field penalty keeps
    the gradient from walking the cloud off the map."""
    H = W = 32
    _, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cache = torch.as_tensor(np.clip(xx * 0.05, 0, 1.0), dtype=torch.float32)
    pix = torch.zeros((16, 2), dtype=torch.int32)
    pix[:, 0] = 2
    pix[:, 1] = torch.arange(16)
    out, c0, c1 = tpolish.polish_pose(torch.zeros(3), torch.zeros(2), pix,
                                      torch.ones(16, dtype=torch.bool),
                                      cache, iters=6)
    assert float(out[0]) > -1.6
    assert float(c1) <= float(c0)


@pytest.mark.parametrize("code", [torch.uint16, torch.uint8, torch.int16])
def test_integer_fields_raise(code):
    pix, mask = _wall_cloud()
    cache = torch.zeros((96, 128), dtype=code)
    with pytest.raises(ValueError, match="float distance field"):
        tpolish.polish_pose(torch.tensor([64.0, 48.0, 0.0]), torch.zeros(2),
                            torch.as_tensor(pix), torch.as_tensor(mask),
                            cache)


def test_bf16_field_polishes_in_the_pose_dtype():
    pix, mask = _wall_cloud()
    field = _wall_field()
    bf = torch.as_tensor(field).to(torch.bfloat16)
    pose = np.array([66.2, 46.3, 1.0])
    t = tpolish.polish_pose(torch.as_tensor(pose), torch.zeros(2,
                            dtype=torch.float64), torch.as_tensor(pix),
                            torch.as_tensor(mask), bf)
    j = jpolish.polish_pose(jnp.asarray(pose), jnp.zeros(2), jnp.asarray(pix),
                            jnp.asarray(mask), jnp.asarray(field, jnp.bfloat16))
    assert t[0].dtype == torch.float64
    np.testing.assert_allclose(np_(t[0]), np.asarray(j[0]), rtol=0, atol=1e-9)


def _cfg(pkg_cfg, **kw):
    return dataclasses.replace(pkg_cfg, match=dataclasses.replace(
        pkg_cfg.match, **kw))


@pytest.mark.parametrize("seed", [0, 1, 101])
def test_rollout_with_polish_matches_jax(seed):
    jctx, tctx = contexts(seed)
    fr = frames(seed)
    want = jax.tree.map(np.asarray, jloop.run_sequence(
        fr, jctx, _cfg(jloop.DEFAULT, polish_pose=True)))
    got = {k: np_(v) for k, v in tloop.run_sequence(
        fr, tctx, _cfg(DEFAULT, polish_pose=True), device="cpu").items()}
    base = {k: np_(v) for k, v in tloop.run_sequence(
        fr, tctx, DEFAULT, device="cpu").items()}
    for k in ("n_candidates", "candidate_overflow", "coasting",
              "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"][fin], want["score"][fin],
                               rtol=0, atol=1e-9)
    for k in ("pose", "measurement"):
        nan = np.isnan(want[k]).any(1)
        np.testing.assert_array_equal(np.isnan(got[k]).any(1), nan)
        np.testing.assert_allclose(got[k][~nan], want[k][~nan], rtol=0,
                                   atol=1e-6, err_msg=k)
    # the polish moved the measurement, within its basin cap
    ok = ~np.isnan(base["measurement"]).any(1)
    disp = np.hypot(*(got["measurement"][ok, :2]
                      - base["measurement"][ok, :2]).T)
    assert disp.max() > 0.0
    assert disp.max() <= DEFAULT.match.polish_max_px + 1e-9


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_polish_zero_iters_is_bitwise_passthrough(dtype):
    """polish_pose=True with polish_iters=0 reproduces the rollout with
    the polish off bit for bit: the wiring does not touch the
    measurement path."""
    _, tctx = contexts(0, dtype)
    fr = frames(0, dtype)
    a = tloop.run_sequence(fr, tctx, DEFAULT, device="cpu")
    b = tloop.run_sequence(fr, tctx, _cfg(DEFAULT, polish_pose=True,
                                          polish_iters=0), device="cpu")
    for k in a:
        assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), k
