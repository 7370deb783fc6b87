"""Visualization dumps: lsdtpu_torch.viz against lsdtpu.viz - the same
images, pixel for pixel, from the same arrays."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from lsdtpu import viz as jviz
from lsdtpu_torch import viz as tviz
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import contexts, frames, np_, scene


def test_map_to_gray_semantics():
    m = np.array([[0, 1, 255]], np.uint8)
    g = tviz.map_to_gray(m)
    assert g.dtype == np.uint8
    assert g[0, 0] == 160 and g[0, 1] == 0 and g[0, 2] == 255
    np.testing.assert_array_equal(g, jviz.map_to_gray(m))


@pytest.mark.parametrize("z", [1.0, 2.0])
def test_cache_to_gray_matches(z):
    c = np.random.default_rng(0).uniform(-0.5, 2.5, (13, 17))
    np.testing.assert_array_equal(tviz.cache_to_gray(c, z),
                                  jviz.cache_to_gray(c, z))


def test_draw_dots_and_crosses_match():
    pts = np.array([[5.0, 5.0], [50.0, 50.0], [np.nan, 2.0], [-4.0, 2.0],
                    [9.4, 0.6], [0.5, 9.5]])
    for fn, kw in (("draw_dots", {"radius": 1}), ("draw_dots", {"radius": 3}),
                   ("draw_crosses", {"arm": 2})):
        a = np.zeros((10, 10, 3), np.uint8)
        b = np.zeros((10, 10, 3), np.uint8)
        getattr(tviz, fn)(a, pts, (10, 20, 30), **kw)
        getattr(jviz, fn)(b, pts, (10, 20, 30), **kw)
        np.testing.assert_array_equal(a, b)
    a = np.zeros((10, 10, 3), np.uint8)
    tviz.draw_dots(a, pts[:1], (10, 20, 30), radius=1)
    assert (a != 0).any(axis=2).sum() == len(tviz._disk_offsets(1))


def test_trajectory_and_scan_images_match():
    m = np.full((20, 20), 255, np.uint8)
    m[3:5, :] = 1
    poses = np.array([[5.0, 5.0, 0.0], [12.0, 12.0, 0.0], [15.0, 3.0, 0.0]])
    scores = np.array([1.0, np.inf, 0.5])
    line_im = np.zeros((20, 20), np.uint8)
    line_im[10, 2:9] = 255
    gt = np.array([[8.0, 8.0], [1.0, 18.0]])
    refined = poses + 0.7
    for kw in ({}, {"scores": scores}, {"scores": scores, "line_im": line_im,
                                        "real_pos_px": gt,
                                        "refined_px": refined}):
        np.testing.assert_array_equal(tviz.trajectory_image(m, poses, **kw),
                                      jviz.trajectory_image(m, poses, **kw))
    rgb = tviz.trajectory_image(m, poses, scores)
    assert tuple(rgb[5, 5]) == tviz.POSE_GREEN
    assert tuple(rgb[12, 12]) == tviz.LOST_ORANGE
    px = np.array([[3, 4], [7, 2], [0, 0]])
    mask = np.array([True, True, False])
    for canvas in (None, (12, 15)):
        np.testing.assert_array_equal(
            tviz.scan_image(px, mask, np.array([5.0, 5.0]), canvas),
            jviz.scan_image(px, mask, np.array([5.0, 5.0]), canvas))


def test_world_to_px_matches():
    xy = np.random.default_rng(1).normal(size=(7, 3))
    np.testing.assert_array_equal(tviz.world_to_px(xy, 0.05, -2.0, -1.5),
                                  jviz.world_to_px(xy, 0.05, -2.0, -1.5))


def test_dump_run_matches_jax(tmp_path):
    """The four kinds of image of a port rollout (the lineIm overlay from
    the port's rasterizer), equal to the JAX package's dump of the same
    arrays, and readable PNGs."""
    ds, art = scene(0)
    _, ctx = contexts(0)
    fr = frames(0)
    outs = {k: np_(v) for k, v in tloop.run_sequence(fr, ctx,
                                                     device="cpu").items()}
    fs = tloop.featurize_stage(tuple(torch.as_tensor(fr[k][0])
                                     for k in tloop._FRAME_KEYS), ctx)
    fs_np = type(fs)(**{k: np_(v) for k, v in vars(fs).items()})
    p = ds.param
    kw = dict(real_pos=outs["pose"][:, :2] * p.resol + [p.ori_x, p.ori_y],
              scan_features=[(1, fs_np)], z_occ_max_dis=1.0,
              refined_px=outs["pose"] + 0.5)
    got = tviz.dump_run(str(tmp_path / "port"), ds.map_value,
                        art.lines_info, art.map_cache, outs, p.resol,
                        p.ori_x, p.ori_y, **kw)
    want = jviz.dump_run(str(tmp_path / "jax"), ds.map_value,
                         art.lines_info, art.map_cache, outs, p.resol,
                         p.ori_x, p.ori_y, **kw)
    names = [os.path.basename(q) for q in got]
    assert names == [os.path.basename(q) for q in want] == [
        "map_lines.png", "map_cache.png", "trajectory.png", "scan_0001.png"]
    for a, b in zip(got, want):
        with Image.open(a) as ia, Image.open(b) as ib:
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    with Image.open(got[2]) as im:
        traj = np.asarray(im)
    assert traj.shape[:2] == ds.map_value.shape
    assert (traj == np.array(tviz.LINE_RED, np.uint8)).all(axis=2).any()
