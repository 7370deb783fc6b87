"""scripts/torch_sol_bound.py against the JAX package's scripts/sol_bound.py
on the CPU, on written seed-1 scenes: the 200x260 room (12 frames, no
pruned frame) and the data1-sized scene (979x1440 at 0.025 m, 4 frames,
chip_smoke.py's make_scene arguments), whose relock frame takes the
pruned path.

  * the port's f32 count lines (frames, live candidates and survivors,
    live pixels, the chunk-grid and useful counts) equal the reference
    script's, line for line, and the numbers pinned below;
  * the port's as-built count equals a direct count of what its rollout
    gathers: each CalcScore launch's live slots x live pixels and each
    pruning bound's K slots x G groups, frame by frame;
  * asking for the card where there is none exits 2."""

import contextlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import load_script, write_dataset

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENES = {
    "room": dict(F=12),
    "data1_sized": dict(F=4, H=979, W=1440, resol=0.025, rmax=13.0,
                        n_walls=46, clear_m=2.5, wall_scale=2.5),
}
# the reference script's numbers on these scenes
PINNED = {
    "room": ("frames=12 (tracking 11, relock 1; pruned-path frames 0)",
             "relock [72] -> survivors [34]", "total 276,480",
             "useful 136,894"),
    "data1_sized": ("frames=4 (tracking 3, relock 1; pruned-path frames 1)",
                    "relock [2252] -> survivors [784]", "total 2,288,640",
                    "useful 2,039,825"),
}
COUNT_LINES = ("frames=", "live candidates:", "live pixels:",
               "gathered cells, chunk grids")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name, kw in SCENES.items():
        d = tmp_path_factory.mktemp(name)
        write_dataset(d, 1, **kw)
        out[name] = str(d)
    return out


def _count_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(COUNT_LINES)]


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


@pytest.mark.parametrize("scene", list(SCENES))
def test_counts_equal_the_reference_script(scenes, scene):
    rc, want = _stdout(lambda: load_script("sol_bound").main(
        ["--data", scenes[scene]]))
    assert rc == 0
    rc, got = _stdout(lambda: load_script("torch_sol_bound").main(
        ["--data", scenes[scene], "--device", "cpu"]))
    assert rc == 0
    assert len(_count_lines(want)) == len(COUNT_LINES)
    assert _count_lines(got) == _count_lines(want)
    joined = "\n".join(_count_lines(got))
    for piece in PINNED[scene]:
        assert piece in joined
    assert "constants: not measured" in got


@pytest.mark.parametrize("scene", list(SCENES))
def test_as_built_count_is_what_the_rollout_gathers(scenes, scene,
                                                    monkeypatch):
    from lsdtpu_torch.bench import bench_cfg
    from lsdtpu_torch.io import load_dataset
    from lsdtpu_torch.match import associate as assoc
    sb = load_script("torch_sol_bound")
    cfg = bench_cfg()
    ctx, frames = sb.scene_context(load_dataset(scenes[scene]), np.float32,
                                   "cpu")
    events = []      # ("bound", K x G) and ("launch", n_live x n_pix)
    in_prune = []
    real_sp, real_ps, real_cb = (assoc.score_partials, assoc.prune_survivors,
                                 assoc._chunk_bound)

    def score_partials(*a, **kw):
        events.append(("launch", int(a[2]) * int(a[5])))
        return real_sp(*a, **kw)

    def prune_survivors(*a, **kw):
        in_prune.append(True)
        try:
            return real_ps(*a, **kw)
        finally:
            in_prune.pop()

    def chunk_bound(args, gs, *rest):
        if in_prune:
            events.append(("bound", args[0].shape[-1] * gs[0].shape[-1]))
        return real_cb(args, gs, *rest)

    monkeypatch.setattr(assoc, "score_partials", score_partials)
    monkeypatch.setattr(assoc, "prune_survivors", prune_survivors)
    monkeypatch.setattr(assoc, "_chunk_bound", chunk_bound)
    recs = sb.rollout_counts(frames, ctx, cfg, "cpu")
    counts = sb.gather_counts(recs, cfg)
    # one launch a frame, after the frame's bound where there is one
    per_frame, acc, bounds = [], 0, 0
    for kind, n in events:
        acc += n
        bounds += kind == "bound"
        if kind == "launch":
            per_frame.append(acc)
            acc = 0
    assert acc == 0
    assert bounds == counts["pruned"].sum() == (scene == "data1_sized")
    np.testing.assert_array_equal(counts["as_built"], per_frame)
    K, G = cfg.shapes.max_candidates, cfg.shapes.max_scan_pixels // 16
    assert counts["as_built"].sum() - counts["useful"].sum() == \
        ((K - recs["live_cand"]) * G)[counts["pruned"]].sum()


def test_cuda_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "scripts/torch_sol_bound.py",
                          "--data", "unused"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
