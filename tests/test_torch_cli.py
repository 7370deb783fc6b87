"""The port's command-line interface (lsdtpu_torch.cli) on a synthetic
dataset directory, all with --device cpu: each command's records equal
the port's library calls on the same artifacts (after the CLI's
rounding); the JAX CLI prints the same record and summary keys; the
presets and --set overrides give the JAX CLI's field values; and without
--device cpu, where there is no card, every command exits non-zero."""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lsdtpu import cli as jcli
from lsdtpu_torch import cli
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.eval import ate
from lsdtpu_torch.io import load_dataset, load_lines_info, refdump
from lsdtpu_torch.refine import pose_graph
from lsdtpu_torch.render import render_line_image
from lsdtpu_torch.runtime import batch, loop
from lsdtpu_torch.runtime.artifacts import prepare_map_cached
from lsdtpu_torch.runtime.online import (LEGACY_Z_OCC_MAX_DIS,
                                         OnlineLocalizer, to_host)
from lsdtpu_torch.runtime.serving import SessionPool

from torch_parity import write_dataset

F = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(data dir, cache dir, Dataset): seed 1's scene, F frames."""
    data = tmp_path_factory.mktemp("data")
    write_dataset(data, 1, F=F)
    return (str(data), str(tmp_path_factory.mktemp("cache")),
            load_dataset(str(data)))


def _cli(capsys, argv, main=cli.main):
    rc = main(argv)
    out, err = capsys.readouterr()
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    errs = [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]
    return rc, recs, errs, err


def _args(env, *extra):
    data, cache, _ = env
    return ["--data", data, "--cache-dir", cache, "--device", "cpu", *extra]


def _artifacts(env, z=None, growth=None):
    _, cache, ds = env
    return prepare_map_cached(
        ds.map_value, ds.param.resol,
        DEFAULT.map.z_occ_max_dis if z is None else z, cache_dir=cache,
        device="cpu", growth=DEFAULT.lsd.growth if growth is None else growth)


def _rollout(env, dtype=np.float32, frames=None):
    ds = env[2]
    lines, cache = _artifacts(env)
    ctx = loop.make_map_context(lines, cache, ds.param.resol, ds.param.ori_x,
                                ds.param.ori_y, dtype=dtype, device="cpu")
    fr = loop.stack_frames(ds, dtype=dtype, max_frames=frames)
    return to_host(loop.run_sequence(fr, ctx, device="cpu"))


def _score(sc):
    return round(float(sc), 4) if math.isfinite(sc) else None


@pytest.mark.parametrize("f64", [False, True])
def test_run_equals_library(env, capsys, f64):
    rc, recs, errs, _ = _cli(capsys, ["run", *_args(env)]
                             + (["--f64"] if f64 else []))
    assert rc == 0
    outs = _rollout(env, np.float64 if f64 else np.float32)
    want = [{"frame": f + 1,
             "pose": [round(float(v), 3) for v in outs["pose"][f]],
             "score": _score(outs["score"][f]),
             "n_candidates": int(outs["n_candidates"][f])}
            for f in range(F)]
    assert recs == want
    summary = errs[-1]
    assert summary["frames"] == F
    assert summary["tracked"] == int(np.isfinite(outs["score"]).sum()) > 0
    ds = env[2]
    a = ate.keyframe_ate(outs["pose"], ds.real_pos, ds.recorded_odom,
                         ds.param.resol, ds.param.ori_x, ds.param.ori_y)
    assert summary["ate_rmse_m"] == round(a.rmse, 4)
    assert summary["ate_keyframes"] == F


def test_run_legacy_equals_library(env, capsys):
    rc, recs, errs, _ = _cli(capsys, ["run", *_args(env), "--mode",
                                      "legacy", "--frames", "5"])
    assert rc == 0
    ds = env[2]
    lines, cache = _artifacts(env, z=LEGACY_Z_OCC_MAX_DIS, growth="wave")
    loc = OnlineLocalizer(mode="legacy", device="cpu")
    loc.set_map_artifacts(lines, cache, ds.param.resol, ds.param.ori_x,
                          ds.param.ori_y)
    want = []
    for f in range(5):
        out = loc.push_scan(ds.frames[f][:, 0], ds.frames[f][:, 1])
        want.append({"frame": f + 1,
                     "pose": [round(float(v), 3) for v in out["pose"]],
                     "pose_world": [round(float(v), 3)
                                    for v in out["pose_world"]],
                     "score": _score(float(out["score"]))})
    assert recs == want
    assert errs[-1] == {"frames": 5,
                        "tracked": sum(r["score"] is not None for r in want)}


def test_prepare_map_dump_reloads(env, capsys, tmp_path):
    rc, recs, _, _ = _cli(capsys, ["prepare-map", *_args(env), "--dump",
                                   str(tmp_path)])
    assert rc == 0
    lines, cache = (t.numpy() for t in _artifacts(env))
    assert recs[0]["lines"] == len(lines)
    assert recs[0]["cache_shape"] == list(cache.shape)
    assert sorted(recs[0]["dumped"]) == ["line_im", "lines_info",
                                         "map_cache"]
    np.testing.assert_array_equal(
        load_lines_info(recs[0]["dumped"]["lines_info"]).astype(np.float32),
        lines)
    np.testing.assert_array_equal(
        refdump.load_map_cache(recs[0]["dumped"]["map_cache"])
        .astype(np.float32), cache)
    img = render_line_image(torch.as_tensor(lines),
                            torch.ones(len(lines), dtype=torch.bool),
                            *cache.shape).numpy()
    back = np.loadtxt(recs[0]["dumped"]["line_im"], dtype=np.int64)
    np.testing.assert_array_equal(back[:-1, :-1], img[1:, 1:] > 0)


@pytest.mark.parametrize("segments", [1, 4])
def test_refine_equals_library(env, capsys, segments):
    rc, recs, _, _ = _cli(capsys, ["refine", *_args(env), "--segments",
                                   str(segments)])
    assert rc == 0
    outs = _rollout(env)
    meas, scores, u = cli.refine_inputs(outs, segments)
    if segments > 1:
        assert len(meas) % segments == 0 and len(meas) // segments >= 2
        refined, info = pose_graph.refine_trajectory_distributed(
            meas, scores, u, n_segments=segments, device="cpu")
    else:
        refined, info = pose_graph.refine_trajectory(meas, scores, u,
                                                     device="cpu")
    ds = env[2]
    want = {"frames": F, "n_measured": int(info["n_measured"]),
            "segments": segments}
    for name, poses in (("online", outs["pose"]),
                        ("refined", refined.numpy()[:F])):
        want[f"ate_{name}_rmse_m"] = round(ate.keyframe_ate(
            poses, ds.real_pos, ds.recorded_odom, ds.param.resol,
            ds.param.ori_x, ds.param.ori_y).rmse, 4)
    assert recs == [want]


def test_refine_inputs_pad_to_the_segment_grid():
    outs = {"measurement": np.zeros((7, 3), np.float32),
            "score": np.ones(7, np.float32),
            "scan_pose": np.zeros((7, 3), np.float32)}
    for seg, n in ((1, 7), (7, 14), (4, 8), (2, 8)):
        meas, scores, u = cli.refine_inputs(outs, seg)
        assert meas.dtype == np.float64 and len(meas) == n, (seg, n)
        assert np.isnan(meas[7:]).all() and np.isinf(scores[7:]).all()


def test_profile(env, capsys, tmp_path):
    trace = str(tmp_path / "trace")
    rc, recs, _, _ = _cli(capsys, ["profile", *_args(env), "--frame", "2",
                                   "--repeats", "1", "--trace", trace])
    assert rc == 0
    stages, steady = recs
    assert sorted(stages) == ["frame", "note", "per_stage_ms"]
    assert stages["frame"] == 2
    assert sorted(stages["per_stage_ms"]) == [
        "candidates_ms", "featurize_ms", "fuse_ms", "score_ms", "ukf_ms"]
    assert sorted(steady) == ["compile_plus_first_s", "frames",
                              "scans_per_sec", "steady_ms", "trace_dir"]
    assert steady["frames"] == F and steady["trace_dir"] == trace
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0


@pytest.mark.parametrize("concat", [False, True])
def test_batch_equals_library(env, capsys, concat):
    data, _, ds = env
    rc, recs, errs, _ = _cli(capsys, ["batch", *_args(env)[:1], data,
                                      *_args(env)[1:]]
                             + (["--concat"] if concat else []))
    assert rc == 0
    art = _artifacts(env)
    if concat:
        ctx = loop.make_map_context(*art, ds.param.resol, ds.param.ori_x,
                                    ds.param.ori_y, device="cpu")
        fr, bounds = batch.stack_concat([ds, ds])
        sc = loop.run_sequence(fr, ctx, device="cpu")["score"].numpy()
        tracked = [int(np.isfinite(sc[a:b]).sum())
                   for a, b in zip(bounds[:-1], bounds[1:])]
    else:
        fr, ctxs, lens = batch.stack_batch([ds, ds], [art, art],
                                           device="cpu")
        sc = batch.run_batch(fr, ctxs, device="cpu")["score"].numpy()
        tracked = [int(np.isfinite(sc[b][:n]).sum())
                   for b, n in enumerate(lens)]
    assert recs == [{"seq": data, "frames": F, "tracked": t}
                    for t in tracked]
    assert errs[-1]["total_scans"] == 2 * F


def test_serve_equals_library(env, capsys):
    data, _, ds = env
    rc, recs, errs, _ = _cli(capsys, ["serve", "--data", data, data,
                                      *_args(env)[2:], "--frames", "6"])
    assert rc == 0
    lines, cache = _artifacts(env)
    pool = SessionPool(2, tuple(cache.shape), device="cpu")
    for i in range(2):
        pool.open_session(f"robot{i}", lines, cache, ds.param.resol,
                          ds.param.ori_x, ds.param.ori_y)
    poses, scores = [[], []], [[], []]
    for f in range(6):
        for i in range(2):
            pool.submit_scan(f"robot{i}", ds.frames[f][:, 0],
                             ds.frames[f][:, 1], ds.odom[f + 1])
        res = pool.step()
        for i in range(2):
            poses[i].append(res[f"robot{i}"]["pose"])
            scores[i].append(float(res[f"robot{i}"]["score"]))
    for i, rec in enumerate(recs):
        a = ate.keyframe_ate(np.stack(poses[i]), ds.real_pos,
                             ds.recorded_odom, ds.param.resol,
                             ds.param.ori_x, ds.param.ori_y)
        assert rec == {"robot": i, "seq": data, "frames": 6,
                       "tracked": int(np.isfinite(scores[i]).sum()),
                       "ate_rmse_m": round(a.rmse, 4)}
    assert errs[-1]["robots"] == 2 and errs[-1]["ticks"] == 6
    assert errs[-1]["total_scans"] == 12


def test_viz(env, capsys, tmp_path):
    rc, _, errs, _ = _cli(capsys, ["run", *_args(env), "--frames", "3",
                                   "--viz", str(tmp_path), "--viz-frames",
                                   "2"])
    assert rc == 0
    assert [os.path.basename(p) for p in errs[-1]["viz"]] == [
        "map_lines.png", "map_cache.png", "trajectory.png", "scan_0001.png",
        "scan_0002.png"]


def test_jax_cli_prints_the_same_keys(env, capsys):
    """The JAX CLI (its numpy-oracle map prep) on the same directory:
    record and summary keys and frame counts equal the port's."""
    data, cache, _ = env
    common = ["--data", data, "--frames", "4"]
    rc, jrecs, jerrs, _ = _cli(capsys, ["run", *common, "--mapprep", "oracle",
                                        "--cache-dir", cache + "_jax"],
                               main=jcli.main)
    assert rc == 0
    rc, recs, errs, _ = _cli(capsys, ["run", *common, "--cache-dir", cache,
                                      "--device", "cpu"])
    assert rc == 0
    assert len(recs) == len(jrecs) == 4
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    assert sorted(errs[-1]) == sorted(jerrs[-1])
    assert errs[-1]["frames"] == jerrs[-1]["frames"] == 4


def _fields(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("preset", sorted(cli.PRESETS))
@pytest.mark.parametrize("overrides", [
    [], ["match.score_accept=2.5", "faithful=false"],
    ["match.obstacle_min_dist=0.4", "match.obstacle_min_dist=none",
     "shapes.max_candidates=4096", "lsd.growth=wave"],
    ["match.prune=0", "filter.alpha=0.02", "match.cache_dtype=u16"]])
def test_presets_and_overrides_match_jax(preset, overrides):
    assert cli.PRESETS == jcli.PRESETS
    assert cli.OPTIONAL_FIELDS == jcli.OPTIONAL_FIELDS
    ns = argparse.Namespace(preset=preset, overrides=overrides)
    got, want = _fields(cli.build_cfg(ns)), _fields(jcli.build_cfg(ns))
    assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("pair", ["match.prune_block=x",
                                  "match.score_accept=none",
                                  "match.obstacle_min_dist=far"])
def test_bad_overrides_raise_like_jax(pair):
    with pytest.raises(ValueError) as got:
        cli.apply_overrides(DEFAULT, [pair])
    with pytest.raises(ValueError) as want:
        jcli.apply_overrides(jcli.build_cfg(argparse.Namespace(
            preset="faithful", overrides=[])), [pair])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [
    ["run"], ["run", "--mode", "legacy"], ["prepare-map"], ["refine"],
    ["profile"], ["batch"], ["serve"]])
def test_without_a_card_exits_nonzero(env, capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, recs, _, err = _cli(capsys, [*argv[:1], "--data", env[0],
                                     "--cache-dir", env[1], *argv[1:]])
    assert rc != 0 and recs == []
    assert "torch.cuda.is_available() is False" in err


@pytest.mark.parametrize("argv,msg", [
    (["run", "--mapprep", "oracle"], "oracle"),
    (["prepare-map", "--mapprep", "tpu-sharded"], "multi-device runners"),
    (["batch", "--concat", "--temporal", "2"], "multi-device runners"),
    (["bench"], "GPU bench entry")])
def test_unported_options_exit_2(env, capsys, argv, msg):
    extra = [] if argv[0] == "bench" else ["--data", env[0]]
    rc, recs, _, err = _cli(capsys, ["--device", "cpu", *argv[:1], *extra,
                                     *argv[1:]])
    assert rc == 2 and recs == [] and msg in err


def test_module_entry_point(env):
    res = subprocess.run([sys.executable, "-m", "lsdtpu_torch.cli", "run",
                          *_args(env), "--frames", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.splitlines()) == 2
