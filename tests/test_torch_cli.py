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
from lsdtpu.oracle import driver as odrv
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


@pytest.mark.parametrize("argv,calls", [
    (["run", "--set", "prefeaturize=true"], 1),
    (["run", "--set", "scan_unroll=3", "--set",
      "scan_unroll_batch_featurize=false"], F),
    (["batch", "--set", "scan_unroll=2"], F // 2)])
def test_strategy_overrides_keep_the_records(env, capsys, monkeypatch, argv,
                                             calls):
    """--set reaches the rollout's execution strategy (the JAX CLI's
    tests/test_cli_smoke.py: --set scan_unroll=2): the featurize calls
    of the F frames are the strategy's, and the records equal the
    default's."""
    seen = []
    featurize_stage = loop.featurize_stage
    monkeypatch.setattr(loop, "featurize_stage",
                        lambda *a, **k: seen.append(1) or
                        featurize_stage(*a, **k))
    data = env[0]
    extra = [data] if argv[0] == "batch" else []
    base = [argv[0], *_args(env)[:1], data, *extra, *_args(env)[2:]]
    rc, want, _, _ = _cli(capsys, base)
    assert rc == 0 and len(want) == (2 if extra else F) and len(seen) == F
    seen.clear()
    rc, got, _, _ = _cli(capsys, base + argv[1:])
    assert rc == 0 and len(seen) == calls
    assert got == want


def test_prepare_map_tpu_sharded(env, capsys):
    """--mapprep tpu-sharded on one rank (no torchrun): the sharded
    artifacts, under a key of their own, equal the single-card ones (one
    rank's block is the whole field)."""
    rc, recs, _, _ = _cli(capsys, ["prepare-map", *_args(env), "--mapprep",
                                   "tpu-sharded"])
    assert rc == 0
    _, cache_dir, ds = env
    got = prepare_map_cached(ds.map_value, ds.param.resol, cache_dir=cache_dir,
                             device="cpu", backend="tpu-sharded")
    want = _artifacts(env, growth="wave")
    assert recs[0]["lines"] == len(got[0]) == len(want[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(os.listdir(cache_dir)) >= 2      # two keys, two files


def test_batch_concat_temporal_equals_library(env, capsys, tmp_path):
    """batch --concat --temporal 2: the records of run_sequence_temporal
    over the concatenated stream (2 segments, the lanes of one rollout,
    longer than the default warmup of 24 frames)."""
    from lsdtpu_torch.runtime.temporal import run_sequence_temporal
    ds = write_dataset(tmp_path, 1, F=26)
    data = str(tmp_path)
    rc, recs, errs, _ = _cli(capsys, ["batch", "--data", data, data,
                                      *_args(env)[2:], "--concat",
                                      "--temporal", "2"])
    assert rc == 0
    ds = load_dataset(data)
    lines, cache = prepare_map_cached(ds.map_value, ds.param.resol,
                                      cache_dir=env[1], device="cpu")
    ctx = loop.make_map_context(lines, cache, ds.param.resol, ds.param.ori_x,
                                ds.param.ori_y, device="cpu")
    fr, bounds = batch.stack_concat([ds, ds])
    sc = run_sequence_temporal(fr, ctx, n_segments=2, device="cpu")["score"]
    assert recs == [{"seq": data, "frames": 26,
                     "tracked": int(np.isfinite(sc[a:b]).sum())}
                    for a, b in zip(bounds[:-1], bounds[1:])]
    assert errs[-1]["total_scans"] == 52


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


# the port's configuration fields with no counterpart in the JAX
# package's: the serving pool's relock buffer (runtime/serving.py)
PORT_ONLY_FIELDS = {"shapes.relock_candidates"}


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
    assert set(got) - set(want) == PORT_ONLY_FIELDS
    assert {k: v for k, v in got.items() if k not in PORT_ONLY_FIELDS} == \
        {k: want[k] for k in got if k not in PORT_ONLY_FIELDS}


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
    (["batch", "--temporal", "2"], "requires --concat")])
def test_unported_options_exit_2(env, capsys, argv, msg):
    rc, recs, _, err = _cli(capsys, ["--device", "cpu", *argv[:1], "--data",
                                     env[0], *argv[1:]])
    assert rc == 2 and recs == [] and msg in err


@pytest.mark.parametrize("mode", ["tracking", "legacy"])
def test_run_mapprep_oracle_equals_jax(env, capsys, mode):
    """run --mapprep oracle --f64: the records and summary of the JAX
    CLI's run --mapprep oracle --f64 on the same directory (f64 rollouts
    on the oracle's artifacts; f32 rollouts of the two packages agree in
    their decisions only, not in the rounded poses)."""
    data, cache, _ = env
    argv = ["run", "--data", data, "--mapprep", "oracle", "--mode", mode,
            "--frames", "6", "--f64"]
    rc, jrecs, jerrs, _ = _cli(capsys, [*argv, "--cache-dir",
                                        cache + "_jax_oracle"],
                               main=jcli.main)
    assert rc == 0
    rc, recs, errs, _ = _cli(capsys, [*argv, "--cache-dir", cache,
                                      "--device", "cpu"])
    assert rc == 0
    assert len(recs) == 6 and recs == jrecs
    for k in ("frames", "tracked", "ate_rmse_m", "ate_keyframes"):
        assert errs[-1].get(k) == jerrs[-1].get(k), k


def test_prepare_map_oracle_equals_jax(env, capsys, tmp_path):
    """prepare-map --mapprep oracle --dump: the JAX CLI's line count and
    the same reference-format files, byte for byte; the cached artifacts
    are the oracle's f64 arrays."""
    data, cache, ds = env
    dumps = [str(tmp_path / "port"), str(tmp_path / "jax")]
    rc, recs, _, _ = _cli(capsys, ["prepare-map", *_args(env), "--mapprep",
                                   "oracle", "--dump", dumps[0]])
    assert rc == 0
    rc, jrecs, _, _ = _cli(capsys, ["prepare-map", "--data", data,
                                    "--cache-dir", cache + "_jax_dump",
                                    "--mapprep", "oracle", "--dump",
                                    dumps[1]], main=jcli.main)
    assert rc == 0
    assert recs[0]["lines"] == jrecs[0]["lines"] > 0
    assert recs[0]["cache_shape"] == list(jrecs[0]["cache_shape"])
    for name in ("MaplinesInfo.txt", "mapCache.txt", "MaplineIm.txt"):
        with open(os.path.join(dumps[0], name), "rb") as a, \
                open(os.path.join(dumps[1], name), "rb") as b:
            assert a.read() == b.read(), name
    want = odrv.prepare_map(ds.map_value, ds.param.resol)
    lines, field = prepare_map_cached(ds.map_value, ds.param.resol,
                                      cache_dir=cache, dtype=torch.float64,
                                      device="cpu", backend="oracle")
    assert np.array_equal(lines.numpy(), want.lines_info)
    assert np.array_equal(field.numpy(), want.map_cache)


@pytest.mark.parametrize("argv", [
    ["refine"], ["profile", "--repeats", "1"], ["batch"], ["serve"]])
def test_mapprep_oracle_every_command(env, capsys, argv):
    """The other commands that take --mapprep run on the oracle's map."""
    data, cache, _ = env
    many = argv[0] in ("batch", "serve")
    rc, recs, _, _ = _cli(capsys, [
        argv[0], "--data", *([data, data] if many else [data]),
        "--cache-dir", cache, "--device", "cpu", "--mapprep", "oracle",
        *argv[1:]])
    assert rc == 0 and recs
    if many:
        assert [r["frames"] for r in recs] == [F, F]


def test_bench_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, recs, _, err = _cli(capsys, ["bench"])
    assert rc == 2 and recs == []
    assert "torch.cuda.is_available() is False" in err


def test_module_entry_point(env):
    res = subprocess.run([sys.executable, "-m", "lsdtpu_torch.cli", "run",
                          *_args(env), "--frames", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.splitlines()) == 2
