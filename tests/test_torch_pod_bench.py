"""scripts/torch_pod_bench.py, the port of scripts/pod_bench.py, on the CPU
on a written 40-frame seed-1 scene (the 200x260 room), always with
--data:

  * world size 1: --dry with 2 repeats runs all four modes, each with
    scans/s > 0, a finite median and 2 repeats (the reference's
    tests/test_pod_bench.py asserts);
  * world size 2: two rank processes of the script over gloo (torchrun's
    environment, a file store): dp, serving and temporal run across the
    ranks (2 sequences, sessions, segments) and only rank 0 writes;
  * the json's keys, mode by mode, are the reference script's at two
    devices, but for the stated differences ("card" and "dist_backend"
    added, "backend" the device type);
  * the serving sessions are reset before every repeat: the last
    repeat's poses are the first's bit for bit.

The numbers mean nothing here (ranks share the host's cores): these are
plumbing checks."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import load_script, write_dataset

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_pod_bench.py"
MODES = ("solo", "dp", "serving", "temporal")
F = 40
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod_bench_scene")
    write_dataset(d, 1, F=F)
    return str(d)


class RankGroup:
    """The script on two gloo rank processes, started at once; ``result()``
    waits for them: ([rank logs], {rank: json or None})."""

    def __init__(self, data, tmp):
        self.tmp = tmp
        self.procs = []
        for r in range(2):
            env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                       OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, str(SCRIPT), "--dry", "--device", "cpu",
                 "--frames", str(F), "--repeats", "1", "--data", data,
                 "--init-method", f"file://{tmp / 'store'}",
                 "--out", str(tmp / f"rank{r}.json")],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        self._res = None

    def result(self):
        if self._res is None:
            try:
                logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0]
                        for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r}\n{log[-3000:]}"
            self._res = logs, {
                r: (json.loads((self.tmp / f"rank{r}.json").read_text())
                    if (self.tmp / f"rank{r}.json").exists() else None)
                for r in range(2)}
        return self._res


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    group = RankGroup(data, tmp_path_factory.mktemp("pod_bench_ranks"))
    yield group
    for p in group.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_world1_dry_all_modes(data, tmp_path, two_ranks):
    # (the two ranks of test_world2_over_gloo run meanwhile)
    out = tmp_path / "scaling.json"
    rc = load_script("torch_pod_bench").main(
        ["--dry", "--device", "cpu", "--frames", str(F), "--repeats", "2",
         "--data", data, "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["backend"] == "cpu" and got["card"] is None
    assert got["n_devices"] == got["n_processes"] == 1
    assert got["frames"] == F
    assert got["dist_backend"] == "gloo"
    for mode in MODES:
        assert mode in got, f"mode {mode} missing from SCALING json"
        assert got[mode]["scans_per_sec"] > 0
        assert np.isfinite(got[mode]["median_s"])
        assert got[mode]["n_repeats"] == 2
    assert got["dp"]["n_sequences"] == 1
    assert got["serving"]["n_sessions"] == 1
    assert got["temporal"]["n_segments"] == 1


def test_world2_over_gloo(two_ranks):
    logs, got = two_ranks.result()
    assert got[1] is None, "rank 1 wrote the json"
    g = got[0]
    assert g["n_devices"] == g["n_processes"] == 2
    assert g["dist_backend"] == "gloo"
    for mode in MODES:
        assert g[mode]["scans_per_sec"] > 0
        assert np.isfinite(g[mode]["median_s"])
    assert g["dp"]["n_sequences"] == 2
    assert g["serving"]["n_sessions"] == 2
    assert g["temporal"]["n_segments"] == 2
    for log in logs:
        assert "backend gloo, world size 2" in log


def test_keys_match_the_reference_script(data, tmp_path, two_ranks):
    out = tmp_path / "scaling_jax.json"
    rc = load_script("pod_bench").main(
        ["--dry", "--cpu", "--n-devices", "2", "--frames", str(F),
         "--repeats", "1", "--data", data, "--out", str(out)])
    assert rc == 0
    want = json.loads(out.read_text())
    got = two_ranks.result()[1][0]
    assert set(got) == set(want) | {"card", "dist_backend"}
    assert want["backend"] == "cpu" and got["backend"] == "cpu"
    for mode in MODES:
        assert set(got[mode]) == set(want[mode]), mode
    for key in ("n_devices", "frames", "dry"):
        assert got[key] == want[key]


def test_serving_repeats_replay_the_same_workload(data):
    pb = load_script("torch_pod_bench")
    args = pb.parse(["--device", "cpu", "--frames", str(F), "--repeats",
                     "2", "--data", data])
    b = pb.Bench(args, torch.device("cpu"), 1)
    res, poses = pb.mode_serving(b, None)
    assert res["n_repeats"] == 2 and len(poses) == 2
    for sid, p in poses[0].items():
        assert p.shape == (F, 3)
        np.testing.assert_array_equal(poses[-1][sid], p)
