"""The port's bench entry point (lsdtpu_torch.bench) on the CPU: with
LSDTPU_BENCH_BACKEND=cpu it prints one JSON line with bench.py's keys
over a small dataset directory, the oracle as its baseline, every frame
tracked and the poses of the port's run_sequence; a failed device probe
exits non-zero having run nothing; `python -m lsdtpu_torch.bench`
starts (and without a card exits 2 with resolve_device's message)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lsdtpu_torch import bench
from lsdtpu_torch.io import load_dataset
from lsdtpu_torch.runtime import loop

from torch_parity import write_dataset

F = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of bench.py's JSON line (its result_json and the extras)
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "n_repeats", "median_ms",
    "min_ms", "max_ms", "max_scans_per_sec", "baseline_scans_per_sec",
    "baseline_kind", "baseline_reset_frames", "baseline_note", "backend",
    "method", "ate_rmse_m", "tracked", "frames"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference root holding data1 (seed 1's scene, F frames) where
    the bench looks for it, and no C++ sources."""
    root = tmp_path_factory.mktemp("reference")
    data = root / "data_20190513" / "data_f3key" / "data1"
    data.mkdir(parents=True)
    write_dataset(data, 1, F=F)
    return root, str(data)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_cpu_bench_line(reference, tmp_path, monkeypatch, capsys):
    root, data = reference
    monkeypatch.setenv("LSDTPU_BENCH_BACKEND", "cpu")
    monkeypatch.setattr(bench, "REFERENCE", str(root))
    rollouts = []
    run_sequence = loop.run_sequence

    def recording(*a, **k):
        out = run_sequence(*a, **k)
        rollouts.append(out["pose"].clone())
        return out

    monkeypatch.setattr(loop, "run_sequence", recording)
    assert bench.main(data=data, device="cuda",
                      cache_dir=str(tmp_path)) == 0
    out, err = capsys.readouterr()
    recs = _json_lines(out)
    assert len(recs) == 1 and len(out.splitlines()) == 1
    rec = recs[0]
    assert BENCH_KEYS <= set(rec)
    assert rec["backend"] == "cpu" and rec["card"] is None
    assert rec["baseline_kind"] == "oracle" and rec["baseline_reset_frames"] == 0
    assert rec["metric"] == "scans_per_sec" and rec["method"] == "time-to-value"
    assert rec["n_repeats"] == bench.REPEATS
    assert rec["tracked"] == rec["frames"] == F
    assert rec["value"] > 0 and rec["baseline_scans_per_sec"] > 0
    assert "device-resident" not in err      # no copy to separate on the CPU
    # 1 warm + REPEATS timed rollouts, each the plain run_sequence's poses
    assert len(rollouts) == 1 + bench.REPEATS
    ds = load_dataset(data)
    lines, cache = bench.prepare_map_cached(
        ds.map_value, ds.param.resol, cache_dir=str(tmp_path),
        dtype=torch.float64, device="cpu", backend="oracle")
    ctx = loop.make_map_context(lines, cache, ds.param.resol, ds.param.ori_x,
                                ds.param.ori_y, dtype=np.float32,
                                device="cpu")
    want = run_sequence(loop.stack_frames(ds, dtype=np.float32), ctx,
                        bench.bench_cfg(), device="cpu")["pose"]
    for poses in rollouts:
        assert torch.equal(poses, want)


def test_bench_cfg_pins_bench_shapes():
    cfg = bench.bench_cfg()
    assert cfg.shapes.max_candidates == 4096
    assert cfg.shapes.max_scan_pixels == 2048


@pytest.mark.parametrize("probe,timeout,msg", [
    ("import sys; sys.exit('the card did not answer')", "60",
     "the card did not answer"),
    ("import time; time.sleep(60)", "1", "no answer within 1 s")])
def test_failed_probe_runs_nothing(reference, monkeypatch, capsys, probe,
                                   timeout, msg):
    """A probe that fails or hangs: exit 2 with its message, no JSON
    line, nothing run - the bench does not fall back to the CPU."""
    monkeypatch.delenv("LSDTPU_BENCH_BACKEND", raising=False)
    monkeypatch.setenv("LSDTPU_PROBE_TIMEOUT", timeout)
    monkeypatch.setattr(bench, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(bench, "PROBE_CODE", probe)
    monkeypatch.setattr(bench, "PROBE_RETRIES", 2)
    monkeypatch.setattr(bench, "PROBE_WAIT_S", 0.0)

    def never(*a, **k):
        raise AssertionError("the bench ran after a failed probe")

    monkeypatch.setattr(bench, "run", never)
    monkeypatch.setattr(bench, "load_dataset", never)
    assert bench.main(data=reference[1]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "DEVICE PROBE FAILED" in err and msg in err
    assert err.count("device probe attempt") == 1


def test_module_entry_point_cpu(reference):
    """python -m lsdtpu_torch.bench with the default data path (data1
    under $LSDTPU_REFERENCE) and LSDTPU_BENCH_BACKEND=cpu."""
    env = dict(os.environ, LSDTPU_BENCH_BACKEND="cpu",
               LSDTPU_REFERENCE=str(reference[0]))
    res = subprocess.run([sys.executable, "-m", "lsdtpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    recs = _json_lines(res.stdout)
    assert len(recs) == 1 and recs[0]["frames"] == F
    assert recs[0]["backend"] == "cpu"


def test_module_entry_point_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items()
           if k != "LSDTPU_BENCH_BACKEND"}
    res = subprocess.run([sys.executable, "-m", "lsdtpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 2 and res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
