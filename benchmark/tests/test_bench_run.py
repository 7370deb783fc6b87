"""The runner's contract: its exits without a card or without the
program, the look for JAX once the window has closed, and the shape of
the result line; and, on the card, one short run of a cell."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

import run as runner
from conftest import BENCH, ROOT


def run_cli(cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fleet.f3key-data1",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def test_no_card_exits_nonzero_with_no_result(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        runner.main(["--workload", "fleet.f3key-data1", "--seed", "1",
                     "--seconds", "1"])
    assert e.value.code == 2


def test_too_few_cards_exit_nonzero(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        runner.main(["--workload", "fleet.f3key-data1", "--seed", "1",
                     "--seconds", "1"])
    assert e.value.code == 2


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = run_cli(tmp_path, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "lsdtpu"])
def test_jax_loaded_after_the_window_ends_the_run(tiny, monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(SystemExit) as e:
        runner.execute(tiny("fleet"), 5, 0.3, 0, "program", "cpu")
    assert e.value.code == 1


def test_the_program_itself_is_not_flagged():
    import lsdtpu_torch  # noqa: F401
    assert runner.loaded_forbidden() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(runner.FORBIDDEN))
    assert "lsdtpu_torch" not in runner.loaded_forbidden()


def test_result_line_keys_in_order(tiny):
    res, lines, checks = runner.execute(tiny("fleet"), 6, 0.3, 0,
                                        "program", "cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"scan_p95_ms", "scan_p50_ms", "setup_s"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {c["name"] for c in checks}
    json.loads(json.dumps(res))


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    res = run_cli(ROOT, "--seconds", "3")
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
