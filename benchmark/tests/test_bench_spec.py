"""BENCHMARK.json against the benchmark's contract, and every entry
resolved to its files by name."""

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_size(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for s in [c["source"] for c in bench["configs"]] + \
            [w["why"] for w in bench["workloads"]] + \
            [c["why"] for c in bench["configs"]]:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_every_entry_resolves_to_its_files(bench):
    from harness.spec import find_cell
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        cell = find_cell(w["name"], bench)
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.traffic_module(), "Run")
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
        for name in cell.workload["limits"]:
            assert NAME.match(name)
    assert used == configs
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(BENCH)
        assert json.loads(path.read_text())["reduced"] == c["reduced"]


def test_every_traffic_file_names_its_config_and_kind(bench):
    # traffic files of cells not (or no longer) in BENCHMARK.json too: a
    # later PR adds such a cell with an entry alone
    configs = {c["name"] for c in bench["configs"]}
    for p in sorted((BENCH / "workloads").glob("*.json")):
        wl = json.loads(p.read_text())
        assert wl["config"] in configs, p
        assert (BENCH / "traffic" / f"{wl['traffic']}.py").exists(), p
        assert p.stem.startswith(wl["traffic"] + "."), p
        assert wl["limits"], p


def test_per_layer_workloads_name_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    # each layer named as PERF.md's list of layers names it
    perf = (ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_file_names_use_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


COMPARED = {
    "fleet": {"pose_gap_max_px", "score_gap_median", "score_gap_p90",
              "decision_flip_share", "truth_gap_px"},
    "replay": {"pose_gap_max_px", "score_gap_median", "score_gap_p90",
               "decision_flip_share", "truth_gap_px"},
    "mapswitch": {"field_gap_max_m", "line_recall_2px", "line_recall_25px",
                  "line_count_ratio_min", "line_count_ratio_max",
                  "first_pose_gap_median_px"},
}


def test_every_compared_number_has_its_limit(bench):
    """A number without a limit is only printed: each cell's traffic file
    holds a limit for every number that decides ``correct``."""
    from harness.spec import find_cell
    for w in bench["workloads"]:
        cell = find_cell(w["name"], bench)
        assert COMPARED[cell.kind] <= set(cell.workload["limits"]), w["name"]
