"""Everything of a cell, found by name.

``BENCHMARK.json`` (the checkout's root) names the cells; a cell's
traffic file is ``workloads/<cell>.json``, its configuration the file
its configuration entry names, its traffic kind ``traffic/<kind>.py``
and each per-layer metric ``metrics/<metric>.py``.  Adding a cell, a
configuration or a metric adds files and entries and edits none.  A
cell built in code (the tests) may name its traffic kind's file itself
(``kind_file``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    workload: dict       # workloads/<cell>.json
    end_to_end: list     # BENCHMARK.json's end-to-end metrics of this cell
    per_layer: list      # BENCHMARK.json's per-layer metrics of this cell
    kind_file: Optional[str] = None   # default traffic/<kind>.py

    @property
    def kind(self) -> str:
        return self.workload["traffic"]

    def traffic_module(self):
        path = Path(self.kind_file) if self.kind_file else \
            BENCH_DIR / "traffic" / f"{self.kind}.py"
        return load_module(path, f"traffic_{self.kind}")

    def metric_reader(self, name: str):
        return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                           f"metric_{name.replace('.', '_')}")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, bench: dict = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"({sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"] or \
            workload["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json names config "
                         f"{workload['config']!r} and traffic "
                         f"{workload['traffic']!r}; BENCHMARK.json "
                         f"{entry['config']!r} and {entry['traffic']!r}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry, config, workload, e2e, layer)
