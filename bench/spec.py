"""What a cell is: its entries in BENCHMARK.json and the files they name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by name:

- a configuration: ``bench/configs/<name>.json`` (the file that
  BENCHMARK.json's ``configs`` entry names);
- a traffic mix: ``bench/mixes/<traffic>.json``, read by
  `bench.traffic`;
- a metric: ``bench/metrics/<metric name>.py``, a reader with
  ``read(record) -> float | None``.

So a later change adds a cell, a configuration, a mix or a metric as new
files and entries, and edits none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    per_layer: bool
    read: Callable


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    metrics: List[Metric]

    def reported(self, trace: bool) -> List[Metric]:
        """The metrics a run prints: the end-to-end ones untraced, the
        per-layer ones traced."""
        return [m for m in self.metrics if m.per_layer == trace]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str) -> Callable:
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def load_config(name: str, benchmark: Optional[dict] = None) -> dict:
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    entry = {c["name"]: c for c in benchmark["configs"]}[name]
    return load_json(ROOT / entry["file"])


def load_mix(name: str) -> dict:
    return load_json(BENCH / "mixes" / f"{name}.json")


def load_cell(workload: str, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with its configuration,
    mix and the readers of the metrics it reports."""
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    metrics = []
    for per_layer, group in ((False, "end_to_end"), (True, "per_layer")):
        for m in benchmark[group]:
            metrics.append(Metric(m["name"], m["unit"], per_layer,
                                  load_reader(m["name"])))
    return Cell(workload, load_config(cell["config"], benchmark),
                load_mix(cell["traffic"]), int(cell["chips"]), metrics)
