"""The configuration, mix and cell files load by name, every metric has
its reader, and BENCHMARK.json keeps to its format: the keys, names,
units, bounds and references between entries."""
import re

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def _listed(group):
    return {m["name"] for m in BENCH[group]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load_by_name(cell):
    c = spec.load_cell(cell)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert c.chips == entry["chips"]
    assert {m.name for m in c.reported(False)} == _listed("end_to_end")
    assert {m.name for m in c.reported(True)} == _listed("per_layer")
    svc = c.config["service"]
    assert svc["method"] in ("fused_tick", "sparse_tick")
    assert (svc["placement"], svc["ingestion"], svc["exact_smax"],
            svc["max_queue"]) == ("local", "double_buffered", True, 2)
    assert c.config["guarantees"]["exact_smax"] is True
    if svc["method"] == "sparse_tick":
        assert "edge_gap" in c.config["limits"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric")


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"])
            for text in ("why", "layer", "source"):
                if text in e and group in ("configs", "workloads",
                                           "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        spec.load_reader(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends


def test_configs_name_their_files_and_cells_their_configs():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        cfg = spec.load_config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        spec.load_mix(w["traffic"])
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
