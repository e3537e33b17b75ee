"""The benchmark's process loads neither JAX, Flax, the JAX package
``repro`` nor its ``benchmarks``; its entry point refuses to run without
a card and outside a full checkout."""
import json
import os
import shutil
import subprocess
import sys

from bench import harness, spec

ROOT = spec.ROOT

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[0:0] = [{root!r}, {src!r}]
import torch
import bench
from bench import harness, spec
for m in pkgutil.walk_packages(bench.__path__, "bench."):
    importlib.import_module(m.name)
importlib.import_module("bench.run")
importlib.import_module("bench.readings")
bench_json = spec.load_json(spec.ROOT / "BENCHMARK.json")
for m in bench_json["end_to_end"] + bench_json["per_layer"]:
    spec.load_reader(m["name"])
from bench.tests import tiny
out = harness.run(tiny.cell(batch_size=8), 3, 0.2, False,
                  torch.device("cpu"), 0.0)
print(json.dumps({{"foreign": harness.foreign_modules(list(sys.modules)),
                  "correct": out["correct"]}}))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_whole_names_are_compared():
    names = ["repro_torch.serving", "jaxtyping", "benchmarks_torch.run",
             "repro.core.vnge", "jax.numpy", "flax", "reproduce",
             "bench.run", "benchmarks.common", "jaxlib"]
    assert harness.foreign_modules(names) == [
        "benchmarks.common", "flax", "jax.numpy", "jaxlib",
        "repro.core.vnge"]


def test_the_harness_loads_no_jax_and_no_jax_package():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"foreign": [], "correct": True}


def _run_py(cwd, env):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "as-oregon.steady",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run_py(ROOT, _env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, _env())
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
