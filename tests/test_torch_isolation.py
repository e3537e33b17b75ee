"""The port stands alone and keeps its device rules.

- Importing `repro_torch` and every submodule loads neither JAX nor any
  module of the JAX package `repro`; neither does ``chip_smoke.py``, the
  bench twin ``tools/streams_bench_torch.py``, nor any file of the
  paper-script and example twins (``benchmarks_torch/``,
  ``examples_torch/``).
- Asking for ``cuda`` where CUDA is unavailable raises; nothing carries
  on quietly on the CPU. Every twin runs on the card by default and,
  without one, fails by name unless given ``--device cpu``.
- On CPU tensors the kernel wrappers run their plain versions and leave
  their ``LAUNCHES`` counts unchanged, and their launchers refuse CPU
  tensors.
- Every kernel package ships a ``parity.py``; discovery fails by name
  for one that does not.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.kernels import dispatch
from repro_torch.kernels.bsr_spmv import ops as bs_ops
from repro_torch.kernels.bsr_spmv import parity as bs_parity
from repro_torch.kernels.delta_stats import ops as ds_ops
from repro_torch.kernels.delta_stats import parity as ds_parity
from repro_torch.kernels.entropy_probe import ops as ep_ops
from repro_torch.kernels.entropy_probe import parity as ep_parity
from repro_torch.kernels.parity import (ParityRegistrationError,
                                        discover_parity_modules)
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.sparse_tick import parity as sp_parity
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.kernels.stream_tick import parity as st_parity
from repro_torch.kernels.vnge_q import ops as vq_ops
from repro_torch.kernels.vnge_q import parity as vq_parity

ROOT = Path(__file__).resolve().parents[1]


def _foreign(names):
    return sorted(m for m in names
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_import_every_submodule_loads_no_jax_and_no_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")]
    ported = ("repro_torch.serving.service",
              "repro_torch.kernels.stream_tick.ops",
              "repro_torch.core.sparse", "repro_torch.kernels.sparse_tick.ops",
              "repro_torch.kernels.sparse_tick.ref",
              "repro_torch.kernels.sparse_tick.parity",
              "repro_torch.serving.migrate", "repro_torch.serving.ingest",
              "repro_torch.serving.plans", "repro_torch.serving.config",
              "repro_torch.graphs.layout", "repro_torch.engine.stream",
              "repro_torch.configs.granite_moe_3b",
              "repro_torch.models.transformer", "repro_torch.models.moe",
              "repro_torch.models.api", "repro_torch.data.pipeline",
              "repro_torch.optim.adamw", "repro_torch.train.step",
              "repro_torch.train.telemetry", "repro_torch.train.checkpoint",
              "repro_torch.train.fault_tolerance",
              "repro_torch.launch.train", "repro_torch.launch.serve",
              "repro_torch.models.mamba2", "repro_torch.models.whisper",
              "repro_torch.kernels.parity",
              "repro_torch.kernels.vnge_q.ops",
              "repro_torch.kernels.entropy_probe.ops",
              "repro_torch.kernels.bsr_spmv.ops",
              "repro_torch.kernels.bsr_spmv.parity",
              "repro_torch.graphs.spectral", "repro_torch.graphs.streams",
              "repro_torch.core.bounds", "repro_torch.core.directed",
              "repro_torch.core.higher_order",
              "repro_torch.baselines.deltacon", "repro_torch.fleet",
              "repro_torch.fleet.config", "repro_torch.fleet.directory",
              "repro_torch.fleet.errors", "repro_torch.fleet.fleet",
              "repro_torch.fleet.pooltick", "repro_torch.fleet.rebalance",
              "repro_torch.fleet.recovery", "repro_torch.fleet.router",
              "repro_torch.distributed", "repro_torch.distributed.sharding",
              "repro_torch.distributed.finger_dist",
              "repro_torch.distributed.compression",
              "repro_torch.analysis", "repro_torch.analysis.__main__",
              "repro_torch.analysis.sanitize", "repro_torch.analysis.lint",
              "repro_torch.analysis.smem", "repro_torch.analysis.tick_audit",
              "repro_torch.analysis.sentinel", "repro_torch.launch.mesh",
              "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
              "repro_torch.tracing")
    assert set(ported) <= set(names)
    code = ("import importlib, sys\n"
            f"for m in {names!r}: importlib.import_module(m)\n"
            "print('\\n'.join(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert set(ported) <= set(out)
    assert _foreign(out) == []


def _imported(path):
    """Every module a script's source imports, at any depth."""
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


def test_chip_smoke_imports_no_jax_and_no_repro():
    mods = _imported(ROOT / "chip_smoke.py")
    assert "repro_torch.serving" in mods
    assert _foreign(mods) == []


def test_streams_bench_twin_imports_no_jax_and_no_repro():
    mods = _imported(ROOT / "tools" / "streams_bench_torch.py")
    assert "repro_torch.serving" in mods
    assert _foreign(mods) == []


TWIN_DIRS = ("benchmarks_torch", "examples_torch")


def test_twins_import_no_jax_and_no_repro():
    files = sorted(p for d in TWIN_DIRS for p in (ROOT / d).glob("*.py"))
    names = {p.name for p in files}
    assert {"common.py", "fig1_degree.py", "fig2_size.py",
            "fig4_bifurcation.py", "table2_wiki.py", "table3_dos.py",
            "run.py", "quickstart.py", "anomaly_detection.py",
            "train_with_entropy_probe.py", "serve_streams.py",
            "serve_batched.py"} <= names
    for path in files:
        mods = _imported(path)
        assert _foreign(mods) == [], path
        # nothing of the reference's benchmarks or examples either
        assert not [m for m in mods
                    if m.split(".")[0] in ("benchmarks", "examples")], path
    code = ("import importlib, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            + "".join(f"importlib.import_module('{p.parent.name}."
                      f"{p.stem}')\n" for p in files)
            + "print('\\n'.join(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert _foreign(out) == []
    assert "benchmarks_torch.run" in out and "examples_torch.serve_streams" \
        in out


def test_twins_fail_by_name_without_a_card(monkeypatch, tmp_path):
    sys.path[:0] = [str(ROOT)]
    try:
        from benchmarks_torch import (fig1_degree, fig2_size,
                                      fig4_bifurcation, run, table2_wiki,
                                      table3_dos)
        from examples_torch import (anomaly_detection, quickstart,
                                    serve_batched, serve_streams,
                                    train_with_entropy_probe)
        from repro_torch.launch import serve
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [fig1_degree.run, fig2_size.run, fig4_bifurcation.run,
             table2_wiki.run, table3_dos.run, lambda: run.main([]),
             quickstart.main, anomaly_detection.main,
             lambda: train_with_entropy_probe.main(
                 ["--steps", "1", "--ckpt-dir", str(tmp_path)]),
             lambda: serve_streams.main([]),
             lambda: serve_streams.main(["--fleet"]),
             lambda: serve_batched.main([]),
             lambda: serve.main(["--reduced"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    # the scripts as a user starts them, with no card visible
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    for argv in (["-m", "benchmarks_torch.run", "--only", "fig4"],
                 [str(ROOT / "examples_torch" / "quickstart.py")]):
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert "fig4/" not in proc.stdout and "graph:" not in proc.stdout


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
            env.pop("PYTHONPATH")
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


def test_cuda_requests_raise_without_cuda(monkeypatch):
    from repro_torch.engine import StreamEngine
    from repro_torch.serving import FingerService, ServiceConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dispatch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        dispatch.resolve_device(None)  # the default is CUDA
    with pytest.raises(RuntimeError, match="is_available"):
        StreamEngine(method="fused_tick")
    g = erdos_renyi(8, 0.5, seed=0, weighted=True)
    with pytest.raises(RuntimeError, match="is_available"):
        StreamEngine.init_states([g], n_pad=8)
    cfg = ServiceConfig(batch_size=1, n_pad=8, k_pad=2,
                        method="fused_tick")
    with pytest.raises(RuntimeError, match="is_available"):
        FingerService.open(cfg, [g], device="cuda")
    sparse = ServiceConfig(batch_size=1, n_pad=8, k_pad=2,
                           method="sparse_tick", n_slots=8, m_pad=32)
    with pytest.raises(RuntimeError, match="is_available"):
        FingerService.open(sparse, iter([g]))
    # the sharded placements: the default grid is every card
    from repro_torch.distributed import make_grid

    for placement in ("sharded", "multipod"):
        with pytest.raises(RuntimeError, match="is_available"):
            FingerService.open(cfg.with_(placement=placement), [g])
    with pytest.raises(RuntimeError, match="is_available"):
        make_grid((2,), ("data",))
    with pytest.raises(RuntimeError, match="is_available"):
        make_grid((2,), ("data",), "cuda:0")
    from repro_torch.fleet import (FingerFleet, FleetConfig, PoolSpec,
                                   replay_tenant)

    fleet_cfg = FleetConfig(pools=(PoolSpec(name="p", n_pad=8, k_pad=2),))
    with pytest.raises(RuntimeError, match="is_available"):
        FingerFleet.open(fleet_cfg)  # the default is CUDA
    base = {"q": 1.0, "s_total": 0.0, "s_max": 0.0,
            "strengths": np.zeros(4, np.float32),
            "node_mask": np.ones(4, np.float32)}
    with pytest.raises(RuntimeError, match="is_available"):
        replay_tenant(base, [], 0, exact_smax=False)
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.train import run
    from repro_torch import interop

    cfg = get_config("granite-moe-3b-a800m").reduced()
    with pytest.raises(RuntimeError, match="is_available"):
        run(cfg, steps=1, batch_size=1, seq=8, log=lambda *a: None)
    with pytest.raises(RuntimeError, match="is_available"):
        synthetic_batch(cfg, 1, 8, seed=0, step=0)
    with pytest.raises(RuntimeError, match="is_available"):
        interop.params_from_numpy({"w": [1.0]})
    # the offline path: a CPU graph runs where it lies unless the caller
    # asks for the card; a layout built from numpy defaults to the card
    from repro_torch.core import (exact_vnge, jsdist_exact, jsdist_fast,
                                  vnge_hat)
    from repro_torch.graphs.spectral import power_iteration_lmax
    from repro_torch.kernels.bsr_spmv.ref import dense_to_bsr, edges_to_bsr

    for fn in (exact_vnge, vnge_hat, power_iteration_lmax):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(g, device="cuda")
        assert fn(g).device.type == "cpu"
    for fn in (jsdist_fast, jsdist_exact):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(g, g, device="cuda")
    w = g.weights.numpy()
    with pytest.raises(RuntimeError, match="is_available"):
        dense_to_bsr(w, b=64)
    with pytest.raises(RuntimeError, match="is_available"):
        edges_to_bsr([0], [1], [1.0], 8, b=64)
    with pytest.raises(RuntimeError, match="is_available"):
        interop.bsr_from_numpy({"values": np.zeros((1, 1, 64, 64)),
                                "col_ids": np.zeros((1, 1))}, 64, 8)
    m = dense_to_bsr(w, b=64, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        bs_ops.power_iteration_lmax_bsr(m, device="cuda")
    assert dispatch.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_run_the_plain_versions_without_launches():
    before = (dict(st_ops.LAUNCHES), ds_ops.LAUNCHES, dict(sp_ops.LAUNCHES),
              vq_ops.LAUNCHES, dict(ep_ops.LAUNCHES), dict(bs_ops.LAUNCHES))
    states, deltas = st_parity.make_case(8, 40, 8, 2, seed=0,
                                         device="cpu")
    st_ops.stream_tick_fused(states, deltas)
    st_ops.stream_tick_fused(states, deltas, exact_smax=True, inplace=True)
    st_ops.stream_tick_fused_stacked(states.map_tensors(lambda x: x[None]),
                                     deltas.map_tensors(lambda x: x[None]))
    state, delta = ds_parity.make_case(32, 8, seed=0, device="cpu")
    ds_ops.delta_stats_fused(state, delta)
    from repro_torch.core.jsdist import jsdist_incremental

    jsdist_incremental(state, delta, method="fused_tick")
    states, d1, _ = sp_parity.make_case(8, 40, 100, 8, 2, seed=0,
                                        device="cpu")
    sp_ops.sparse_tick_fused(states, d1)
    sp_ops.sparse_tick_fused_stacked(states.map_tensors(lambda x: x[None]),
                                     d1.map_tensors(lambda x: x[None]),
                                     inplace=True)
    w, mask = vq_parity.make_case(40, seed=0, device="cpu", masked=True)
    vq_ops.vnge_q_stats(w, node_mask=mask)
    vq_ops.vnge_tilde_dense(w)
    ep_ops.attention_graph_entropy(ep_parity.make_case(2, 40, seed=0,
                                                       device="cpu"))
    m, x = bs_parity.make_case(300, 128, seed=0, device="cpu")
    bs_ops.bsr_matvec(m, x)
    bs_ops.power_iteration_lmax_bsr(m, num_iters=5)
    from repro_torch.fleet import FingerFleet, FleetConfig, PoolSpec

    for method, extra in (("fused_tick", {}),
                          ("sparse_tick", dict(n_slots=8, m_pad=16))):
        with FingerFleet.open(FleetConfig(pools=(PoolSpec(
                name="p", n_pad=8, shards=2, streams_per_shard=2, k_pad=2,
                j_pad=2, method=method, **extra),)), device="cpu") as fleet:
            fleet.admit("t", erdos_renyi(6, 0.5, seed=0, weighted=True))
            fleet.poll()  # one stacked tick of both shards, plain on CPU
            assert fleet.last_poll_launches == 1
    assert (st_ops.LAUNCHES, ds_ops.LAUNCHES, sp_ops.LAUNCHES,
            vq_ops.LAUNCHES, ep_ops.LAUNCHES, bs_ops.LAUNCHES) == before


def test_kernel_entry_points_refuse_cpu_tensors():
    states, deltas = st_parity.make_case(8, 40, 8, 2, seed=0,
                                         device="cpu")
    for name in st_ops.LAUNCHES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            st_ops._launch(name, states, deltas, exact_smax=False,
                           inplace=False)
    state, delta = ds_parity.make_case(32, 8, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ds_ops.delta_stats_sorted_cuda(*ds_ops.prepare_sorted_delta(
            state.strengths, delta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ds_ops.delta_stats_cuda(state.strengths, delta)
    states, d1, _ = sp_parity.make_case(8, 40, 100, 8, 2, seed=0,
                                        device="cpu")
    for name in sp_ops.LAUNCHES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            sp_ops._launch(name, states, d1, exact_smax=False,
                           inplace=False)
    w, _ = vq_parity.make_case(40, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        vq_ops.vnge_q_stats_cuda(w)
    x = ep_parity.make_case(2, 40, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ep_ops.row_stats_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ep_ops.graph_stats_cuda(x, x[:, 0], x[:, 0])
    m, x = bs_parity.make_case(300, 128, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x)


def test_parity_discovery_covers_every_kernel_and_fails_by_name(tmp_path):
    assert sorted(discover_parity_modules()) == [
        "bsr_spmv", "delta_stats", "entropy_probe", "sparse_tick",
        "stream_tick", "vnge_q"]
    for name in ("has_parity", "no_parity"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "ops.py").write_text("")
    (tmp_path / "has_parity" / "parity.py").write_text("")
    (tmp_path / "not_a_kernel").mkdir()
    with pytest.raises(ParityRegistrationError, match="no_parity"):
        discover_parity_modules(tmp_path)


def test_missing_nvcc_is_a_named_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(dispatch.KernelBuildError, match="nvcc not found"):
        dispatch._build_and_load()
