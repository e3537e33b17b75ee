"""The op counter (`launch.op_analysis`) and the meta-device dry run
(`launch.dryrun`), on the CPU.

- The counterparts of `tests/test_hlo_analysis.py`: one matmul exact;
  a Python loop counts every trip, nested loops multiply; traffic is
  nonzero and scales with the loop; collectives on a fake-PG mesh are
  counted with their bytes, per device (the local shard's FLOPs, not
  the global product's).
- One reduced forward's FLOPs against the reference's
  `hlo_analysis.analyze` of the same function compiled on the CPU:
  equal within 1e-6 relative. Both count 2·M·N·K for every matmul and
  the models run the same matmuls (every chunk pair of the attention
  included); the bytes are not compared, since XLA fuses elementwise
  chains that eager PyTorch runs op by op (the port counts 1.3–1.9×
  the reference's bytes on these models).
- In a subprocess with a fake group of 4 ranks: a reduced cell of
  `dryrun_cell` on a 2×2 mesh ends OK for a train, a prefill and a
  decode shape; a 2-period and a 4-period model count in proportion
  (c4 − c2 = 2·(c2 − c1), to 1e-9), so the dry run's extrapolation
  from one and two periods equals a direct count at four.
- The dry run fails by name without the fake process group, and the
  production mesh by name on a group of the wrong size.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.distributed.sharding import NO_SHARDING as J_NO
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.models import api as jax_api
from repro.models.params import init_params as jax_init_params
from repro_torch import interop
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import api as pt_api

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_matmul_exact(device):
    a = torch.zeros(256, 256, device=device)
    r = analyze(lambda x, y: x @ y, a, a)
    assert r["flops"] == 2 * 256 ** 3
    assert r["bytes"] == 3 * 256 * 256 * 4  # two operands, one output
    assert r["n_ops"] == 1 and r["collective_bytes"] == 0


def test_loop_counts_every_trip():
    x = torch.zeros(128, 128)

    def f(c, w, n):
        for _ in range(n):
            c = c @ w
        return c

    assert analyze(f, x, x, 7)["flops"] == 7 * 2 * 128 ** 3

    def nested(c, w):
        for _ in range(3):
            c = f(c, w, 4)
        return c

    assert analyze(nested, x, x)["flops"] == 12 * 2 * 128 ** 3


def test_traffic_nonzero_and_scales_with_loop():
    x = torch.zeros(256, 256)

    def f(c, w, n):
        for _ in range(n):
            c = torch.relu(c @ w)
        return c

    b1 = analyze(f, x, x, 2)["bytes"]
    b2 = analyze(f, x, x, 8)["bytes"]
    assert b1 > 0 and b2 == 4 * b1


def test_slices_and_updates_count_their_payload():
    acc = torch.zeros(10, 4096)
    w = torch.ones(100, 4096)

    def f():
        for i in range(10):
            acc[i] = w[i]
        return acc

    r = analyze(f)
    row = 4096 * 4
    # each trip: two selects (twice their output) and a copy (twice the
    # update); the storage allocated and live at once is none
    assert r["bytes"] == 10 * (2 * row + 2 * row + 2 * row)
    assert r["peak_bytes"] == 0


def test_peak_counts_live_allocations():
    x = torch.zeros(64, 32)
    w = torch.zeros(32, 64)

    def f(a, b):
        y = a @ b
        z = torch.relu(y)
        del y
        return torch.relu(z)

    assert analyze(f, x, w)["peak_bytes"] == 2 * 64 * 64 * 4


_FAKE = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.launch.op_analysis import analyze
m = init_device_mesh("cpu", (4,), mesh_dim_names=("d",))
x = distribute_tensor(torch.zeros(256, 256, device="meta"), m, [Shard(0)])
r = analyze(lambda a: (a @ a.T).sum(), x)
out = {"coll": r["collectives"], "flops": r["flops"]}

import dataclasses
import repro_torch.launch.dryrun as D
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.distributed.sharding import single_pod_rules
cfg = get_config("granite-moe-3b-a800m").reduced()
cells = {}
for kind, seq, batch in (("train", 64, 8), ("prefill", 64, 4),
                         ("decode", 64, 4)):
    res = D.dryrun_cell("granite-moe-3b-a800m", "tiny", cfg=cfg,
                        shape=ShapeConfig("tiny", seq, batch, kind),
                        mesh_shape=(2, 2), tp=2, verbose=False)
    cells[kind] = {k: res[k] for k in ("status", "n_chips", "device_flops",
                                       "collective_total", "mem_args_bytes",
                                       "mem_peak_gb", "bottleneck")}
out["cells"] = cells
# the extrapolation against direct counts at 1, 2 and 4 periods
mesh = D._mesh((2, 2), False)
rules = single_pod_rules(2)
shape = ShapeConfig("tiny", 64, 8, "train")
cfg4 = dataclasses.replace(cfg, n_layers=4 * 2)  # period 2 (moe_period)
args = (mesh, rules, False)
D._count(cfg4, shape, *args, 1, 8)  # the uncounted first run
c = {k: D._count(cfg4, shape, *args, k, 8) for k in (1, 2, 4)}
ext = D._extrapolate(c[1], c[2], 4)
keep = lambda d: {"flops": d["flops"], "bytes": d["bytes"],
                  "coll": sum(d["collectives"].values())}
out["counts"] = {str(k): keep(v) for k, v in c.items()}
out["extrapolated"] = keep(ext)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_run():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _FAKE], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collectives_counted_per_device(fake_run):
    # x (256, 256) split over 4 ranks: the local (64, 256) @ (256, 256)
    # after an all-gather of the transposed operand
    assert fake_run["flops"] == 2 * 64 * 256 * 256
    assert fake_run["coll"]["all-gather"] == 256 * 256 * 4
    assert sum(fake_run["coll"].values()) == 256 * 256 * 4


def test_reduced_cells_run_on_a_fake_mesh(fake_run):
    for kind, cell in fake_run["cells"].items():
        assert cell["status"] == "OK", kind
        assert cell["n_chips"] == 4
        assert cell["device_flops"] > 0 and cell["mem_args_bytes"] > 0
        assert cell["bottleneck"] in ("compute", "memory", "collective")
    assert fake_run["cells"]["train"]["collective_total"] > 0


def test_periods_count_in_proportion(fake_run):
    c = fake_run["counts"]
    for key in ("flops", "bytes", "coll"):
        assert c["4"][key] - c["2"][key] == pytest.approx(
            2 * (c["2"][key] - c["1"][key]), rel=1e-9), key
        assert fake_run["extrapolated"][key] == pytest.approx(
            c["4"][key], rel=1e-9), key
    assert c["2"]["flops"] > c["1"]["flops"] > 0


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_forward_flops_match_the_reference_hlo(name):
    cfg = jax_get_config(name).reduced()
    params = jax_init_params(jax_api.model_param_defs(cfg, J_NO),
                             jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256))
    toks = toks.astype(np.int32)
    fwd = jax_api.build_forward_fn(cfg, J_NO, remat=False)
    compiled = jax.jit(fwd).lower(params, {"tokens": jnp.asarray(toks)}) \
        .compile()
    want = hlo_analyze(compiled.as_text())["flops"]
    pp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          params), "cpu")
    with torch.no_grad():
        got = analyze(pt_api.build_forward_fn(get_config(name).reduced(),
                                              remat=False),
                      pp, {"tokens": torch.from_numpy(toks)})["flops"]
    assert got == pytest.approx(want, rel=1e-6)


def test_dry_run_fails_by_name_without_the_fake_group(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(dryrun.DryRunError, match="fake_pg"):
        dryrun.fake_world(4)


def test_production_mesh_needs_its_world():
    with pytest.raises(mesh.MeshSizeError, match="world size 256"):
        mesh.make_production_mesh()
    with pytest.raises(mesh.MeshSizeError, match="world size 512"):
        mesh.make_production_mesh(multi_pod=True)


def test_skip_set_is_the_reference_set():
    from repro_torch.configs.archs import ARCH_IDS
    from repro_torch.configs.base import SHAPES

    skips = {(a, s) for a in ARCH_IDS for s, shape in SHAPES.items()
             if dryrun.skip_reason(get_config(a), shape)}
    assert skips == {(a, "long_500k") for a in ARCH_IDS
                     if a not in ("h2o-danube-1.8b", "jamba-1.5-large-398b",
                                  "mamba2-130m")}
