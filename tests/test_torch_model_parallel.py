"""The padded models on a `DeviceMesh` of 4 gloo ranks against the
single-process port, on the CPU.

One module-scoped subprocess starts 4 rank processes on ``127.0.0.1``
(gloo), as `tests/test_torch_distributed.py` does. Each rank lays a
reduced model's parameters out by `param_shardings` (DTensors), its
batch by the batch axes and its f32 decode cache by the cache's logical
axes, and runs one `build_train_step` step and four decode steps:

- a dense model with TP padding (qwen1.5-0.5b reduced to 3 query heads
  and 1 KV head, vocabulary 500: heads 3 → 4, vocabulary → 512) on a
  (data 2, model 2) mesh under `single_pod_rules(2)`;
- an MoE model with EP (granite-moe-3b-a800m reduced to 3 experts:
  experts 3 → 4, two a rank) on the same mesh;
- mamba2-130m reduced (8 SSD heads, four a rank: the SSD runs each
  rank's heads) on the same mesh;
- the dense model on a (pod 2, data 1, model 2) mesh under
  `multi_pod_rules(2)` (run with "pod" and "data" folded, as the dry
  run runs it).

Every padded ``wo`` (zero-initialized whole, as in the reference) is
drawn, so attention reaches the loss and its weights take gradients,
and the step runs at a learning rate of 1e-2 with no warmup and an
eps of 1e-3, so that the update moves the parameters well past the
tolerance and stays a smooth function of the gradient. The oracle
is the port in one process on plain tensors with the same rules (the
same padded shapes) and the same parameters. They agree within 1e-5
(rtol and atol: the ranks sum partial products in other orders) in the
loss, the gradient norm, every parameter after the step and the decode
logits (four steps at the parameters before it); and in every leaf of
the first moment after the step (0.1 × the clipped gradient) within
1e-4 of the leaf's largest element (`GRAD_TOL` says why). A planted
fault, the oracle's step on half the batch, fails that comparison.
Every rank also checks that its local shard of a tensor laid out by
``("batch", None)`` under `multi_pod_rules` on the three-axis mesh
holds the rows that ``P(("pod", "data"))`` gives its coordinates.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import (multi_pod_rules,
                                              single_pod_rules)
from repro_torch.models.api import build_decode_fn, init_cache_arrays
from repro_torch.models.params import flatten_names, map_tree
from repro_torch.optim.adamw import init_state
from repro_torch.train.step import build_train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5
# the first moment, leaf by leaf, against the leaf's largest element:
# the ranks reach 7.5e-6 (dense), 1.6e-5 (SSM) and 2.7e-5 (MoE) of it,
# where reordering the batch in one process moves it by 5e-7; in float64
# the ranks and the one process agree to 1.5e-13, so the gap is float32
# rounding of partial sums, and a fault moves a leaf by O(1) of it
GRAD_TOL = 1e-4

# The cases, shared by the ranks and the parent (exec'd in both).
_CASES = r"""
import dataclasses
import torch
from repro_torch.configs.base import get_config
from repro_torch.models.api import model_param_defs
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import AdamWConfig


def dense():
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               n_heads=3, n_kv_heads=1, vocab_size=500)


def moe():
    return dataclasses.replace(
        get_config("granite-moe-3b-a800m").reduced(), n_experts=3)


def ssm():
    return dataclasses.replace(get_config("mamba2-130m").reduced(),
                               vocab_size=500)


def case_inputs(cfg, rules):
    params = init_params(model_param_defs(cfg, rules),
                         torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(2)
    for blk in params["blocks"].values():  # a padded wo is zero whole
        attn = blk.get("attn", {})
        if "wo" in attn and not attn["wo"].any():
            attn["wo"] = 0.05 * torch.randn(attn["wo"].shape, generator=g)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                         dtype=torch.int32)
    return params, {"tokens": toks, "labels": toks.roll(-1, 1)}


# an eps of 1e-3 keeps the first update g / (|g| + eps) smooth where a
# gradient is rounding noise (a key bias's, which softmax cancels): at
# the default 1e-8 it is ±lr on the noise's sign
OPT = AdamWConfig(lr_peak=1e-2, warmup_steps=0, eps=1e-3)
"""

_RANK = _CASES + r"""
import json, sys
import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.sharding import (fold_pods, multi_pod_rules,
                                              named_sharding,
                                              single_pod_rules)
from repro_torch.models.api import (build_decode_fn, cache_axes,
                                    init_cache_arrays)
from repro_torch.models.params import (distribute_params, flatten_names,
                                       param_shardings, map_tree)
from repro_torch.optim.adamw import init_state
from repro_torch.train.step import build_train_step

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)


def laid(tree, axes, mesh, rules):
    if isinstance(tree, dict):
        return {k: laid(tree[k], axes[k], mesh, rules) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(laid(a, b, mesh, rules)
                            for a, b in zip(tree, axes)))
    pl = named_sharding(mesh, rules, axes).placements
    return distribute_tensor(tree, mesh, list(pl))


def run(name, cfg, mesh, rules):
    params, batch = case_inputs(cfg, rules)
    from repro_torch.models.api import model_param_defs
    dp = distribute_params(params, param_shardings(
        model_param_defs(cfg, rules), mesh, rules))
    bpl = list(named_sharding(mesh, rules, ("batch", None)).placements)
    db = {k: distribute_tensor(v, mesh, bpl) for k, v in batch.items()}
    cache = init_cache_arrays(cfg, 4, 8, "cpu", torch.float32, rules)
    cache = laid(cache, cache_axes(cfg, rules), mesh, rules)
    dec = build_decode_fn(cfg, rules)
    logits = []
    with torch.no_grad():
        for i in range(4):
            lg, cache = dec(dp, db["tokens"][:, i:i + 1], cache, i)
            logits.append(lg.full_tensor()[:, 0].numpy())
    step = build_train_step(cfg, OPT, rules=rules)
    dp, opt, metrics = step(dp, init_state(dp), db)
    res = {k: float(metrics[k].full_tensor())
           for k in ("loss", "grad_norm")}
    flat = {k: v.full_tensor().numpy() for k, v in flatten_names(dp).items()}
    mu = {k: v.full_tensor().numpy()
          for k, v in flatten_names(opt.mu).items()}
    if rank == 0:
        np.savez(f"{out}/{name}.npz", logits=np.stack(logits, 1),
                 **{"p:" + k: v for k, v in flat.items()},
                 **{"m:" + k: v for k, v in mu.items()})
    return res


results = {}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
results["dense"] = run("dense", dense(), mesh, single_pod_rules(2))
results["moe"] = run("moe", moe(), mesh, single_pod_rules(2))
results["ssm"] = run("ssm", ssm(), mesh, single_pod_rules(2))
mesh3 = init_device_mesh("cpu", (2, 1, 2),
                         mesh_dim_names=("pod", "data", "model"))
rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
pl = named_sharding(mesh3, multi_pod_rules(2), ("batch", None)).placements
local = distribute_tensor(rows, mesh3, list(pl)).to_local()
pod, data, _ = mesh3.get_coordinate()
block = pod * 1 + data  # P(("pod", "data")): pod-major over (pod, data)
results["rows"] = {"placements": [str(p) for p in pl],
                   "local": local[:, 0].tolist(),
                   "want": rows[block * 4:(block + 1) * 4, 0].tolist()}
fmesh, frules = fold_pods(mesh3, multi_pod_rules(2))
results["multipod"] = run("multipod", dense(), fmesh, frules)
results["folded"] = [list(fmesh.mesh_dim_names), list(fmesh.shape),
                     list(frules.batch), frules.fsdp]
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(results, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("rank processes failed:\n"
                             + "\n".join(log[-4000:] for log in logs))
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(WORLD)]


def _oracle(name, half=False):
    """The single-process port's loss, gradient norm, parameters and
    first moment after the step, and decode logits; ``half``: the step
    on the first half of the batch (a planted fault)."""
    ns = {}
    exec(_CASES, ns)
    cfg = ns[name if name in ("moe", "ssm") else "dense"]()
    rules = multi_pod_rules(2) if name == "multipod" \
        else single_pod_rules(2)
    params, batch = ns["case_inputs"](cfg, rules)
    cache = init_cache_arrays(cfg, 4, 8, "cpu", torch.float32, rules)
    dec = build_decode_fn(cfg, rules)
    logits = []
    with torch.no_grad():
        for i in range(4):
            lg, cache = dec(params, batch["tokens"][:, i:i + 1], cache, i)
            logits.append(lg[:, 0].numpy())
    sub = {k: v[:2] for k, v in batch.items()} if half else batch
    step = build_train_step(cfg, ns["OPT"], rules=rules)
    params, opt, metrics = step(params, init_state(params), sub)
    numpy = lambda tree: flatten_names(map_tree(  # noqa: E731
        lambda x: x.numpy(), tree))
    return ({k: float(metrics[k]) for k in ("loss", "grad_norm")},
            numpy(params), numpy(opt.mu), np.stack(logits, 1))


def _check(name, out, results, oracle) -> None:
    """Every rank's loss and gradient norm, rank 0's first moment and
    parameters after the step, and its decode logits, against the
    oracle."""
    scalars, params, mu, logits = oracle
    for r in results:  # every rank saw the same loss and norm
        for k, want in scalars.items():
            np.testing.assert_allclose(r[name][k], want, rtol=TOL,
                                       atol=TOL, err_msg=k)
    got = np.load(out / f"{name}.npz")
    for prefix, want_tree in (("m:", mu), ("p:", params)):
        assert sorted(k[2:] for k in got.files if k.startswith(prefix)) \
            == sorted(want_tree)
        for k, want in want_tree.items():
            atol = GRAD_TOL * float(np.abs(want).max()) if prefix == "m:" \
                else TOL
            np.testing.assert_allclose(got[prefix + k], want, rtol=TOL,
                                       atol=atol, err_msg=prefix + k)
    np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["dense", "moe", "ssm", "multipod"])
def test_four_ranks_match_one_process(ranks, name):
    out, results = ranks
    _check(name, out, results, _oracle(name))


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_the_comparison_fails_a_step_on_half_the_batch(ranks, name):
    out, results = ranks
    with pytest.raises(AssertionError):
        _check(name, out, results, _oracle(name, half=True))


def test_shards_hold_the_pod_major_rows(ranks):
    _, results = ranks
    for r in results:
        rows = r["rows"]
        assert rows["local"] == rows["want"]
        assert rows["placements"] == ["S(0)", "S(0)", "R"]
        assert r["folded"] == [["data", "model"], [2, 2], ["data"], "data"]
