"""The port's distributed FINGER, gradient compression and elastic
restore against the JAX reference, on the CPU.

Distributed FINGER runs one process a rank over `torch.distributed`
with the gloo backend: one module-scoped subprocess starts 2 and then
4 rank processes on the reference's ER(200, 0.05, seed 3) graph, each
holding its `shard_edge_list` shard. The oracle is the reference's
*serial* `finger_state` and `power_iteration_lmax` (its own distributed
test, `tests/test_distributed.py`, is red on the CPU: ROADMAP Queue 3)
and the port's serial functions beside them; the power iteration
starts every rank from the reference's threefry vector through
``x0=``. Tolerances
are the reference test's (`tests/test_distributed.py`): q within 1e-5,
s_max within 1e-4, s_total within 1e-6 relative, λ within 1e-3
relative. The ranks must agree bit for bit.

A node-masked copy of the graph (20 nodes masked off, and 8 extra
lanes whose endpoints lie outside ``[0, n)``: ids n, n + 50 and -1)
goes through the same ranks. Its oracle is the port's serial
`finger_state` and `power_iteration_lmax` on the whole masked edge
list, at the tolerances above: the port gates by the node mask and
drops out-of-range ids in every path, while the reference's
distributed functions drop the mask (ROADMAP Queue 3), so they are no
oracle here.

Compression is held to the JAX functions at 1e-6 with the
error-feedback invariant (dequantized + new residual == gradient + old
residual); three compressed train steps to the JAX compressed step at
the tolerance of `tests/test_torch_train.py`'s steps (rtol 1e-4 on
loss and gradient norm).
"""
import dataclasses
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

from repro.core.state import finger_state as jax_finger_state
from repro.distributed import compression as jcomp
from repro.distributed.sharding import NO_SHARDING
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro.graphs.spectral import power_iteration_lmax as jax_lmax
from repro.graphs.types import EdgeList as JEdgeList
from repro.optim import adamw as jax_adamw
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch import interop
from repro_torch.core.state import finger_state
from repro_torch.distributed import (compress_with_feedback,
                                     dequantize_int8, init_residuals,
                                     quantize_int8, shard_edge_list)
from repro_torch.graphs.spectral import power_iteration_lmax
from repro_torch.graphs.types import DenseGraph, EdgeList
from repro_torch.models.params import flatten_names
from repro_torch.optim import adamw as pt_adamw
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.fault_tolerance import elastic_restore, maybe_resume
from repro_torch.train.step import build_train_step as pt_build_train_step
from test_torch_train import batch_np, close, jax_model, t

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)

# One rank: the graph and start vector from the parent's files, this
# rank's shard, both distributed functions; its results to a JSON file.
_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import (distributed_finger_state,
                                     distributed_power_iteration,
                                     shard_edge_list)
from repro_torch.graphs.types import EdgeList

root, world, rank, port = sys.argv[1], *map(int, sys.argv[2:5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
g = np.load(f"{root}/graph.npz")
el = EdgeList(senders=torch.from_numpy(g["senders"]),
              receivers=torch.from_numpy(g["receivers"]),
              weights=torch.from_numpy(g["weights"]),
              mask=torch.from_numpy(g["mask"]), n_nodes=int(g["n"]))
shard = shard_edge_list(el, rank, world)
st = distributed_finger_state(shard)
info = {}
lam = distributed_power_iteration(shard, num_iters=200, tol=1e-9,
                                  x0=g["x0"], info=info)
mg = np.load(f"{root}/masked.npz")
masked = EdgeList(senders=torch.from_numpy(mg["senders"]),
                  receivers=torch.from_numpy(mg["receivers"]),
                  weights=torch.from_numpy(mg["weights"]),
                  mask=torch.from_numpy(mg["mask"]), n_nodes=int(mg["n"]),
                  node_mask=torch.from_numpy(mg["node_mask"]))
m_shard = shard_edge_list(masked, rank, world)
m_st = distributed_finger_state(m_shard)
m_lam = distributed_power_iteration(m_shard, num_iters=200, tol=1e-9,
                                    x0=mg["x0"])
dist.destroy_process_group()
out = {"q": st.q.item(), "s_total": st.s_total.item(),
       "s_max": st.s_max.item(), "strengths": st.strengths.tolist(),
       "lam": lam.item(), "iterations": info["iterations"],
       "shard_edges": int(shard.weights.numel()),
       "masked": {"q": m_st.q.item(), "s_total": m_st.s_total.item(),
                  "s_max": m_st.s_max.item(),
                  "strengths": m_st.strengths.tolist(),
                  "lam": m_lam.item()}}
with open(f"{root}/rank_{world}_{rank}.json", "w") as f:
    json.dump(out, f)
"""

# The module's one subprocess: each world's ranks, started together.
_LAUNCHER = r"""
import json, socket, subprocess, sys
root, rank_src, worlds = sys.argv[1], sys.argv[2], sys.argv[3:]
for world in map(int, worlds):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", rank_src, root,
                               str(world), str(r), str(port)])
             for r in range(world)]
    codes = [p.wait(timeout=300) for p in procs]
    if any(codes):
        sys.exit(f"world {world}: rank exit codes {codes}")
print("done")
"""


@pytest.fixture(scope="module")
def graph():
    g = jax_erdos_renyi(200, 0.05, seed=3, weighted=True)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (200,),
                                      jnp.float32))
    return g, JEdgeList.from_dense(g), x0


@pytest.fixture(scope="module")
def masked(graph):
    """The graph as a port edge list with 20 nodes masked off and 8
    lanes addressing ids outside [0, n) (7 valid, 1 padding)."""
    g, _, x0 = graph
    n = g.n_nodes
    el = EdgeList.from_dense(DenseGraph.from_weights(np.array(g.weights)))
    node_mask = np.ones(n, np.float32)
    node_mask[np.random.default_rng(5).choice(n, 20, replace=False)] = 0.0
    bad_s = np.array([n, 3, n + 50, -1, 7, n, 11, n], np.int32)
    bad_r = np.array([4, n, 9, 12, -1, n + 1, n + 50, 2], np.int32)
    return EdgeList(
        senders=torch.cat([el.senders, torch.from_numpy(bad_s)]),
        receivers=torch.cat([el.receivers, torch.from_numpy(bad_r)]),
        weights=torch.cat([el.weights, torch.full((8,), 2.5)]),
        mask=torch.cat([el.mask, torch.tensor([1.0] * 7 + [0.0])]),
        n_nodes=n, node_mask=torch.from_numpy(node_mask)), x0


@pytest.fixture(scope="module")
def ranks(graph, masked, tmp_path_factory):
    _, el, x0 = graph
    root = tmp_path_factory.mktemp("dist")
    np.savez(root / "graph.npz", senders=np.asarray(el.senders),
             receivers=np.asarray(el.receivers),
             weights=np.asarray(el.weights), mask=np.asarray(el.mask),
             n=el.n_nodes, x0=x0)
    mel, _ = masked
    np.savez(root / "masked.npz", senders=mel.senders.numpy(),
             receivers=mel.receivers.numpy(), weights=mel.weights.numpy(),
             mask=mel.mask.numpy(), node_mask=mel.node_mask.numpy(),
             n=mel.n_nodes, x0=x0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCHER, str(root), _RANK,
         *map(str, WORLDS)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {w: [json.loads((root / f"rank_{w}_{r}.json").read_text())
                for r in range(w)] for w in WORLDS}


@pytest.fixture(scope="module")
def serial(graph):
    g, _, x0 = graph
    st = jax_finger_state(g)
    tg = DenseGraph.from_weights(np.array(g.weights))
    return {"jax": st, "lam": float(jax_lmax(g, num_iters=200, tol=1e-9)),
            "port": finger_state(tg),
            "port_lam": float(power_iteration_lmax(tg, num_iters=200,
                                                   tol=1e-9, x0=x0))}


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_and_split_the_edges(ranks, graph, world):
    _, el, _ = graph
    outs = ranks[world]
    assert len(outs) == world
    for r in outs[1:]:
        assert r == dict(outs[0], shard_edges=r["shard_edges"])
    assert sum(r["shard_edges"] for r in outs) == \
        -(-el.weights.shape[0] // world) * world


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_q_matches_serial(ranks, serial, world):
    q = ranks[world][0]["q"]
    assert abs(q - float(serial["jax"].q)) < 1e-5
    assert abs(q - float(serial["port"].q)) < 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_smax_stot_match(ranks, serial, world):
    r = ranks[world][0]
    for st in (serial["jax"], serial["port"]):
        assert abs(r["s_max"] - float(st.s_max)) < 1e-4
        stot = float(st.s_total)
        assert abs(r["s_total"] - stot) / stot < 1e-6
        np.testing.assert_allclose(r["strengths"], np.asarray(st.strengths),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_power_iteration_matches(ranks, serial, world):
    lam = ranks[world][0]["lam"]
    for want in (serial["lam"], serial["port_lam"]):
        assert abs(lam - want) / want < 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_masked_graph_matches_the_serial_port(ranks, masked,
                                                          world):
    mel, x0 = masked
    r = ranks[world][0]["masked"]
    for other in ranks[world][1:]:
        assert other["masked"] == r
    st = finger_state(mel)
    assert abs(r["q"] - float(st.q)) < 1e-5
    assert abs(r["s_max"] - float(st.s_max)) < 1e-4
    assert abs(r["s_total"] - float(st.s_total)) / float(st.s_total) < 1e-6
    np.testing.assert_allclose(r["strengths"], st.strengths.numpy(),
                               atol=1e-5, rtol=1e-5)
    # masked nodes carry nothing; the out-of-range lanes added nothing
    assert not np.asarray(r["strengths"])[mel.node_mask.numpy() == 0].any()
    assert float(st.s_total) < float(finger_state(dataclasses.replace(
        mel, node_mask=None)).s_total)  # the mask took weight off
    lam = float(power_iteration_lmax(mel, num_iters=200, tol=1e-9, x0=x0))
    assert abs(r["lam"] - lam) / lam < 1e-3


@pytest.mark.parametrize("world", [1, 3, 4, 7])
def test_shard_edge_list_pads_to_the_world(world):
    m = 10
    mask = torch.zeros(12)
    mask[:m] = 1.0
    g = EdgeList(senders=torch.arange(12, dtype=torch.int32),
                 receivers=torch.arange(12, dtype=torch.int32) + 1,
                 weights=torch.arange(12, dtype=torch.float32) + 1,
                 mask=mask, n_nodes=14, node_mask=torch.ones(14))
    shards = [shard_edge_list(g, r, world) for r in range(world)]
    per = -(-12 // world)
    assert all(s.weights.numel() == per for s in shards)
    assert all(s.node_mask is g.node_mask and s.n_nodes == 14
               for s in shards)
    joined = torch.cat([s.weights for s in shards])
    torch.testing.assert_close(joined[:12], g.weights)
    assert not joined[12:].any()
    assert torch.cat([s.mask for s in shards]).sum() == m
    with pytest.raises(ValueError, match="outside a world"):
        shard_edge_list(g, world, world)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(0, 1, (16, 8)).astype(np.float32)},
            "b": rng.normal(0, 3, (33,)).astype(np.float32),
            "zero": np.zeros((4,), np.float32)}


def test_quantize_int8_matches_jax():
    for name, x in flatten_names(_grads(0)).items():
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq), name)
        close(ts, js, atol=1e-6, rtol=1e-6, label=name)
        close(dequantize_int8(tq, ts), jcomp.dequantize_int8(jq, js),
              atol=1e-6, rtol=1e-6, label=name)


def test_compress_with_feedback_matches_jax_and_keeps_the_invariant():
    grads = _grads(1)
    j_res = jcomp.init_residuals(jax.tree_util.tree_map(jnp.asarray, grads))
    t_res = init_residuals(interop.params_from_numpy(grads, "cpu"))
    for step in range(3):
        g = _grads(2 + step)
        jg, j_res_new = jcomp.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), j_res)
        tg = interop.params_from_numpy(g, "cpu")
        out, t_res_new = compress_with_feedback(tg, t_res)
        want_g = flatten_names(jax.tree_util.tree_map(np.asarray, jg))
        want_r = flatten_names(jax.tree_util.tree_map(np.asarray, j_res_new))
        old_r, flat_g = flatten_names(t_res), flatten_names(tg)
        for k, v in flatten_names(out).items():
            r = flatten_names(t_res_new)[k]
            close(v, want_g[k], atol=1e-6, rtol=1e-6, label=f"{step} {k}")
            close(r, want_r[k], atol=1e-6, rtol=1e-6, label=f"{step} {k}")
            torch.testing.assert_close(v + r, flat_g[k] + old_r[k],
                                       atol=1e-6, rtol=1e-6)
        j_res, t_res = j_res_new, t_res_new


def test_compressed_train_steps_match_the_jax_compressed_step():
    cfg, params, pcfg = jax_model("granite-moe-3b-a800m")
    opt_cfg = jax_adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                    total_steps=3)
    j_step = jax.jit(jax_build_train_step(cfg, NO_SHARDING, opt_cfg,
                                          compress_grads=True))
    p_step = pt_build_train_step(
        pcfg, pt_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg)),
        compress_grads=True)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = jax_adamw.init_state(j_params)
    j_res = jcomp.init_residuals(j_params)
    p_params = interop.params_from_numpy(params, "cpu")
    p_state = pt_adamw.init_state(p_params)
    p_res = init_residuals(p_params)
    for step in range(3):
        b = batch_np(20 + step, 2, 32)
        j_params, j_state, j_res, jm = j_step(
            j_params, j_state, j_res, {k: jnp.asarray(v) for k, v in b.items()})
        p_params, p_state, p_res, pm = p_step(
            p_params, p_state, p_res, {k: t(v) for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            close(pm[key], jm[key], atol=0.0, rtol=1e-4,
                  label=f"step {step} {key}")
    assert int(p_state.step) == 3
    assert set(flatten_names(p_res)) == set(flatten_names(p_params))


def test_launcher_trains_with_compression():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import run

    cfg = get_config("granite-moe-3b-a800m").reduced()
    kw = dict(steps=3, batch_size=2, seq=16, probe_every=0,
              log=lambda *a: None, device="cpu")
    _, state, hist = run(cfg, compress=True, **kw)
    _, _, plain = run(cfg, **kw)
    assert int(state.step) == 3
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    # the same first batch and init: compression leaves step 0's loss
    assert hist[0]["loss"] == plain[0]["loss"]
    assert hist[-1]["loss"] != plain[-1]["loss"]


def _tree():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen),
              "blk": {"b": torch.randn(5, generator=gen)}}
    return {"params": params, "opt": pt_adamw.init_state(params)}


def test_elastic_restore_places_leaves_where_asked(tmp_path):
    """A CPU template; one device, or a tree of devices."""
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree)
    template = {"params": {k: v for k, v in tree["params"].items()},
                "opt": tree["opt"]}
    back, manifest = elastic_restore(path, template, "cpu")
    assert manifest["step"] == 7
    want = flatten_names(tree)
    got = flatten_names(back)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]) and got[k].device.type == "cpu"
    # a tree of devices, a single device standing for a whole subtree
    devices = {"params": "cpu",
               "opt": pt_adamw.AdamWState(step="cpu", mu="cpu", nu="cpu")}
    back2, _ = elastic_restore(path, template, devices)
    assert all(torch.equal(v, want[k])
               for k, v in flatten_names(back2).items())
    assert isinstance(back2["opt"], pt_adamw.AdamWState)


def test_elastic_restore_onto_a_missing_card_raises(tmp_path, monkeypatch):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        elastic_restore(path, tree, "cuda")


def test_maybe_resume_with_devices(tmp_path):
    tree = _tree()
    assert maybe_resume(str(tmp_path), tree, devices="cpu") == (None, 0)
    save_checkpoint(str(tmp_path), 3, tree)
    back, step = maybe_resume(str(tmp_path), tree, devices="cpu")
    assert step == 3
    assert all(torch.equal(v, flatten_names(tree)[k])
               for k, v in flatten_names(back).items())
