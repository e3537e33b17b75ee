"""The sharded serving placements, distributed FINGER and the elastic
restore on the card.

Every test here needs a CUDA device (the shards' ticks launch the
hand-written kernels, which have no interpret mode; NCCL runs only on
the card), so on a machine without a card each skips by name. Run them
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py

The shards are logical: four of them on ``cuda:0``. A sharded tick
enqueues every shard's kernel before anything waits; the sharded and
multipod services are bit-equal to the local one on the card (each warp
ticks one stream whatever the grid), and the card's local service is
held to the CPU's (the plain versions) at atol 1e-5 with rtol 1e-5,
scores as divergences where those are below 1e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import make_grid
from repro_torch.graphs.types import EdgeList, GraphDelta
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

pytestmark = pytest.mark.cuda

B, N, K, J = 64, 48, 12, 2
N_VIRT, SLOTS, M_PAD = 1 << 16, 64, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shards' ticks launch the "
                    "hand-written kernels, which run only on the card")
    return torch.device("cuda", 0)


def _graphs(seed, sparse=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        n = int(rng.integers(N // 2, N - 4))
        lo = rng.integers(0, n, 3 * n)
        hi = (lo + 1 + rng.integers(0, n - 1, lo.size)) % n
        key = np.unique(np.minimum(lo, hi) * n + np.maximum(lo, hi))
        lo, hi = key // n, key % n
        w = rng.uniform(0.5, 1.5, lo.size)
        if sparse:
            ids = np.sort(rng.choice(N_VIRT, n, replace=False))
            mask = np.zeros(N_VIRT, np.float32)
            mask[ids] = 1.0
            out.append(EdgeList.from_arrays(
                ids[lo], ids[hi], w, n_nodes=N_VIRT,
                node_mask=torch.from_numpy(mask)))
        else:
            out.append(EdgeList.from_arrays(lo, hi, w, n_nodes=n))
    return out


def _ticks(graphs, count, seed, sparse=False):
    """Per-stream deltas: re-weights and additions among each stream's
    nodes (w_old 0 on an absent pair; the tick gates what is absent)."""
    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(count):
        tick = []
        for g in graphs:
            live = np.flatnonzero(g.node_mask.numpy()) if sparse \
                else np.arange(g.n_nodes)
            i, j = rng.choice(live, K), rng.choice(live, K)
            pairs = np.unique(np.stack([np.minimum(i, j),
                                        np.maximum(i, j)], 1), axis=0)
            i, j = pairs[pairs[:, 0] != pairs[:, 1]].T
            tick.append(GraphDelta.from_arrays(
                i, j, rng.uniform(0.1, 0.5, i.size), np.zeros(i.size),
                n_nodes=N_VIRT if sparse else N, k_pad=K, j_pad=J))
        ticks.append(tick)
    return ticks


def _bits(svc):
    torch.cuda.synchronize()
    st = svc.plan.gather(svc.states())
    out = {k: v.numpy() for k, v in st.tensors().items()}
    out["scores"] = svc.scores()
    return out


def _services(cuda, method, ingestion, graphs_fn):
    cfg = ServiceConfig(batch_size=B, n_pad=N_VIRT if method ==
                        "sparse_tick" else N, k_pad=K, j_pad=J,
                        method=method, exact_smax=True,
                        n_slots=SLOTS if method == "sparse_tick" else None,
                        m_pad=M_PAD if method == "sparse_tick" else None,
                        ingestion=ingestion, topk=TopKSpec(k=4))
    return {
        "cpu": FingerService.open(cfg, graphs_fn(), device="cpu"),
        "local": FingerService.open(cfg, graphs_fn(), device=cuda),
        "sharded": FingerService.open(
            cfg.with_(placement="sharded"), graphs_fn(),
            grid=make_grid((4,), ("data",), cuda)),
        "multipod": FingerService.open(
            cfg.with_(placement="multipod"), graphs_fn(),
            grid=make_grid((2, 2), ("pod", "data"), cuda)),
    }


@pytest.mark.parametrize("ingestion", ["sync", "double_buffered"])
@pytest.mark.parametrize("method", ["fused_tick", "sparse_tick"])
def test_placements_bit_equal_to_local_on_the_card(cuda, method,
                                                   ingestion):
    sparse = method == "sparse_tick"
    graphs = _graphs(1, sparse)
    svcs = _services(cuda, method, ingestion, lambda: iter(graphs))
    ops, name = (sp_ops, "sparse_tick") if sparse else (st_ops,
                                                        "stream_tick")
    for t, tick in enumerate(_ticks(graphs, 4, seed=2, sparse=sparse)):
        for label, svc in svcs.items():
            n0 = ops.LAUNCHES[name]
            svc.ingest(tick)
            svc.poll()
            want = {"cpu": 0, "local": 1}.get(label, 4)
            assert ops.LAUNCHES[name] - n0 == want, (label, t)
        want = _bits(svcs["local"])
        for label in ("sharded", "multipod"):
            got = _bits(svcs[label])
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, f"{label} {k}")
            for per_pod in (False, True) if label == "multipod" else (False,):
                v, ids = svcs[label].top_anomalies(4, per_pod=per_pod)
                if not per_pod:
                    lv, lids = svcs["local"].top_anomalies(4)
                    np.testing.assert_array_equal(ids, lids)
                    np.testing.assert_array_equal(v, lv)
        cpu = _bits(svcs["cpu"])
        np.testing.assert_allclose(want["scores"] ** 2, cpu["scores"] ** 2,
                                   atol=1e-5, rtol=1e-5)
        for k in ("q", "s_total", "s_max", "strengths"):
            np.testing.assert_allclose(want[k], cpu[k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_sharded_tick_enqueues_every_shard_before_it_waits(cuda):
    """With the compute stream held by a sleep kernel, `poll` returns
    with all four shards' kernels launched and none run; and it makes
    no host synchronization (`set_sync_debug_mode("error")`)."""
    graphs = _graphs(3)
    svc = _services(cuda, "fused_tick", "double_buffered",
                    lambda: iter(graphs))["sharded"]
    tick = _ticks(graphs, 1, seed=4)[0]
    svc.ingest(tick)
    torch.cuda.synchronize()
    n0 = st_ops.LAUNCHES["stream_tick"]
    torch.cuda._sleep(200_000_000)  # holds the compute stream back
    torch.cuda.set_sync_debug_mode("error")
    try:
        report = svc.poll()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert st_ops.LAUNCHES["stream_tick"] - n0 == 4
    assert not torch.cuda.current_stream(cuda).query()
    assert report.scores.num_shards == 4
    torch.cuda.synchronize()
    assert np.isfinite(svc.scores()).all()


def test_distributed_finger_nccl_world_one(cuda):
    """`distributed_finger_state` / `distributed_power_iteration` under
    NCCL at world size 1 (NCCL refuses two ranks on one card) against the
    serial functions on the card."""
    import torch.distributed as dist

    from repro_torch.core.state import finger_state
    from repro_torch.distributed import (distributed_finger_state,
                                         distributed_power_iteration,
                                         shard_edge_list)
    from repro_torch.graphs.spectral import power_iteration_lmax

    g = _graphs(5)[0].to(cuda)
    serial = finger_state(g)
    lam = power_iteration_lmax(g, num_iters=200, tol=1e-9)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        shard = shard_edge_list(g, 0, 1)
        st = distributed_finger_state(shard)
        got = distributed_power_iteration(shard, num_iters=200, tol=1e-9)
    finally:
        dist.destroy_process_group()
    assert abs(float(st.q) - float(serial.q)) < 1e-5
    assert abs(float(st.s_max) - float(serial.s_max)) < 1e-4
    assert abs(float(st.s_total) - float(serial.s_total)) \
        < 1e-6 * float(serial.s_total)
    assert abs(float(got) - float(lam)) < 1e-4 * float(lam)


def test_elastic_restore_from_a_cpu_template_onto_the_card(cuda, tmp_path):
    from repro_torch.models.params import flatten_names
    from repro_torch.optim.adamw import init_state
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.fault_tolerance import elastic_restore

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen),
              "b": torch.randn(32, generator=gen)}
    tree = {"params": params, "opt": init_state(params)}
    path = save_checkpoint(str(tmp_path), 2, tree)
    back, manifest = elastic_restore(path, tree, cuda)
    assert manifest["step"] == 2
    for k, v in flatten_names(back).items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu(), flatten_names(tree)[k]), k
