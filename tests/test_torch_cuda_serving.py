"""The port's serving lifecycle on the card: double-buffered ingestion,
migrations with ticks queued on the device, and warm plans.

Every test here needs a CUDA device (the ticks launch the hand-written
`stream_tick` / `sparse_tick` kernels, which have no interpret mode),
so on a machine without a card each skips by name. Run them on the card
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_serving.py

Within the port, double-buffered and synchronous ingestion must agree
bit for bit (the same kernel on the same inputs); the migration chain on
the card is held to the same chain on the CPU (the plain versions) at
atol 1e-5 with rtol 1e-5, scores as divergences where those are below
1e-3 (`stream_tick.parity`'s rule), masks exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitize import no_transfers
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.types import EdgeList, GraphDelta
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.serving import (FingerService, LayoutMigrationError,
                                 ServiceConfig, TopKSpec)

pytestmark = pytest.mark.cuda

B, N, N_PAD, K, J = 512, 200, 256, 64, 4
INGESTIONS = ("sync", "double_buffered")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving ticks launch the "
                    "hand-written kernels, which run only on the card")
    return torch.device("cuda")


def _graphs(b=B, n=N):
    return [erdos_renyi(n, 0.05, seed=s, weighted=True) for s in range(b)]


def _services(devices, ingestions, graphs, **kw):
    """One fused_tick service per (device, ingestion), same graphs."""
    out = {}
    for dev in devices:
        for mode in ingestions:
            cfg = ServiceConfig(batch_size=len(graphs), n_pad=N_PAD,
                                k_pad=K, j_pad=J, method="fused_tick",
                                exact_smax=True, ingestion=mode,
                                topk=TopKSpec(k=4), **kw)
            out[(str(dev), mode)] = FingerService.open(cfg, graphs,
                                                       device=dev)
    return out


def _ticks(count, seed, n=N, n_pad=N_PAD, b=B):
    """Stacked host deltas: weight added on random lanes among the live
    nodes, and joins of node n or n+1 in a tenth of the streams."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(count):
        lo = rng.integers(0, n - 1, (b, K))
        hi = lo + rng.integers(1, n - lo)
        nid = np.zeros((b, J), np.int32)
        flag = np.zeros((b, J), np.float32)
        join = rng.random(b) < 0.1
        nid[join, 0] = n + t % 2
        flag[join, 0] = 1.0
        f = torch.from_numpy
        out.append(GraphDelta(
            senders=f(lo.astype(np.int32)), receivers=f(hi.astype(np.int32)),
            dw=f(rng.uniform(0.1, 0.5, (b, K)).astype(np.float32)),
            w_old=torch.zeros((b, K)),
            mask=f((rng.random((b, K)) < 0.8).astype(np.float32)),
            n_nodes=n_pad, node_ids=f(nid), node_flag=f(flag)))
    return out


def _bits(svc):
    torch.cuda.synchronize()
    out = {k: v.cpu().numpy().copy()
           for k, v in svc.states().tensors().items()}
    out["scores"] = svc.scores()
    return out


def _assert_bits(a, b, label):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], f"{label}: {k}")


def _assert_close(got, want, label):
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if k == "node_mask":
            np.testing.assert_array_equal(g, w, f"{label}: {k}")
        elif k == "scores":
            np.testing.assert_allclose(g ** 2, w ** 2, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{label}: divergences")
            big = w ** 2 > 1e-3
            np.testing.assert_allclose(g[big], w[big], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{label}: scores")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{label}: {k}")


def test_double_buffered_matches_sync_one_launch_a_tick(cuda):
    svcs = _services([cuda], INGESTIONS, _graphs())
    ticks = _ticks(6, seed=1)
    for t, d in enumerate(ticks):
        got = {}
        for (_, mode), svc in svcs.items():
            before = st_ops.LAUNCHES["stream_tick"]
            svc.ingest(d)
            svc.poll()
            assert st_ops.LAUNCHES["stream_tick"] == before + 1
            got[mode] = _bits(svc)
        _assert_bits(got["sync"], got["double_buffered"], f"tick {t}")


def test_ingest_of_the_next_tick_while_a_tick_runs(cuda):
    """Ticks T+1 and T+2 are ingested (their copies started) before
    tick T's kernel has been waited on; the results are bit-equal with
    the sync service."""
    svcs = _services([cuda], INGESTIONS, _graphs())
    db, sync = svcs[(str(cuda), "double_buffered")], \
        svcs[(str(cuda), "sync")]
    ticks = _ticks(7, seed=2)
    for d in ticks:
        sync.ingest(d)
        sync.poll()
    want = _bits(sync)
    db.ingest(ticks[0])
    for t in range(len(ticks)):
        db.poll()                       # tick t launched, not waited on
        if t + 1 < len(ticks):
            db.ingest(ticks[t + 1])     # its successor's copy starts now
    _assert_bits(_bits(db), want, "overlapped ingestion")


def test_allocator_keeps_a_delta_buffer_until_the_tick_read_it(cuda):
    """The compute stream is held back by a sleep kernel, so tick T's
    kernel has not read its delta when `poll` returns and the delta's
    buffer is freed; the next `ingest` allocates on the side stream
    and copies at once. Without `record_stream` the allocator would hand
    it tick T's block, and the copy would overwrite T's delta before
    the kernel read it."""
    svcs = _services([cuda], INGESTIONS, _graphs())
    db, sync = svcs[(str(cuda), "double_buffered")], \
        svcs[(str(cuda), "sync")]
    ticks = _ticks(4, seed=3)
    want = []
    for d in ticks:
        sync.ingest(d)
        sync.poll()
        want.append(_bits(sync))
    db.ingest(ticks[0])
    db.poll()
    torch.cuda.synchronize()
    db.ingest(ticks[1])
    torch.cuda._sleep(100_000_000)  # holds the compute stream back
    db.poll()                       # tick 1 queued behind the sleep
    db.ingest(ticks[2])             # allocates and copies at once
    _assert_bits(_bits(db), want[1], "tick 1")
    db.poll()
    _assert_bits(_bits(db), want[2], "tick 2")


def test_pinned_slots_reused_while_the_caller_overwrites_its_arrays(cuda):
    """max_queue = 2 gives a ring of 3 pinned slots; 9 ticks reuse each
    slot 3 times, and the caller overwrites its one set of host tensors
    with garbage right after every `ingest`."""
    graphs = _graphs()
    svcs = _services([cuda], INGESTIONS, graphs, max_queue=2)
    db, sync = svcs[(str(cuda), "double_buffered")], \
        svcs[(str(cuda), "sync")]
    ticks = _ticks(9, seed=4)
    buf = ticks[0].map_tensors(torch.clone)
    ring = db._ingestor._stagers[0]._slots
    assert len(ring) == 3
    ptrs = []
    for t, d in enumerate(ticks):
        sync.ingest(d)
        sync.poll()
        for name, x in buf.tensors().items():
            x.copy_(getattr(d, name))
        db.ingest(buf)
        for x in buf.tensors().values():
            x.fill_(7 if x.dtype == torch.int32 else float("nan"))
        ptrs.append(ring[t % 3][1].data_ptr())
        db.poll()
        _assert_bits(_bits(db), _bits(sync), f"tick {t}")
    assert ptrs[:3] == ptrs[3:6] == ptrs[6:9] and len(set(ptrs)) == 3


def test_no_device_sync_in_ingest_and_poll(cuda):
    svc = _services([cuda], ("double_buffered",), _graphs())[
        (str(cuda), "double_buffered")]
    ticks = _ticks(8, seed=5)
    for d in ticks[:4]:  # every pinned slot and plan first used
        svc.ingest(d)
        svc.poll()
    torch.cuda.synchronize()
    before = st_ops.LAUNCHES["stream_tick"]
    with no_transfers(cuda, "ingest + poll"):
        for d in ticks[4:]:
            svc.ingest(d)
            svc.poll()
    assert st_ops.LAUNCHES["stream_tick"] == before + 4
    assert np.isfinite(svc.scores()).all()


def test_migration_chain_with_ticks_queued_on_the_card(cuda):
    """repad with a tick queued (on the device under double buffering),
    a tick, a compaction with a tick queued, a refused compaction whose
    queued join addresses a dropped slot, and a generation-0-stamped
    delta: the card's services agree with each other bit for bit and
    with the CPU's."""
    graphs = _graphs(b=256)
    cpu = torch.device("cpu")
    svcs = _services([cuda, cpu], INGESTIONS, graphs)
    ticks = _ticks(5, seed=6, b=256)
    gen0 = next(iter(svcs.values())).layout
    for svc in svcs.values():
        svc.ingest(ticks[0])
        svc.poll()
        svc.ingest(ticks[1])
        svc.repad(2 * N_PAD)
        assert svc.pending == 1
        svc.poll()
        svc.ingest(dataclasses.replace(ticks[2], n_nodes=2 * N_PAD))
        report = svc.compact(new_n_pad=N + 4)
        assert report.reclaimed == 2 * N_PAD - (N + 4) and svc.pending == 1
        svc.poll()
        join = ticks[3].map_tensors(torch.clone)
        join.node_ids[:, 1] = N + 10  # beyond the compacted layout's end
        join.node_flag[:, 1] = 1.0
        svc.repad(N + 16)
        svc.ingest(dataclasses.replace(join, n_nodes=N + 16))
        before = {k: v.cpu().clone() for k, v in
                  svc.states().tensors().items()}
        with pytest.raises(LayoutMigrationError, match="dropped"):
            svc.compact()
        for k, v in svc.states().tensors().items():
            assert torch.equal(v.cpu(), before[k]), k
        assert svc.pending == 1 and svc.layout.generation == 3
        svc.poll()
        svc.ingest(dataclasses.replace(ticks[4],
                                       layout_generation=gen0.generation))
        svc.poll()
    out = {key: _bits(svc) for key, svc in svcs.items()}
    _assert_bits(out[(str(cuda), "sync")],
                 out[(str(cuda), "double_buffered")], "card")
    _assert_close(out[(str(cuda), "double_buffered")],
                  out[("cpu", "sync")], "card against CPU")


def test_warm_plans_in_the_background_on_their_own_stream(cuda):
    svc = _services([cuda], ("double_buffered",), _graphs())[
        (str(cuda), "double_buffered")]
    ticks = _ticks(3, seed=7)
    svc.ingest(ticks[0])
    svc.poll()
    handle = svc.warm_next_layouts([2 * N_PAD], background=True)
    svc.ingest(ticks[1])
    svc.poll()  # serving goes on while the warm runs
    assert handle.wait(timeout=120) == [2 * N_PAD]
    warm = {id(p) for p, _ in svc.plan_cache._plans.values()}
    svc.repad(2 * N_PAD)
    assert id(svc.plan) in warm
    svc.ingest(dataclasses.replace(ticks[2], n_nodes=2 * N_PAD))
    svc.poll()
    assert np.isfinite(svc.scores()).all()


def _virtual_streams(b, n_virtual, seed):
    """B sparse streams of 48 live virtual ids (of 64 drawn), their
    initial edge lists and a per-tick delta maker."""
    rng = np.random.default_rng(seed)
    vid = np.stack([rng.choice(n_virtual, 64, replace=False)
                    for _ in range(b)])
    graphs = []
    for s in range(b):
        lo = rng.integers(0, 47, 96)
        hi = lo + rng.integers(1, 48 - lo)
        key = np.unique(lo * 64 + hi)
        mask = torch.zeros(n_virtual)
        mask[torch.from_numpy(vid[s, :48])] = 1.0
        graphs.append(EdgeList.from_arrays(
            vid[s, key // 64], vid[s, key % 64],
            rng.uniform(0.5, 1.5, len(key)).astype(np.float32),
            n_nodes=n_virtual, node_mask=mask))

    def tick(k):
        out = []
        for s in range(b):
            lo = rng.integers(0, 47, k)
            hi = lo + rng.integers(1, 48 - lo)
            key = np.unique(lo * 64 + hi)
            n = len(key)
            out.append(GraphDelta.from_arrays(
                vid[s, key // 64], vid[s, key % 64],
                rng.uniform(0.1, 0.5, n).astype(np.float32),
                np.zeros(n, np.float32), n_nodes=n_virtual, k_pad=k,
                j_pad=2))
        return out

    return graphs, tick


def test_sparse_double_buffered_grows_with_a_tick_queued(cuda):
    """The sparse service's double-buffered and sync ingestion agree bit
    for bit through a `grow_capacity` with a tick queued on the device,
    with one `sparse_tick` launch a tick."""
    b, nv = 256, 1 << 16
    out = {}
    for mode in INGESTIONS:
        graphs, tick = _virtual_streams(b, nv, seed=8)
        cfg = ServiceConfig(batch_size=b, n_pad=nv, k_pad=16, j_pad=2,
                            method="sparse_tick", n_slots=64, m_pad=512,
                            exact_smax=True, ingestion=mode,
                            topk=TopKSpec(k=4))
        svc = FingerService.open(cfg, graphs, device=cuda)
        before = sp_ops.LAUNCHES["sparse_tick"]
        for t in range(5):
            svc.ingest(tick(16))
            if t == 2:
                svc.grow_capacity(n_slots=96, m_pad=640)
                assert svc.pending == 1
            svc.poll()
        assert sp_ops.LAUNCHES["sparse_tick"] == before + 5
        out[mode] = (_bits(svc), [m.to_json() for m in svc.slot_maps])
    _assert_bits(out["sync"][0], out["double_buffered"][0], "sparse")
    assert out["sync"][1] == out["double_buffered"][1]
