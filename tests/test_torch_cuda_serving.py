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


def _staged_bytes(delta):
    return sum(-(-t.numel() * t.element_size() // 256) * 256
               for t in delta.tensors().values())


def test_slot_waits_count_only_stagings_that_blocked(cuda):
    """With every copy landed before its slot comes round again no
    staging blocks; with the side stream held by a sleep kernel the
    fourth staging finds the first one's slot still copying and waits
    for it, once. A repad hands the counters over with the stagers, and
    the waited ticks still match the sync service bit for bit."""
    svcs = _services([cuda], INGESTIONS, _graphs())
    db, sync = svcs[(str(cuda), "double_buffered")], \
        svcs[(str(cuda), "sync")]
    assert sync.ingest_counts() == {"staged": 0, "staged_bytes": 0,
                                    "slot_waits": 0}
    ticks = _ticks(8, seed=10)
    per_tick = _staged_bytes(ticks[0])
    for d in ticks[:4]:
        db.ingest(d)
        db.poll()
        torch.cuda.synchronize()
    assert db.ingest_counts() == {"staged": 4, "staged_bytes": 4 * per_tick,
                                  "slot_waits": 0}
    with torch.cuda.stream(db._ingestor._stagers[0].side):
        torch.cuda._sleep(100_000_000)  # holds the copies back
    for d in ticks[4:]:
        db.ingest(d)
        db.poll()
    assert db.ingest_counts() == {"staged": 8, "staged_bytes": 8 * per_tick,
                                  "slot_waits": 1}
    for d in ticks:
        sync.ingest(d)
        sync.poll()
    _assert_bits(_bits(db), _bits(sync), "after the held copies")
    db.repad(2 * N_PAD)
    assert db.ingest_counts()["staged"] == 8
    assert sync.ingest_counts()["staged"] == 0


def test_no_event_and_no_span_without_a_profiler(cuda, monkeypatch):
    """With no profiler recording, a tick creates one event (its copy's,
    in the staging) and enters no `record_function`."""
    svc = _services([cuda], ("double_buffered",), _graphs())[
        (str(cuda), "double_buffered")]
    ticks = _ticks(4, seed=11)
    svc.ingest(ticks[0])
    svc.poll()
    svc.scores()
    made, entered = [], []
    real_event = torch.cuda.Event
    real_record = torch.profiler.record_function
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: made.append(
        1) or real_event(*a, **kw))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: entered.append(a) or real_record(
                            *a, **kw))
    for d in ticks[1:]:
        svc.ingest(d)
        svc.poll()
        svc.scores()
        svc.top_anomalies()
    assert len(made) == 3 and entered == []


SPANS_SCRIPT = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile, record_function
sys.path.insert(0, sys.argv[2])
import test_torch_cuda_serving as t
cuda = torch.device("cuda")
svc = t._services([cuda], ("double_buffered",), t._graphs())[
    (str(cuda), "double_buffered")]
ticks = t._ticks(12, seed=9)
for d in ticks[:4]:
    svc.ingest(d); svc.poll(); svc.scores(); svc.top_anomalies()
torch.cuda.synchronize()
counts = [svc.ingest_counts()]
acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
with profile(activities=acts) as p:
    with record_function("test.landed"):
        for d in ticks[4:8]:
            svc.ingest(d)
            torch.cuda._sleep(20_000_000)  # the kernel starts ms later
            svc.poll(); svc.scores(); svc.top_anomalies()
            torch.cuda.synchronize()
    counts.append(svc.ingest_counts())
    with record_function("test.held"):
        with torch.cuda.stream(svc._ingestor._stagers[0].side):
            torch.cuda._sleep(100_000_000)
        for d in ticks[8:]:
            svc.ingest(d); svc.poll()
        svc.scores()
    torch.cuda.synchronize()
counts.append(svc.ingest_counts())
p.export_chrome_trace(sys.argv[1])
events = json.load(open(sys.argv[1]))["traceEvents"]
def pick(cat):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == cat)
print(json.dumps({"spans": pick("user_annotation"),
                  "kernels": pick("kernel"), "counts": counts}))
"""


@pytest.fixture(scope="module")
def traced_ticks(tmp_path_factory):
    """Four double-buffered ticks, each kernel held behind a sleep and
    each tick landed before the next, then four with the side stream
    held by a sleep, under `torch.profiler`
    in a process of its own (a second session in one process records
    no device events)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving ticks launch the "
                    "hand-written kernels, which run only on the card")
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    proc = subprocess.run(
        [sys.executable, "-c", SPANS_SCRIPT, str(path), str(tests)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _within(spans, name, window):
    return [s for s in spans if s[2] == name
            and window[0] <= s[0] and s[1] <= window[1]]


def test_a_traced_tick_has_the_stagings_launch_and_wait_spans(traced_ticks):
    spans = traced_ticks["spans"]
    (landed,) = [s for s in spans if s[2] == "test.landed"]
    for name in ("finger.ingest", "finger.ingest.pin",
                 "finger.ingest.enqueue", "finger.poll",
                 "finger.tick.launch", "finger.scores",
                 "finger.scores.wait", "finger.top_anomalies"):
        assert len(_within(spans, name, landed)) == 4, name
    for child, parent in (("finger.ingest.pin", "finger.ingest"),
                          ("finger.ingest.enqueue", "finger.ingest"),
                          ("finger.tick.launch", "finger.poll"),
                          ("finger.scores.wait", "finger.scores")):
        for c, p in zip(_within(spans, child, landed),
                        _within(spans, parent, landed)):
            assert p[0] <= c[0] <= c[1] <= p[1], (child, c, p)


# The profiler maps the card's timestamps onto the host's clock to within
# tens of µs: one run read a 10-µs kernel 20 µs before its launch span.
CLOCK_SLACK_US = 100.0


def test_spans_and_kernels_share_the_profilers_clock(traced_ticks):
    """Each tick's kernel is held about 10 ms behind a sleep kernel:
    its launch span starts before it does, and it ends before the wait
    span that `scores` holds for it ends, within the profiler's clock
    mapping."""
    spans = traced_ticks["spans"]
    (landed,) = [s for s in spans if s[2] == "test.landed"]
    kernels = [k for k in traced_ticks["kernels"]
               if "tick_kernel" in k[2] and landed[0] <= k[0] <= landed[1]]
    launches = _within(spans, "finger.tick.launch", landed)
    waits = _within(spans, "finger.scores.wait", landed)
    assert len(kernels) == len(launches) == len(waits) == 4
    for launch, kernel, wait in zip(launches, kernels, waits):
        assert launch[0] < kernel[0] + CLOCK_SLACK_US, (launch, kernel)
        assert wait[0] < kernel[1], (kernel, wait)
        assert kernel[1] <= wait[1] + CLOCK_SLACK_US, (kernel, wait)


def test_slot_wait_spans_only_where_a_copy_had_not_landed(traced_ticks):
    spans = traced_ticks["spans"]
    c0, c1, c2 = traced_ticks["counts"]
    (landed,) = [s for s in spans if s[2] == "test.landed"]
    (held,) = [s for s in spans if s[2] == "test.held"]
    assert c1["slot_waits"] == c0["slot_waits"]
    assert _within(spans, "finger.ingest.slot_wait", landed) == []
    waits = [s for s in spans if s[2] == "finger.ingest.slot_wait"]
    assert c2["slot_waits"] - c1["slot_waits"] == len(waits) == 1
    assert _within(spans, "finger.ingest.slot_wait", held) == waits
    assert c2["staged"] - c0["staged"] == 8
