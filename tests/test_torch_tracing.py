"""The serving path's spans (`repro_torch.tracing`) and the ingestor's
counters, on the CPU.

A span is the profiler's `record_function` while a `torch.profiler`
records and one shared null context otherwise. Under the profiler, a
tick's `ingest`, `poll`, `scores` and `top_anomalies` each leave their
``finger.*`` span in the exported Chrome trace, inside the caller's own
span around the call; with no profiler the path enters no
`record_function` at all, and the profiler changes no bit of the scores
or the state. The card's spans (the staging's, the launch's, the wait's)
are held in `test_torch_cuda_serving.py`.
"""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

B, N, N_PAD, K, J = 8, 24, 32, 8, 2
CALLS = ("ingest", "poll", "scores", "top_anomalies")


def _service(ingestion="double_buffered", method="fused_tick"):
    graphs = [erdos_renyi(N, 0.2, seed=s, weighted=True) for s in range(B)]
    cfg = ServiceConfig(batch_size=B, n_pad=N_PAD, k_pad=K, j_pad=J,
                        method=method, exact_smax=True, ingestion=ingestion,
                        topk=TopKSpec(k=2))
    return FingerService.open(cfg, graphs, device="cpu")


def _ticks(count, seed=3):
    """Stacked host deltas: weight added on random pairs of live nodes
    and a join of node N in a quarter of the streams."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lo = rng.integers(0, N - 1, (B, K))
        hi = lo + rng.integers(1, N - lo)
        nid = np.zeros((B, J), np.int32)
        flag = np.zeros((B, J), np.float32)
        join = rng.random(B) < 0.25
        nid[join, 0] = N
        flag[join, 0] = 1.0
        f = torch.from_numpy
        out.append(GraphDelta(
            senders=f(lo.astype(np.int32)), receivers=f(hi.astype(np.int32)),
            dw=f(rng.uniform(0.1, 0.5, (B, K)).astype(np.float32)),
            w_old=torch.zeros((B, K)),
            mask=f((rng.random((B, K)) < 0.8).astype(np.float32)),
            n_nodes=N_PAD, node_ids=f(nid), node_flag=f(flag)))
    return out


def _tick(svc, delta, wrap=lambda name: contextlib.nullcontext()):
    """One tick through the serving calls, each inside ``wrap(call)``."""
    with wrap("ingest"):
        svc.ingest(delta)
    with wrap("poll"):
        svc.poll()
    with wrap("scores"):
        scores = svc.scores()
    with wrap("top_anomalies"):
        vals, ids = svc.top_anomalies()
    return scores, vals, ids


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("ingestion", ["sync", "double_buffered"])
def test_a_tick_under_the_profiler_nests_each_call_span(ingestion,
                                                         tmp_path):
    svc = _service(ingestion)
    ticks = _ticks(2)
    _tick(svc, ticks[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tick(svc, ticks[1], lambda name: record_function(f"test.{name}"))
    spans = _annotations(prof, tmp_path)
    names = [name for _, _, name in spans]
    for call in CALLS:
        mine = [s for s in spans if s[2] == f"finger.{call}"]
        parent = [s for s in spans if s[2] == f"test.{call}"]
        assert len(mine) == 1 and len(parent) == 1, names
        (a, b, _), (c, d, _) = mine[0], parent[0]
        assert c <= a <= b <= d, (call, mine, parent)
        for other in CALLS:
            if other != call:
                (e, f, _), = [s for s in spans if s[2] == f"test.{other}"]
                assert b <= e or f <= a, (call, other)
    # no card: no staging, launch or wait spans
    assert sorted(names) == sorted([f"finger.{c}" for c in CALLS]
                                   + [f"test.{c}" for c in CALLS]), names


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        entered.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    svc = _service()
    for delta in _ticks(3):
        _tick(svc, delta)
    assert entered == []
    assert tracing.span("a") is tracing.span("b")
    assert not tracing.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        _tick(svc, _ticks(1, seed=4)[0])
    assert entered == [f"finger.{c}" for c in CALLS]


@pytest.mark.parametrize("method", ["fused_tick", "dense"])
def test_the_profiler_changes_no_bit(method):
    plain, traced = _service(method=method), _service(method=method)
    for t, delta in enumerate(_ticks(4)):
        want = _tick(plain, delta)
        with profile(activities=[ProfilerActivity.CPU]):
            got = _tick(traced, delta)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w, f"tick {t}")
    for name, w in plain.states().tensors().items():
        np.testing.assert_array_equal(
            traced.states().tensors()[name].numpy(), w.numpy(), name)


@pytest.mark.parametrize("ingestion", ["sync", "double_buffered"])
def test_ingest_counts_are_zero_on_the_cpu(ingestion):
    svc = _service(ingestion)
    zero = {"staged": 0, "staged_bytes": 0, "slot_waits": 0}
    assert svc.ingest_counts() == zero
    for delta in _ticks(3):
        _tick(svc, delta)
    svc.repad(2 * N_PAD)  # a migration hands the ingestor over
    assert svc.ingest_counts() == zero
