"""The union and idle arithmetic and every metric reader, on a small
canned profiler trace and a hand-made record."""
import json

import numpy as np
import pytest

from bench import spec, trace
from bench.harness import Record
from bench.roofline import PEAK


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("bench.traced", "user_annotation", 0, 100),
    _x("bench.ingest", "user_annotation", 0, 20),
    _x("bench.readback", "user_annotation", 20, 40),
    _x("bench.poll", "user_annotation", 60, 10),
    _x("bench.ingest", "user_annotation", 70, 20),
    _x("tick_kernel<false, 2>", "kernel", 10, 40),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 5, 10),
    _x("radixSort", "kernel", 55, 3),
    _x("Memset (Device)", "gpu_memset", 95, 15),
    _x("late kernel", "kernel", 120, 10),
    _x("aten::copy_", "cpu_op", 0, 50),
    {"ph": "i", "name": "marker", "ts": 3},
]
BYTES = int(round(PEAK["hbm_bytes_per_s"] * 26.5e-6))


@pytest.fixture
def rec(tmp_path):
    tr = trace.load(_write(tmp_path, EVENTS), "bench.traced", 2, BYTES)
    return Record(batch=100, window=(0.0, 1.0), setup_s=12.5,
                  t_in=np.array([0.0, 0.1, 0.2, 0.3, 0.9, np.nan]),
                  t_done=np.array([0.05, 0.3, 0.4, 0.5, 1.2, np.nan]),
                  spans={"ingest": [0.001, 0.003], "poll": [0.0002],
                         "readback": []},
                  trace=tr)


def test_union_and_gaps():
    assert trace.union([(5, 10), (0, 3), (2, 4), (10, 12)]) \
        == [[0, 4], [5, 12]]
    assert trace.covered([(5, 10), (0, 3), (2, 4)]) == 9
    assert trace.gaps([(2, 3), (5, 8)], (0, 10)) == [(0, 2), (3, 5), (8, 10)]


def test_trace_window_busy_idle_and_breakdown(rec):
    tr = rec.trace
    # busy: [5, 50] ∪ [55, 58] ∪ [95, 100] (the memset clipped, the late
    # kernel outside the window)
    assert tr.busy_s() == pytest.approx(53e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert [n for n, _ in trace.top_ops(tr)] == [
        "tick_kernel<false, 2>", "Memcpy HtoD (Pinned -> Device)",
        "Memset (Device)", "radixSort"]
    gaps = trace.labelled_gaps(tr)
    assert gaps[0][0] == "bench.ingest"
    assert gaps[0][1] == pytest.approx(37e-6)
    assert sorted(g[0] for g in gaps[1:]) == ["bench.ingest",
                                              "bench.readback"]


def _read(name, rec):
    return spec.load_reader(name)(rec)


def test_device_readers(rec):
    assert _read("h2d_copy_ms", rec) == pytest.approx(0.005)
    assert _read("tick_device_ms", rec) == pytest.approx(0.0215)
    assert _read("tick_roofline_pct", rec) == pytest.approx(50.0, rel=1e-6)
    assert _read("device_idle_pct", rec) == pytest.approx(47.0)


def test_host_and_end_to_end_readers(rec):
    assert _read("ingest_ms", rec) == pytest.approx(2.0)
    assert _read("poll_ms", rec) == pytest.approx(0.2)
    assert _read("readback_ms", rec) is None
    assert _read("setup_s", rec) == 12.5
    # four ticks done inside [0, 1], one late, one never
    assert _read("stream_ticks_per_s", rec) == pytest.approx(400.0)
    lat = np.array([0.05, 0.2, 0.2, 0.2])
    assert _read("tick_p95_ms", rec) == pytest.approx(
        np.percentile(lat, 95) * 1e3)


def test_readers_find_nothing_without_a_trace(tmp_path, rec):
    no_window = [e for e in EVENTS if e["name"] != "bench.traced"]
    assert trace.load(_write(tmp_path, no_window), "bench.traced", 2,
                      BYTES) is None
    no_device = [e for e in EVENTS if e.get("cat") not in trace.DEVICE_CATS]
    assert trace.load(_write(tmp_path, no_device), "bench.traced", 2,
                      BYTES) is None
    bare = Record(1, (0.0, 1.0), 1.0, np.zeros(0), np.zeros(0),
                  {"ingest": []})
    for name in ("h2d_copy_ms", "tick_device_ms", "tick_roofline_pct",
                 "device_idle_pct", "ingest_ms", "tick_p95_ms"):
        assert _read(name, bare) is None
