"""The readers of the program's own spans (`bench.program_spans` and
the metrics built on it), on hand-built traced windows: the mean a
tick, clipping to the window, a slot wait that never blocked, a trace
without the spans, and idle time inside nested and overlapping spans
counted once."""
import pytest

from bench import program_spans, spec
from bench.harness import Record
from bench.trace import Trace

# window [0, 100] µs, 2 ticks; device busy [10, 30] ∪ [50, 60] ∪ [90, 120]
DEVICE = [(10.0, 30.0, "kernel", "tick_kernel"),
          (50.0, 60.0, "gpu_memcpy", "Memcpy HtoD"),
          (90.0, 120.0, "kernel", "tick_kernel")]
HOST = [(-10.0, 6.0, "finger.ingest"),     # clipped to [0, 6]
        (0.0, 4.0, "finger.ingest.pin"),
        (4.0, 5.5, "finger.ingest.enqueue"),
        (30.0, 44.0, "finger.poll"),
        (32.0, 33.0, "finger.tick.launch"),
        (40.0, 50.0, "finger.ingest"),     # overlaps finger.poll
        (41.0, 47.0, "finger.ingest.pin"),
        (47.0, 48.0, "finger.ingest.enqueue"),
        (62.0, 80.0, "finger.scores"),
        (62.0, 75.0, "finger.scores.wait"),
        (70.0, 85.0, "finger.top_anomalies"),  # overlaps scores
        (92.0, 93.0, "finger.tick.launch"),
        (130.0, 140.0, "finger.poll")]     # outside the window
TRACE = Trace(DEVICE, sorted(HOST), (0.0, 100.0), 2, 0)


def _rec(tr):
    return Record(8, (0.0, 1.0), 1.0, [], [], {}, tr)


def _read(name, tr):
    return spec.load_reader(name)(_rec(tr))


def test_mean_a_tick_clipped_to_the_window():
    # pin: 4 + 6 µs over 2 ticks
    assert program_spans.mean_ms(TRACE, "finger.ingest.pin") \
        == pytest.approx(5e-3)
    assert program_spans.mean_ms(TRACE, "finger.ingest") \
        == pytest.approx(8e-3)   # 6 (clipped) + 10
    assert program_spans.mean_ms(TRACE, "finger.poll") \
        == pytest.approx(7e-3)   # the late span adds nothing
    assert _read("ingest_pin_ms", TRACE) == pytest.approx(5e-3)
    assert _read("ingest_enqueue_ms", TRACE) == pytest.approx(1.25e-3)
    assert _read("poll_launch_ms", TRACE) == pytest.approx(1e-3)
    assert _read("scores_wait_ms", TRACE) == pytest.approx(6.5e-3)


def test_a_slot_wait_that_never_blocked_reads_zero():
    assert program_spans.mean_ms(TRACE, "finger.ingest.slot_wait") is None
    assert _read("ingest_slot_wait_ms", TRACE) == 0.0
    waited = Trace(DEVICE, sorted(HOST + [(1.0, 3.0,
                                           "finger.ingest.slot_wait")]),
                   (0.0, 100.0), 2, 0)
    assert _read("ingest_slot_wait_ms", waited) == pytest.approx(1e-3)


def test_idle_inside_nested_and_overlapping_spans_counts_once():
    # idle: [0, 10], [30, 50], [60, 90]
    # ingest ∪: [0, 6] ∪ [40, 50] -> 6 + 10
    assert program_spans.idle_within_pct(TRACE, ["finger.ingest"]) \
        == pytest.approx(16.0)
    # poll [30, 44] (the launch nested in it adds nothing)
    assert program_spans.idle_within_pct(
        TRACE, ["finger.poll", "finger.tick.launch"]) == pytest.approx(14.0)
    # ingest and poll overlap on [40, 44]: counted once
    assert program_spans.idle_within_pct(
        TRACE, ["finger.ingest", "finger.poll"]) == pytest.approx(26.0)
    # scores ∪ top_anomalies = [62, 85], all idle
    assert _read("idle_in_readback_pct", TRACE) == pytest.approx(23.0)
    assert _read("idle_in_ingest_pct", TRACE) == pytest.approx(16.0)
    assert _read("idle_in_poll_pct", TRACE) == pytest.approx(14.0)
    total = sum(_read(n, TRACE) for n in (
        "idle_in_ingest_pct", "idle_in_poll_pct", "idle_in_readback_pct"))
    assert total <= _read("device_idle_pct", TRACE) + 4.0 + 1e-9  # overlap


NAMES = ("ingest_slot_wait_ms", "ingest_pin_ms", "ingest_enqueue_ms",
         "poll_launch_ms", "scores_wait_ms", "idle_in_ingest_pct",
         "idle_in_poll_pct", "idle_in_readback_pct")


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_without_the_spans(name):
    bench_only = Trace(DEVICE, [(0.0, 20.0, "bench.ingest"),
                                (20.0, 60.0, "bench.readback")],
                       (0.0, 100.0), 2, 0)
    assert _read(name, bench_only) is None
    assert _read(name, None) is None
