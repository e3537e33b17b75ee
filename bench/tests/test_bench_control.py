"""`correct` comes out false for the control and for each fault the
cells can have, and true for the program as it is: a whole run of a
cell cut to CPU size (the look for a card skipped), with the timed path
broken underneath; the ``sparse_tick`` cell's own faults too (its
translation, its edge store)."""
import pytest
import torch

import repro_torch.engine.stream as engine_stream
from bench import compare, harness
from bench.tests import tiny
from repro_torch.core.sparse import SlotMap
from repro_torch.serving.plans import LocalPlan

CPU = torch.device("cpu")
SEED = 2**31 + 77
CELLS = {"dense": tiny.cell, "sparse": tiny.sparse_cell}


def _run(cell=None):
    return harness.run(cell or tiny.cell(), SEED, 0.3, False, CPU, 0.0)


@pytest.mark.parametrize("kind", CELLS)
def test_the_program_as_it_is_is_correct(kind):
    cell = CELLS[kind]()
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(cell.config["limits"])
    assert set(out["readings"]) == {"score_max", "ref_score_max"}


def _limits(cell=None):
    return (cell or tiny.cell()).config["limits"]


@pytest.mark.parametrize("kind", CELLS)
def test_the_bfloat16_control_is_not_correct(kind):
    cell = CELLS[kind]()
    inputs, svc, loop = harness.serve(cell, SEED, CPU)
    for _ in range(40):
        loop.step()
    loop.align(int(cell.mix["cycle_ticks"]))
    outputs = harness.Outputs.collect(svc, loop)
    numbers, refs = harness.program_numbers(cell.config, SEED, inputs.host,
                                            outputs, CPU)
    assert compare.passed(compare.judge(numbers, _limits(cell)))
    ctrl = harness.control_numbers(cell.config, SEED, inputs.host, outputs,
                                   refs, CPU)
    checks = compare.judge(ctrl, _limits(cell))
    assert not compare.passed(checks)
    for name in ("score_gap", "state_gap", "smax_gap", "q_gap") + (
            ("edge_gap",) if kind == "sparse" else ()):
        assert checks[name]["value"] > checks[name]["limit"], name


def _patch_stage(monkeypatch, fault, stream=3):
    """Break ``stream``'s translation once, on its first delta with a live
    lane that changes a weight: ``fault(slot_map, delta, lane, real)``
    returns the staged translation."""
    real = SlotMap.stage
    done = []

    def stage(self, delta):
        lanes = ((delta.mask > 0) & (delta.dw != 0)).nonzero().flatten()
        if done or self.stream != stream or not len(lanes):
            return real(self, delta)
        done.append(True)
        return fault(self, delta, int(lanes[0]), real)

    monkeypatch.setattr(SlotMap, "stage", stage)
    return done


def test_two_virtual_ids_swapped_in_a_streams_translation(monkeypatch):
    def swapped(sm, delta, lane, real):
        a = int(delta.senders[lane])
        others = {int(delta.receivers[lane]), a}
        c = next(v for v in sm.node_slot if v not in others)
        slots = sm.node_slot
        slots[a], slots[c] = slots[c], slots[a]
        try:
            return real(sm, delta)
        finally:
            slots[a], slots[c] = slots[c], slots[a]

    done = _patch_stage(monkeypatch, swapped)
    out = _run(tiny.sparse_cell())
    assert done and not out["correct"]
    assert out["checks"]["state_gap"]["value"] > \
        out["checks"]["state_gap"]["limit"]


def test_one_live_lane_dropped(monkeypatch):
    def dropped(sm, delta, lane, real):
        staged = real(sm, delta)
        staged.delta.mask[lane] = 0.0
        return staged

    done = _patch_stage(monkeypatch, dropped)
    out = _run(tiny.sparse_cell())
    assert done and not out["correct"]
    # the edge store is written whole, so the lane's next tick mends it;
    # the strengths are moved by each change and keep the loss
    assert out["checks"]["state_gap"]["value"] > \
        out["checks"]["state_gap"]["limit"]


def test_the_edge_store_scatter_skipped(monkeypatch):
    real = engine_stream.sparse_tick_fused

    def skipped(states, deltas, exact_smax=False, inplace=False):
        before = states.edge_weights.clone()
        dist, new = real(states, deltas, exact_smax=exact_smax,
                         inplace=inplace)
        new.edge_weights.copy_(before)
        return dist, new

    monkeypatch.setattr(engine_stream, "sparse_tick_fused", skipped)
    out = _run(tiny.sparse_cell())
    assert not out["correct"]
    checks = out["checks"]
    assert checks["edge_gap"]["value"] > checks["edge_gap"]["limit"]
    # the scatter is all that was left out
    assert all(c["value"] <= c["limit"] for n, c in checks.items()
               if n != "edge_gap")


def _patch_tick(monkeypatch, fn):
    real = engine_stream.stream_tick_fused

    def tick(states, deltas, exact_smax=False, inplace=False):
        return fn(real, states, deltas, exact_smax)

    monkeypatch.setattr(engine_stream, "stream_tick_fused", tick)


def test_a_tick_that_leaves_the_state_unchanged(monkeypatch):
    def unchanged(real, states, deltas, exact_smax):
        dist, _ = real(states, deltas, exact_smax=exact_smax, inplace=False)
        return dist, states

    _patch_tick(monkeypatch, unchanged)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > \
        out["checks"]["state_gap"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    def half(real, states, deltas, exact_smax):
        dist, new = real(states, deltas, exact_smax=exact_smax,
                         inplace=False)
        h = states.q.shape[0] // 2
        for f, t in states.tensors().items():
            t[:h].copy_(new.tensors()[f][:h])
        dist = dist.clone()
        dist[h:] = 0.0
        return dist, states

    _patch_tick(monkeypatch, half)
    out = _run()
    assert not out["correct"]


def test_a_top_k_answer_altered_where_it_is_produced(monkeypatch):
    real = LocalPlan.topk

    def shifted(self, scores, k):
        vals, ids = real(self, scores, k)
        return vals, (ids + 1) % scores.shape[0]

    monkeypatch.setattr(LocalPlan, "topk", shifted)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["topk_gap"]["value"] > 0


def test_scores_zeroed_where_they_are_produced(monkeypatch):
    def zeroed(real, states, deltas, exact_smax):
        dist, states = real(states, deltas, exact_smax=exact_smax,
                            inplace=True)
        return torch.zeros_like(dist), states

    _patch_tick(monkeypatch, zeroed)
    out = _run()
    assert not out["correct"]
    # a zeroed score is off by the reference's own score
    assert out["checks"]["score_gap"]["value"] == \
        out["readings"]["ref_score_max"]
    assert out["checks"]["score_gap"]["value"] > \
        out["checks"]["score_gap"]["limit"]


def test_scores_off_by_256_float32_steps_of_the_entropy(monkeypatch):
    def shifted(real, states, deltas, exact_smax):
        dist, states = real(states, deltas, exact_smax=exact_smax,
                            inplace=True)
        h = -states.q * torch.log(2.0 * states.s_max / states.s_total)
        step = torch.nextafter(h, torch.full_like(h, float("inf"))) - h
        return torch.sqrt(dist * dist + 256.0 * step), states

    _patch_tick(monkeypatch, shifted)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > \
        out["checks"]["score_gap"]["limit"]


def test_a_score_that_is_not_finite_fails_the_run(monkeypatch):
    def poisoned(real, states, deltas, exact_smax):
        dist, states = real(states, deltas, exact_smax=exact_smax,
                            inplace=True)
        dist = dist.clone()
        dist[3] = float("nan")
        return dist, states

    _patch_tick(monkeypatch, poisoned)
    out = _run()
    assert not out["correct"] and out["failed"] > 0


def test_the_s_max_of_eq3_breaks_the_exact_smax_guarantee():
    cell = tiny.cell()
    inputs, svc, loop = harness.serve(cell, SEED, CPU, exact_smax=False)
    for _ in range(40):
        loop.step()
    loop.align(int(cell.mix["cycle_ticks"]))
    outputs = harness.Outputs.collect(svc, loop)
    numbers, _ = harness.program_numbers(cell.config, SEED, inputs.host,
                                         outputs, CPU)
    checks = compare.judge(numbers, _limits())
    assert not compare.passed(checks)
    assert checks["smax_gap"]["value"] > checks["smax_gap"]["limit"]


def test_a_raised_tick_is_a_failed_run(monkeypatch):
    calls = {"n": 0}

    def raising(real, states, deltas, exact_smax):
        calls["n"] += 1
        if calls["n"] > 30:
            raise RuntimeError("a launch CUDA refused")
        return real(states, deltas, exact_smax=exact_smax, inplace=True)

    _patch_tick(monkeypatch, raising)
    out = _run()
    assert not out["correct"] and out["failed"] > 0 and "error" in out
