"""`correct` comes out false for the control and for each fault the
cells can have, and true for the program as it is: a whole run of a
cell cut to CPU size (the look for a card skipped), with the timed path
broken underneath."""
import torch

import repro_torch.engine.stream as engine_stream
from bench import compare, harness
from bench.tests import tiny
from repro_torch.serving.plans import LocalPlan

CPU = torch.device("cpu")
SEED = 2**31 + 77


def _run(cell=None):
    return harness.run(cell or tiny.cell(), SEED, 0.3, False, CPU, 0.0)


def test_the_program_as_it_is_is_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(tiny.cell().config["limits"])
    assert set(out["readings"]) == {"score_max", "ref_score_max"}


def _limits():
    return tiny.cell().config["limits"]


def test_the_bfloat16_control_is_not_correct():
    cell = tiny.cell()
    inputs, svc, loop = harness.serve(cell, SEED, CPU)
    for _ in range(40):
        loop.step()
    loop.align(int(cell.mix["cycle_ticks"]))
    outputs = harness.Outputs.collect(svc, loop)
    numbers, refs = harness.program_numbers(cell.config, SEED, inputs.host,
                                            outputs, CPU)
    assert compare.passed(compare.judge(numbers, _limits()))
    ctrl = harness.control_numbers(cell.config, SEED, inputs.host, outputs,
                                   refs, CPU)
    checks = compare.judge(ctrl, _limits())
    assert not compare.passed(checks)
    for name in ("score_gap", "state_gap", "smax_gap", "q_gap"):
        assert checks[name]["value"] > checks[name]["limit"], name


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
