"""The plain reference: FINGER-H̃ and JS distances by hand on tiny
graphs, against the port's own plain tick in float64 on a seeded cell,
its every-stream scalars against its per-stream cycle, and its edge
weights against its strength rows."""
import math

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import edges, finger
from bench.tests import tiny


def _h(s_total, sum_s2, sum_w2, s_max):
    q = 1.0 - (sum_s2 + 2.0 * sum_w2) / s_total ** 2
    return q, -q * math.log(2.0 * s_max / s_total)


# a triangle 0-1-2 with a pendant 2-3, every weight 1
LO = torch.tensor([0, 0, 1, 2])
HI = torch.tensor([1, 2, 2, 3])
W = torch.ones(4, dtype=torch.float64)


def test_graph_stats_by_hand():
    st = finger.graph_stats(LO, HI, W, 6)
    q, h = _h(8.0, 18.0, 4.0, 3.0)       # s = [2, 2, 3, 1]
    assert float(st["s_total"]) == 8.0 and float(st["s_max"]) == 3.0
    assert float(st["q"]) == pytest.approx(q, abs=1e-15)
    assert float(st["h"]) == pytest.approx(h, abs=1e-15)
    assert st["strengths"].tolist() == [2.0, 2.0, 3.0, 1.0, 0.0, 0.0]


def _deltas(rows):
    """A cycle of one-lane deltas (senders, receivers, dw) with no node
    slots in use."""
    n = len(rows)
    return {
        "senders": np.array([[r[0], 0] for r in rows], np.int32),
        "receivers": np.array([[r[1], 0] for r in rows], np.int32),
        "dw": np.array([[r[2], 0.0] for r in rows], np.float32),
        "w_old": np.zeros((n, 2), np.float32),
        "mask": np.array([[1.0, 0.0]] * n, np.float32),
        "node_ids": np.zeros((n, 2), np.int32),
        "node_flag": np.zeros((n, 2), np.float32),
    }


def test_js_distance_by_hand():
    # tick 0 deletes the pendant edge, tick 1 brings it back
    ref = finger.cycle_from(LO, HI, W, 4, _deltas([(2, 3, -1.0),
                                                   (3, 2, 1.0)]), 6)
    _, h_g = _h(8.0, 18.0, 4.0, 3.0)
    _, h_after = _h(6.0, 12.0, 3.0, 2.0)          # s = [2, 2, 2, 0]
    _, h_mid = _h(7.0, 14.5, 3.25, 2.5)           # s = [2, 2, 2.5, 0.5]
    want = math.sqrt(h_mid - 0.5 * (h_g + h_after))
    assert ref["scores"] == pytest.approx([want, want], abs=1e-14)
    after = ref["states"](1)
    assert after["s_total"] == 6.0 and after["s_max"] == 2.0
    assert after["node_mask"].tolist() == [1, 1, 1, 1, 0, 0]
    assert ref["states"](2)["strengths"].tolist() == [2, 2, 3, 1, 0, 0]


def test_a_lane_on_a_dead_node_changes_nothing():
    d = _deltas([(3, 4, 1.0), (3, 4, -1.0)])    # node 4 is not live
    ref = finger.cycle_from(LO, HI, W, 4, d, 6)
    assert ref["scores"].tolist() == [0.0, 0.0]
    d["node_ids"][0, 0], d["node_flag"][0, 0] = 4, 1.0   # now it joins
    d["node_ids"][1, 0], d["node_flag"][1, 0] = 4, -1.0  # and leaves
    ref = finger.cycle_from(LO, HI, W, 4, d, 6)
    assert ref["scores"][0] > 0
    assert ref["states"](1)["node_mask"].tolist() == [1, 1, 1, 1, 1, 0]
    assert ref["states"](2)["node_mask"].tolist() == [1, 1, 1, 1, 0, 0]


def test_reference_agrees_with_the_ports_float64_tick():
    """The second witness: the port's own plain tick, run in float64,
    gives the reference's distances and state (in float32 it cannot
    resolve distances this small)."""
    from repro_torch.core.jsdist import jsdist_incremental

    cell = tiny.cell(batch_size=4)
    cfg = cell.config
    inputs = harness.make_inputs(cfg, cell.mix, 31, torch.device("cpu"))
    period = len(inputs.deltas)
    refs = harness.reference_streams(cfg, 31, np.arange(4), inputs.host,
                                     torch.float64, torch.device("cpu"))
    st = inputs.states.map_tensors(lambda t: t.double())
    for t in range(period):
        d = inputs.deltas[t].map_tensors(
            lambda x: x.double() if x.is_floating_point() else x)
        dist, st = jsdist_incremental(st, d, exact_smax=True)
        want = np.array([r["scores"][t] for r in refs])
        np.testing.assert_allclose(dist.numpy(), want, rtol=1e-6,
                                   atol=1e-10)
        for j, r in enumerate(refs):
            s = r["states"](t + 1)
            np.testing.assert_allclose(st.strengths[j].numpy(),
                                       s["strengths"], atol=1e-9)
            # the initial Q was rounded once to the state's float32
            assert float(st.q[j]) == pytest.approx(s["q"], abs=1e-7)


def test_every_stream_scalars_match_the_cycle():
    cell = tiny.cell(batch_size=5)
    cfg = cell.config
    inputs = harness.make_inputs(cfg, cell.mix, 8, torch.device("cpu"))
    refs = harness.reference_streams(cfg, 8, np.arange(5), inputs.host,
                                     torch.float64, torch.device("cpu"))
    for ticks in (0, 5, 8, 13):
        for streams in (np.arange(5), np.array([1, 3, 4])):
            got = harness.reference_scalars(cfg, 8, inputs.host, streams,
                                            ticks, torch.device("cpu"))
            for j, stream in enumerate(streams):
                s = refs[stream]["states"](ticks)
                for f in ("q", "s_total", "s_max"):
                    assert got[f][j] == pytest.approx(s[f], abs=1e-12)


def test_edge_weights_by_hand_and_against_the_strength_rows():
    # tick 0 deletes the pendant edge and names the absent pair (0, 3)
    # with no change; tick 1 brings the pendant back
    d = _deltas([(2, 3, -1.0), (3, 2, 1.0)])
    d["senders"][0, 1], d["receivers"][0, 1], d["mask"][0, 1] = 0, 3, 1.0
    after = edges.weights_from(LO, HI, W, 4, d, 6, 1)
    back = edges.weights_from(LO, HI, W, 4, d, 6, 2)
    assert after == {(0, 1): 1.0, (0, 2): 1.0, (1, 2): 1.0, (2, 3): 0.0,
                     (0, 3): 0.0}
    assert back[(2, 3)] == 1.0

    cell = tiny.cell(batch_size=3)
    cfg = cell.config
    inputs = harness.make_inputs(cfg, cell.mix, 21, torch.device("cpu"))
    refs = harness.reference_streams(cfg, 21, np.arange(3), inputs.host,
                                     torch.float64, torch.device("cpu"))
    for ticks in (3, 8, 16):
        got = harness.reference_edges(cfg, 21, np.arange(3), inputs.host,
                                      ticks)
        for j, w in enumerate(got):
            s = np.zeros(128)
            for (a, b), x in w.items():
                s[a] += x
                s[b] += x
            np.testing.assert_allclose(
                s, refs[j]["states"](ticks)["strengths"], atol=1e-12)
        ctrl = harness.reference_edges(cfg, 21, np.arange(3), inputs.host,
                                       ticks, torch.bfloat16)
        assert set(ctrl[0]) == set(got[0]) and ctrl[0] != got[0]
