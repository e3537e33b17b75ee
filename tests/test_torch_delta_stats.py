"""The port's fused Δ-statistics against the JAX reference, on the CPU.

On CPU tensors `delta_stats_fused` runs its plain version from the
gated delta (`delta_stats_gated_ref`, the CUDA kernel's plain version);
it is held against the JAX `delta_stats_fused` in Pallas interpret mode
(its reference path above 1024 endpoints, as the JAX op routes them), on
the reference's own parity fixture and on the port's seeded cases (hub
segments, a hub on every lane, repeated ids, re-weights, deletions,
additions, masked lanes, ids outside [0, n), joins and leaves), including
an all-masked delta whose max is -inf. Tolerance: atol 1e-5 with rtol
1e-5 (the reference's kernel parity tolerance).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.incremental import gate_delta_for_update as jax_gate
from repro.core.state import finger_state as jax_finger_state
from repro.graphs.generators import erdos_renyi as jax_er
from repro.graphs.types import GraphDelta as JaxDelta
from repro.kernels.delta_stats.ops import (
    delta_stats_fused as jax_fused,
    prepare_sorted_delta as jax_prepare,
)
from repro.kernels.delta_stats.ref import delta_stats_sorted_ref as jax_ref
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.delta_stats import ops as tops
from repro_torch.core.incremental import gate_delta_for_update
from repro_torch.kernels.delta_stats.parity import make_case, stack_case
from repro_torch.kernels.delta_stats.ref import (delta_stats_gated_ref,
                                                 delta_stats_sorted_ref)
from _torch_parity import (assert_close, delta_to_jax, state_to_jax,
                           state_to_port)


def _assert_triples(got, want, label):
    for name, g, w in zip(("dS", "dQ", "max"), got, want):
        assert_close(g, w, f"{label}: {name}")


def test_matches_jax_on_reference_fixture():
    rng = np.random.default_rng(3)
    g = jax_er(48, 0.2, seed=3, weighted=True).pad_to(64)
    jst = jax_finger_state(g)
    iu, ju = np.triu_indices(48, k=1)
    pick = rng.choice(len(iu), size=12, replace=False)
    ii, jj = iu[pick], ju[pick]
    w_old = np.asarray(g.weights)[ii, jj]
    dw = np.where(w_old > 0, -w_old, 0.6).astype(np.float32)
    args = (ii, jj, dw, w_old)
    jd = JaxDelta.from_arrays(*args, n_nodes=64, k_pad=16)
    td = GraphDelta.from_arrays(*args, n_nodes=64, k_pad=16)
    want = jax_fused(jst, jd, use_pallas=True, interpret=True)
    got = tops.delta_stats_fused(state_to_port(jst), td)
    _assert_triples(got, want, "fixture")


@pytest.mark.parametrize("k", [1, 7, 40, 200])
def test_matches_jax_interpret_mode(k):
    tst, td = make_case(256, k, seed=k, device="cpu")
    jst, jd = state_to_jax(tst), delta_to_jax(td)
    want = jax_fused(jst, jd, use_pallas=True, interpret=True)
    got = tops.delta_stats_fused(tst, td)
    _assert_triples(got, want, f"k={k}")
    # the (4,) stats of the plain version, |ΔV| included
    stats = delta_stats_sorted_ref(*tops.prepare_sorted_delta(
        tst.strengths, td))
    jprep = jax_prepare(jst.strengths, jd)
    assert_close(stats, jax_ref(*jprep), f"k={k} stats")


def test_all_masked_delta_max_is_minus_inf():
    tst, td = make_case(64, 16, seed=5, device="cpu", all_masked=True)
    want = jax_fused(state_to_jax(tst), delta_to_jax(td), use_pallas=True,
                     interpret=True)
    got = tops.delta_stats_fused(tst, td)
    assert float(got[2]) == float(want[2]) == -np.inf
    assert float(got[0]) == float(want[0]) == 0.0
    assert float(got[1]) == float(want[1]) == 0.0


def test_gates_inactive_nodes_before_the_reduction():
    tst, td = make_case(64, 24, seed=6, device="cpu")
    mask = tst.node_mask.clone()
    mask[::3] = 0.0
    tst = dataclasses.replace(tst, strengths=tst.strengths * mask,
                              node_mask=mask)
    want = jax_fused(state_to_jax(tst), delta_to_jax(td), use_pallas=True,
                     interpret=True)
    got = tops.delta_stats_fused(tst, td)
    _assert_triples(got, want, "gated")


def test_cpu_tensors_never_count_a_launch():
    tst, td = make_case(64, 8, seed=7, device="cpu")
    before = tops.LAUNCHES
    tops.delta_stats_fused(tst, td)
    assert tops.LAUNCHES == before


# label → (n, k, kind, all_masked, pre_gated)
GATED_CASES = {
    "k=1": (256, 1, "mixed", False, False),
    "k=37": (256, 37, "mixed", False, False),
    "k=128": (1024, 128, "mixed", False, False),
    "k=200": (1024, 200, "mixed", False, False),
    "k=1024": (4096, 1024, "mixed", False, False),
    "hub on every lane": (256, 128, "hub", False, False),
    "repeated ids": (64, 100, "repeat", False, False),
    # gated first, as update_state gates: the reference indexes an
    # ungated negative id as n + id, where the port drops it
    "out of range, joins and leaves": (256, 96, "gating", False, False),
    "pre-gated": (1024, 128, "mixed", False, True),
    "all masked": (64, 40, "mixed", True, False),
}


@pytest.mark.parametrize("label", list(GATED_CASES))
def test_gated_route_matches_jax(label):
    """The plain route from the gated delta against the JAX op, and its
    (4,) stats, |ΔV| included, against the JAX sorted-form reference."""
    n, k, kind, all_masked, pre_gated = GATED_CASES[label]
    tst, td = make_case(n, k, seed=3 + k, device="cpu",
                        all_masked=all_masked, kind=kind)
    jst, jd = state_to_jax(tst), delta_to_jax(td)
    want = jax_fused(jst, jd, use_pallas=True, interpret=True,
                     pre_gated=pre_gated)
    got = tops.delta_stats_fused(tst, td, pre_gated=pre_gated)
    _assert_triples(got, want, label)
    if not pre_gated:
        td, _ = gate_delta_for_update(tst.node_mask, td)
        jd, _ = jax_gate(jst.node_mask, jd)
    stats = delta_stats_gated_ref(tst.strengths, td)
    assert_close(stats, jax_ref(*jax_prepare(jst.strengths, jd)),
                 f"{label} stats")
    if all_masked:
        assert float(stats[2]) == float(want[2]) == -np.inf
        assert float(stats[3]) == 0.0
    else:
        assert float(stats[3]) > 0.0


@pytest.mark.parametrize("kind", ["mixed", "hub"])
def test_leading_batch_axes_reduce_one_row_a_stream(kind):
    """(2, 3) streams at once, the first all-masked: each row's stats
    equal the JAX sorted-form reference on that stream alone."""
    strengths, td = stack_case(128, 40, (2, 3), seed=9, device="cpu",
                               kind=kind)
    stats = delta_stats_gated_ref(strengths, td)
    assert stats.shape == (2, 3, 4)
    flat = stats.reshape(6, 4)
    assert float(flat[0, 2]) == -np.inf and float(flat[0, 3]) == 0.0
    for r in range(6):
        row = td.map_tensors(lambda x: x.reshape(6, -1)[r])
        jd = delta_to_jax(row)
        want = jax_ref(*jax_prepare(
            state_to_jax(make_case(128, 40, 9 + r, "cpu", kind=kind)[0])
            .strengths, jd))
        assert_close(flat[r], want, f"{kind} row {r}")
