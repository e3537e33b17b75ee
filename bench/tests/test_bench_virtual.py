"""The sparse_tick set-up over a virtual id space: the seed's bijection
is one to one, the virtual deltas carry the dense cycle's ids through
it, and a sparse run reads what a dense run of the same graphs reads
(VNGE does not change under relabelling)."""
import numpy as np
import pytest
import torch

from bench import harness, virtual
from bench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("bits", [1, 5, 12, 20])
@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**33 + 1])
def test_the_bijection_is_one_to_one(bits, seed):
    got = virtual.relabel(seed, bits, torch.arange(1 << bits))
    assert torch.equal(torch.sort(got).values, torch.arange(1 << bits))


def test_the_bijection_moves_ids_and_differs_by_seed():
    a = virtual.relabel(3, 20, torch.arange(1024))
    b = virtual.relabel(4, 20, torch.arange(1024))
    assert not torch.equal(a, b)
    assert int(a.max()) >= 1 << 19  # spread over the space, not its start


@pytest.mark.parametrize("n_pad", [3000, 64])
def test_a_virtual_bound_that_cannot_hold_the_slots_is_refused(n_pad):
    cfg = tiny.sparse_cell(n_virtual=n_pad).config
    with pytest.raises(ValueError):
        virtual.Relabel(cfg, 1)


def test_virtual_deltas_carry_the_cycle_through_the_bijection():
    cell = tiny.sparse_cell(batch_size=5)
    inputs = harness.make_inputs(cell.config, cell.mix, 11, CPU)
    ids = inputs.ids
    assert len(inputs.deltas) == 16 and all(len(d) == 5
                                            for d in inputs.deltas)
    for t in (0, 9):
        for s in (0, 4):
            d = inputs.deltas[t][s]
            assert d.n_nodes == 4096
            for f in ("senders", "receivers", "node_ids"):
                dense = inputs.host[f][t, s].long()
                assert torch.equal(d.tensors()[f].long(), ids.forward[dense])
                assert [ids.back(v) for v in d.tensors()[f].tolist()] \
                    == dense.tolist()
            for f in ("dw", "w_old", "mask", "node_flag"):
                assert torch.equal(d.tensors()[f], inputs.host[f][t, s])
    graphs = list(inputs.graphs())
    assert len(graphs) == 5
    live = int(inputs.n_live[2])
    assert torch.equal(torch.sort(graphs[2].node_mask.nonzero().flatten())
                       .values, torch.sort(ids.forward[:live]).values)


def _served(cell, seed, steps=20):
    inputs, svc, loop = harness.serve(cell, seed, CPU)
    for _ in range(steps):
        loop.step()
    loop.align(int(cell.mix["cycle_ticks"]))
    out = harness.Outputs.collect(svc, loop)
    svc.close()
    return out


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_a_sparse_run_reads_the_dense_run(seed):
    dense = _served(tiny.cell(n_pad=128), seed)
    sparse = _served(tiny.sparse_cell(n_slots=128), seed)
    # the two loops warm up for different tick counts; compare the ticks
    # both read, by their index
    n = min(len(dense.ticks), len(sparse.ticks))
    assert dense.final_tick % 16 == sparse.final_tick % 16
    # a score is the root of an entropy difference: compare its square
    # to a few float32 steps of the entropy (about 4 here)
    np.testing.assert_allclose(sparse.scores[:n].astype(np.float64) ** 2,
                               dense.scores[:n].astype(np.float64) ** 2,
                               rtol=0, atol=4 * 4.8e-7)
    for f in ("q", "s_total", "s_max"):
        np.testing.assert_allclose(sparse.scalars[f], dense.scalars[f],
                                   rtol=2e-6, atol=2e-7)


def test_read_back_puts_slot_rows_at_their_dense_ids():
    cell = tiny.sparse_cell(batch_size=4)
    out = _served(cell, 9, steps=5)
    ids = virtual.Relabel(cell.config, 9)
    state, left = virtual.read_back(out.state, out.maps, ids)
    for j, sm in enumerate(out.maps):
        for vid, slot in sm.node_slot.items():
            d = ids.back(vid)
            assert state["strengths"][j, d] == out.state["strengths"][j, slot]
            assert state["node_mask"][j, d] == 1.0
        assert state["node_mask"][j].sum() == len(sm.node_slot)
        weights, free = left["stores"][j]
        assert len(weights) == len(sm.edge_slot)
        assert len(free) == cell.config["service"]["m_pad"] \
            - len(sm.edge_slot) and not free.any()
    assert left["stray_masks"] == 0 and max(left["stray_strengths"]) == 0.0


def test_a_traced_run_profiles_a_bounded_share_of_the_window():
    dense = tiny.cell(batch_size=524_288).config
    assert harness.traced_ticks(dense, 490) == harness.TRACED_TICKS
    assert harness.traced_ticks(dense, 5) == 5
    assert harness.traced_ticks(dense, 0) == 1
    for b, want in ((256, 16), (512, 8), (1024, 8), (4096, 8),
                    (65_536, 8)):
        cfg = tiny.sparse_cell(batch_size=b).config
        assert harness.traced_ticks(cfg, 490) == want
    assert harness.traced_ticks(tiny.sparse_cell(batch_size=256).config,
                                3) == 3
