"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device: a hand-written CUDA kernel has no
interpret mode, so on a machine without a card each test skips by name.
Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are those of the parity modules (`kernels/*/parity.py`):
atol 1e-5 with rtol 1e-5 on state and statistics, exact masks, and the
score compared as a divergence (see `stream_tick.parity`);
``delta_stats`` against its plain version evaluated in float64, as the
kernel sums (`delta_stats.parity.plain`); ``vnge_q``
at rtol 3e-5 and ``entropy_probe`` at rtol 5e-4 (atol 1e-5), the
reference's own kernel-test tolerances; ``bsr_spmv`` at atol 1e-5 with
rtol 1e-5, and λ_max of its power iteration at rtol 1e-5 against the
plain version's from the same start vector. Two launches on the same
inputs, and an in-place tick against an out-of-place one, agree bit for
bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.incremental import gate_delta_for_update
from repro_torch.core.jsdist import jsdist_stream
from repro_torch.core.sparse import stack_sparse_states
from repro_torch.core.state import FingerState
from repro_torch.engine.stream import stack_deltas, stack_states
from repro_torch.kernels import dispatch
from repro_torch.kernels.bsr_spmv import ops as bs_ops
from repro_torch.kernels.bsr_spmv import parity as bs_parity
from repro_torch.kernels.bsr_spmv.ref import bsr_matvec_ref
from repro_torch.kernels.delta_stats import ops as ds_ops
from repro_torch.kernels.delta_stats import parity as ds_parity
from repro_torch.kernels.entropy_probe import ops as ep_ops
from repro_torch.kernels.entropy_probe import parity as ep_parity
from repro_torch.kernels.entropy_probe import ref as ep_ref
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.sparse_tick import parity as sp_parity
from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.kernels.stream_tick import parity as st_parity
from repro_torch.kernels.stream_tick.ref import stream_tick_ref
from repro_torch.kernels.vnge_q import ops as vq_ops
from repro_torch.kernels.vnge_q import parity as vq_parity
from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(1000, 333, 37, 3),
                                   (4096, 1024, 128, 8)])
def test_stream_tick_matches_plain(cuda, shape, exact):
    states, deltas = st_parity.make_case(*shape, seed=3, device=cuda)
    before = dict(st_ops.LAUNCHES)
    got = st_ops.stream_tick_fused(states, deltas, exact_smax=exact)
    torch.cuda.synchronize()
    assert st_ops.LAUNCHES == {**before,
                               "stream_tick": before["stream_tick"] + 1}
    want = stream_tick_ref(states, deltas, exact_smax=exact)
    st_parity.compare(got, want)


@pytest.mark.parametrize("shape", [(64, 4200, 1024, 4), (256, 300, 40, 2)])
def test_stream_tick_large_k_and_no_node_slots(cuda, shape):
    """k_pad = 1024 needs about 81 KB of shared memory a block of four
    streams (the opt-in above 48 KB); the second shape drops the node
    slots (j = 0, no pointers)."""
    states, deltas = st_parity.make_case(*shape, seed=7, device=cuda)
    if shape[2] < 1024:
        deltas = dataclasses.replace(deltas, node_ids=None, node_flag=None)
    else:
        assert st_ops.stream_tick_smem_bytes(shape[2], shape[3]) > 48 * 1024
    for exact in (False, True):
        got = st_ops.stream_tick_fused(states, deltas, exact_smax=exact)
        want = stream_tick_ref(states, deltas, exact_smax=exact)
        st_parity.compare(got, want, f"stream_tick {shape}")


def test_stream_tick_stacked_matches_plain(cuda):
    cases = [st_parity.make_case(64, 200, 16, 4, seed=s, device=cuda)
             for s in range(3)]
    states = stack_states([c[0] for c in cases])
    deltas = stack_deltas([c[1] for c in cases])
    before = dict(st_ops.LAUNCHES)
    got = st_ops.stream_tick_fused_stacked(states, deltas, exact_smax=True)
    assert st_ops.LAUNCHES == {
        **before, "stream_tick_stacked": before["stream_tick_stacked"] + 1}
    want = stream_tick_ref(states, deltas, exact_smax=True)
    assert got[0].shape == (3, 64)
    st_parity.compare(got, want, label="stream_tick_stacked")


def test_stream_tick_in_place_matches_out_of_place(cuda):
    states, deltas = st_parity.make_case(512, 256, 32, 4, seed=5,
                                         device=cuda)
    want = st_ops.stream_tick_fused(states, deltas, exact_smax=True)
    copy = states.map_tensors(torch.clone)
    got = st_ops.stream_tick_fused(copy, deltas, exact_smax=True,
                                   inplace=True)
    assert got[1].strengths.data_ptr() == copy.strengths.data_ptr()
    for a, b in zip([got[0], *got[1].tensors().values()],
                    [want[0], *want[1].tensors().values()]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("label", list(st_parity.STRESS))
def test_stream_tick_stress_cases(cuda, label):
    """The stress rows (a hub looped on every lane, a star, joins and
    leaves on touched nodes, all-masked rows beside live ones) at k odd,
    at the serving k and above the register sort: the kernel against the
    plain version, in place against out of place bit for bit, and two
    launches bit-equal."""
    states, deltas = st_parity.make_case(*st_parity.STRESS[label], seed=5,
                                         device=cuda, kind="stress")
    for exact in (False, True):
        got = st_ops.stream_tick_fused(states, deltas, exact_smax=exact)
        st_parity.compare(got, stream_tick_ref(states, deltas,
                                               exact_smax=exact), label)
        again = st_ops.stream_tick_fused(states, deltas, exact_smax=exact)
        copy = states.map_tensors(torch.clone)
        inplace = st_ops.stream_tick_fused(copy, deltas, exact_smax=exact,
                                           inplace=True)
        for other in (again, inplace):
            for a, b in zip([got[0], *got[1].tensors().values()],
                            [other[0], *other[1].tensors().values()]):
                torch.testing.assert_close(a, b, atol=0, rtol=0)


def _flat(tick):
    dist, state = tick
    return [dist, *state.tensors().values()]


def _split_runs(monkeypatch, entry, name, states, deltas, exact):
    """Ticks of ``entry`` with each W of 1, 2, 4 and 8 that divides the
    block's warps forced, out of place and in place on a copy; each W's
    outputs, and the split count's step."""
    k, j = deltas.senders.shape[-1], deltas.node_ids.shape[-1]
    per_block = dispatch.residency("stream_tick", k, j)["streams_per_block"]
    runs = {}
    for w in (w for w in (1, 2, 4, 8) if per_block % w == 0):
        monkeypatch.setattr(st_ops, "warps_per_stream",
                            lambda *a, w=w, **kw: w)
        split = st_ops.SPLIT_LAUNCHES[name]
        out = entry(states, deltas, exact_smax=exact)
        copy = states.map_tensors(torch.clone)
        inp = entry(copy, deltas, exact_smax=exact, inplace=True)
        assert inp[1].strengths.data_ptr() == copy.strengths.data_ptr()
        assert st_ops.SPLIT_LAUNCHES[name] - split == (2 if w > 1 else 0)
        runs[w] = (_flat(out), _flat(inp))
    return runs


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(64, 4099, 37, 3), (16, 65536, 128, 8),
                                   (64, 1100, 8, 4), (64, 1100, 200, 4),
                                   (32, 4104, 1024, 8)])
def test_stream_tick_split_warps_bit_equal(cuda, shape, exact, monkeypatch):
    """Every W gives the W = 1 launch's bits, in place and out of place,
    on the stress rows (an emptying delta, a revive, joins and leaves,
    every lane gated off, a hub and a star) at an n that is not a
    multiple of 32·W, at the serving k, at the cells' k = 8 and with the
    shared-memory sort (k = 200, and k = 1024 at 4 warps a block)."""
    states, deltas = st_parity.make_case(*shape, seed=11, device=cuda,
                                         kind="stress")
    runs = _split_runs(monkeypatch, st_ops.stream_tick_fused, "stream_tick",
                       states, deltas, exact)
    want = runs[1][0]
    for w, outs in runs.items():
        for got in outs:
            for i, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b), (w, i)
    st_parity.compare((want[0], FingerState(*want[1:])),
                      stream_tick_ref(states, deltas, exact_smax=exact),
                      f"stream_tick {shape}")


def test_stream_tick_stacked_split_warps_bit_equal(cuda, monkeypatch):
    cases = [st_parity.make_case(32, 4099, 37, 3, seed=s, device=cuda,
                                 kind="stress") for s in range(3)]
    states = stack_states([c[0] for c in cases])
    deltas = stack_deltas([c[1] for c in cases])
    runs = _split_runs(monkeypatch, st_ops.stream_tick_fused_stacked,
                       "stream_tick_stacked", states, deltas, True)
    for w, outs in runs.items():
        for got in outs:
            assert all(torch.equal(a, b) for a, b in zip(got, runs[1][0])), w


def test_stream_tick_split_follows_the_shape(cuda):
    """Unforced, few long rows split and rows that fill the card do not;
    the split count moves only for the former."""
    capacity, per_block = st_ops._capacity(torch.cuda.current_device(), 8,
                                           2)
    assert per_block == 8
    for rows, n, split in ((64, 2048, 1), (capacity, 40, 0)):
        states, deltas = st_parity.make_case(rows, n, 8, 2, seed=2,
                                             device=cuda)
        before = dict(st_ops.SPLIT_LAUNCHES)
        launches = st_ops.LAUNCHES["stream_tick"]
        got = st_ops.stream_tick_fused(states, deltas, exact_smax=True)
        assert st_ops.LAUNCHES["stream_tick"] == launches + 1
        assert st_ops.SPLIT_LAUNCHES == {
            **before, "stream_tick": before["stream_tick"] + split}
        st_parity.compare(got, stream_tick_ref(states, deltas,
                                               exact_smax=True))


def test_stream_tick_residency(cuda):
    """At the serving size a block holds 8 streams and the card keeps at
    least 24 streams on an SM; the shared-memory sort holds fewer."""
    serving = dispatch.residency("stream_tick", 128, 8)
    assert serving["streams_per_block"] == 8
    assert serving["streams_per_sm"] >= 24
    big = dispatch.residency("stream_tick", 1024, 8)
    assert 1 <= big["streams_per_sm"] < serving["streams_per_sm"]
    assert st_ops.stream_tick_smem_bytes(1024, 8) > 48 * 1024


def test_stream_tick_refuses_too_much_shared_memory(cuda):
    states, deltas = st_parity.make_case(8, 40000, 9000, 2, seed=0,
                                         device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        st_ops.stream_tick_fused(states, deltas)


def _gated(state, delta):
    return gate_delta_for_update(state.node_mask, delta)[0]


@pytest.mark.parametrize("k", [1, 7, 37, 128, 129, 200, 1000, 1024, 5000,
                               8192, 9000])
def test_delta_stats_matches_plain(cuda, k, monkeypatch):
    """One launch from the gated delta: keys in registers up to k = 128,
    in the warp's shared memory above, up to k = 8192 (160 KB a block);
    k = 9000 takes the sorted-form route (torch's argsort, then the
    sorted-form kernel). Below the limit the sorted form is never
    built."""
    state, delta = ds_parity.make_case(4 * k + 64, k, seed=k, device=cuda)
    delta = _gated(state, delta)
    above = k > ds_ops.max_fused_k()
    assert ds_ops.max_fused_k() == 8192
    if not above:
        monkeypatch.setattr(ds_ops, "prepare_sorted_delta", None)
    before = ds_ops.LAUNCHES
    got = ds_ops.delta_stats_cuda(state.strengths, delta)
    assert ds_ops.LAUNCHES == before + 1
    ds_parity.compare(got, ds_parity.plain(state.strengths, delta),
                      f"delta_stats k={k}")
    again = ds_ops.delta_stats_cuda(state.strengths, delta)
    torch.testing.assert_close(got, again, atol=0, rtol=0)


@pytest.mark.parametrize("k", [64, 9000])
def test_delta_stats_all_masked_gives_minus_inf(cuda, k):
    state, delta = ds_parity.make_case(256, k, seed=1, device=cuda,
                                       all_masked=True)
    got = ds_ops.delta_stats_cuda(state.strengths,
                                  _gated(state, delta)).cpu().numpy()
    assert got[2] == -np.inf and got[3] == 0.0 and got[0] == 0.0


@pytest.mark.parametrize("kind", ds_parity.KINDS)
@pytest.mark.parametrize("k", [37, 128, 200, 1024])
def test_delta_stats_cases_gated_and_not(cuda, kind, k):
    """Each case kind, gated as update_state gates it and ungated (ids
    outside [0, n) then reach the kernel): the kernel against the plain
    version, two launches bit-equal."""
    state, delta = ds_parity.make_case(300, k, seed=k, device=cuda,
                                       kind=kind)
    for d in (_gated(state, delta), delta):
        got = ds_ops.delta_stats_cuda(state.strengths, d)
        ds_parity.compare(got, ds_parity.plain(state.strengths, d),
                          f"delta_stats {kind} k={k}")
        torch.testing.assert_close(
            got, ds_ops.delta_stats_cuda(state.strengths, d), atol=0,
            rtol=0)


@pytest.mark.parametrize("k", [40, 128, 1024, 9000])
@pytest.mark.parametrize("lead", [(3,), (2, 3), (37,)])
def test_delta_stats_leading_batch_axes(cuda, lead, k):
    """One warp a stream over the leading axes (37 streams: five blocks,
    the last one partly empty), the first stream all-masked; one launch
    a call on either route."""
    strengths, delta = ds_parity.stack_case(200, k, lead, seed=3,
                                            device=cuda)
    before = ds_ops.LAUNCHES
    got = ds_ops.delta_stats_cuda(strengths, delta)
    assert ds_ops.LAUNCHES == before + 1
    assert got.shape == (*lead, 4)
    ds_parity.compare(got, ds_parity.plain(strengths, delta),
                      f"delta_stats lead={lead} k={k}")
    assert got.reshape(-1, 4)[0, 2].item() == -np.inf


def test_delta_stats_refuses_by_name(cuda):
    state, delta = ds_parity.make_case(300, 16, seed=0, device=cuda)
    with pytest.raises(TypeError, match="senders"):
        ds_ops.delta_stats_cuda(state.strengths, dataclasses.replace(
            delta, senders=delta.senders.long()))
    with pytest.raises(TypeError, match="strengths"):
        ds_ops.delta_stats_cuda(state.strengths.double(), delta)
    with pytest.raises(ValueError, match="senders"):
        ds_ops.delta_stats_cuda(state.strengths[None], delta)
    with pytest.raises(ValueError, match="not contiguous"):
        ds_ops.delta_stats_cuda(state.strengths, dataclasses.replace(
            delta, dw=torch.stack([delta.dw, delta.dw], -1)[:, 0]))


def test_single_stream_fused_tick_runs_the_kernel(cuda):
    state, _ = ds_parity.make_case(300, 16, seed=2, device=cuda)
    deltas = stack_deltas([ds_parity.make_case(300, 16, seed=10 + t,
                                               device=cuda)[1]
                           for t in range(5)])
    before = ds_ops.LAUNCHES
    got, _ = jsdist_stream(state, deltas, exact_smax=True,
                           method="fused_tick")
    assert ds_ops.LAUNCHES == before + 10  # two updates per tick
    want, _ = jsdist_stream(state, deltas, exact_smax=True,
                            method="compact")
    np.testing.assert_allclose((got.double() ** 2).cpu().numpy(),
                               (want.double() ** 2).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(1000, 333, 777, 37, 3),
                                   (4096, 1024, 8192, 128, 8)])
def test_sparse_tick_matches_plain(cuda, shape, exact, inplace):
    """Two ticks (an emptying then a reviving one on row 0), the second
    on the kernel's own output; n_slots and m_pad not multiples of 32 in
    the first shape."""
    states, d1, d2 = sp_parity.make_case(*shape, seed=3, device=cuda)
    seen = []

    def tick(s, d, e):
        out = sp_ops.sparse_tick_fused(s, d, exact_smax=e, inplace=inplace)
        seen.append((float(out[1].s_total[0]),
                     float(out[1].edge_weights[0].abs().sum())))
        return out

    before = dict(sp_ops.LAUNCHES)
    sp_parity.check(tick, (states.map_tensors(torch.clone), d1, d2), exact,
                    f"sparse_tick {shape}")
    assert sp_ops.LAUNCHES == {**before,
                               "sparse_tick": before["sparse_tick"] + 2}
    assert seen[0] == (0.0, 0.0)  # row 0 emptied: S' and its store zero
    assert seen[1][0] > 0.0  # and revived


def test_sparse_tick_stacked_matches_plain(cuda):
    cases = [sp_parity.make_case(64, 200, 500, 16, 4, seed=s, device=cuda)
             for s in range(3)]
    states = stack_sparse_states([c[0] for c in cases])
    deltas = stack_deltas([c[1] for c in cases])
    before = dict(sp_ops.LAUNCHES)
    got = sp_ops.sparse_tick_fused_stacked(states, deltas, exact_smax=True)
    assert sp_ops.LAUNCHES == {
        **before, "sparse_tick_stacked": before["sparse_tick_stacked"] + 1}
    want = sparse_tick_ref(states, deltas, exact_smax=True)
    assert got[0].shape == (3, 64)
    sp_parity.compare(got, want, label="sparse_tick_stacked")


def test_sparse_tick_in_place_matches_out_of_place(cuda):
    states, d1, _ = sp_parity.make_case(512, 256, 1000, 32, 4, seed=5,
                                        device=cuda)
    want = sp_ops.sparse_tick_fused(states, d1, exact_smax=True)
    copy = states.map_tensors(torch.clone)
    got = sp_ops.sparse_tick_fused(copy, d1, exact_smax=True, inplace=True)
    assert got[1].edge_weights.data_ptr() == copy.edge_weights.data_ptr()
    for a, b in zip([got[0], *got[1].tensors().values()],
                    [want[0], *want[1].tensors().values()]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_sparse_tick_without_node_slots(cuda):
    states, d1, _ = sp_parity.make_case(256, 300, 700, 40, 2, seed=7,
                                        device=cuda)
    d1 = dataclasses.replace(d1, node_ids=None, node_flag=None)
    for exact in (False, True):
        sp_parity.compare(sp_ops.sparse_tick_fused(states, d1,
                                                   exact_smax=exact),
                          sparse_tick_ref(states, d1, exact_smax=exact),
                          "sparse_tick without node slots")


@pytest.mark.parametrize("label", list(sp_parity.STRESS))
def test_sparse_tick_stress_cases(cuda, label):
    """The stress rows over the slot axis with the edge store, two ticks
    (row 0 empties, then revives): the kernel against the plain version;
    then the first tick in place against out of place bit for bit, and
    two launches bit-equal."""
    states, d1, d2 = sp_parity.make_case(*sp_parity.STRESS[label], seed=5,
                                         device=cuda, kind="stress")
    for exact in (False, True):
        sp_parity.check(
            lambda s, d, e: sp_ops.sparse_tick_fused(s, d, exact_smax=e),
            (states, d1, d2), exact, label)
    got = sp_ops.sparse_tick_fused(states, d1, exact_smax=True)
    again = sp_ops.sparse_tick_fused(states, d1, exact_smax=True)
    inplace = sp_ops.sparse_tick_fused(states.map_tensors(torch.clone), d1,
                                       exact_smax=True, inplace=True)
    for other in (again, inplace):
        for a, b in zip([got[0], *got[1].tensors().values()],
                        [other[0], *other[1].tensors().values()]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_sparse_tick_refuses_too_much_shared_memory(cuda):
    states, d1, _ = sp_parity.make_case(8, 40000, 20000, 9000, 2, seed=0,
                                        device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sp_ops.sparse_tick_fused(states, d1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 40, 1000, 4099])
def test_vnge_q_matches_plain(cuda, n, masked):
    """n = 40 is the routing graph; 1000 and 4099 are ragged."""
    w, mask = vq_parity.make_case(n, seed=n, device=cuda, masked=masked)
    before = vq_ops.LAUNCHES
    got = vq_ops.vnge_q_stats(w, node_mask=mask)
    torch.cuda.synchronize()
    assert vq_ops.LAUNCHES == before + 1
    want = vnge_q_stats_ref(vq_ops._apply_node_mask(w, mask))
    vq_parity.compare(got, want, f"vnge_q n={n}")


def test_vnge_q_repeats_bit_for_bit_and_is_zero_when_empty(cuda):
    w, _ = vq_parity.make_case(3000, seed=1, device=cuda)
    a, b = vq_ops.vnge_q_stats(w), vq_ops.vnge_q_stats(w)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    zero = vq_ops.vnge_q_stats(torch.zeros((77, 77), device=cuda))
    assert zero.abs().max().item() == 0.0


def test_vnge_q_workspace_is_reused_and_bits_repeat(cuda):
    """Grid sizes up and down on one stream's cached workspace (the
    counter is reset by each launch): every result bit-equal to the
    first call at its n, and one launch a call."""
    ws = {n: vq_parity.make_case(n, seed=n, device=cuda)[0]
          for n in (129, 3000, 40, 8192)}
    first = {n: vq_ops.vnge_q_stats(w) for n, w in ws.items()}
    before = vq_ops.LAUNCHES
    for n in (3000, 40, 8192, 129, 3000, 8192):
        got = vq_ops.vnge_q_stats(ws[n])
        torch.testing.assert_close(got, first[n], atol=0, rtol=0)
        vq_parity.compare(got, vnge_q_stats_ref(ws[n]), f"vnge_q n={n}")
    assert vq_ops.LAUNCHES == before + 6
    stream = torch.cuda.current_stream().cuda_stream
    partial, counter = vq_ops._WORKSPACE[(cuda.index or 0, stream)]
    assert partial.shape[0] >= vq_ops._blocks(8192) > vq_ops._blocks(3000)
    assert counter.item() == 0


def test_vnge_q_on_two_streams(cuda):
    """Two side streams at once, each with its own workspace: the same
    bits as the default stream's call."""
    w, _ = vq_parity.make_case(4099, seed=5, device=cuda)
    want = vq_ops.vnge_q_stats(w)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append([vq_ops.vnge_q_stats(w) for _ in range(20)])
    torch.cuda.synchronize()
    for got in (o for batch in outs for o in batch):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    keys = {(cuda.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(vq_ops._WORKSPACE)


PROFILE_SCRIPT = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.incremental import gate_delta_for_update
from repro_torch.kernels.delta_stats import ops as ds_ops
from repro_torch.kernels.delta_stats import parity as ds_parity
from repro_torch.kernels.entropy_probe import ops as ep_ops
from repro_torch.kernels.entropy_probe import parity as ep_parity
from repro_torch.kernels.vnge_q import ops as vq_ops
from repro_torch.kernels.vnge_q import parity as vq_parity
dev = torch.device("cuda")
state, delta = ds_parity.make_case(1024, 128, seed=1, device=dev)
delta = gate_delta_for_update(state.node_mask, delta)[0]
ws = [vq_parity.make_case(n, seed=n, device=dev)[0] for n in (40, 8192)]
xs = [ep_parity.make_case(bh, s, seed=s, device=dev)
      for bh, s in ((192, 128), (8, 1024))]
ds_ops.delta_stats_fused(state, delta, pre_gated=True)
for w in ws:
    vq_ops.vnge_q_stats(w)
for x in xs:
    ep_ops.attention_graph_stats(x)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(10):
        ds_ops.delta_stats_fused(state, delta, pre_gated=True)
        for w in ws:
            vq_ops.vnge_q_stats(w)
        for x in xs:
            ep_ops.attention_graph_stats(x)
    torch.cuda.synchronize()
p.export_chrome_trace(sys.argv[1])
events = json.load(open(sys.argv[1]))["traceEvents"]
names = [e["name"] for e in events if e.get("ph") == "X"
         and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
print(json.dumps(names))
"""


def test_one_device_kernel_a_call(cuda, tmp_path):
    """torch.profiler, in a process of its own (a second session in one
    process records no device events): 10 calls of `delta_stats_fused`
    from the gated delta, 20 of `vnge_q_stats` (n = 40 and 8192) and 20
    of `attention_graph_stats` ((BH, S) = (192, 128) and (8, 1024)) run
    exactly 70 device operations, all kernels, no memset and no copy:
    10 of delta_stats, 20 of vnge_q, 20 of row_stats and 20 of
    graph_stats."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(dispatch.REPO_ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", PROFILE_SCRIPT, str(tmp_path / "trace.json")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 70, names
    assert sum("delta_stats" in n for n in names) == 10, names
    assert sum("vnge_q" in n for n in names) == 20, names
    assert sum("row_stats" in n for n in names) == 20, names
    assert sum("graph_stats" in n for n in names) == 20, names


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s", [(192, 128), (48, 1000), (3, 1),
                                  (5, 65), (8, 1024), (2, 1027), (2, 1500)])
def test_entropy_probe_kernels_match_plain(cuda, bh, s, causal):
    """(192, 128) is the training probe; 1000, 1, 65, 1027 and 1500 are
    ragged (65 and 1027 without 128-bit loads; rows above 1024 take the
    row stats' chunked online merge). The row stats are two views of one
    (2, BH, S) output; the graph stats are the closed (BH, 4)
    statistics."""
    x = ep_parity.make_case(bh, s, seed=s, device=cuda, causal=causal)
    before = dict(ep_ops.LAUNCHES)
    rows = ep_ops.row_stats_cuda(x)
    ep_parity.compare(rows, ep_ref.row_stats_ref(x), f"row_stats {s}")
    assert rows[1].data_ptr() == rows[0].data_ptr() + 4 * bh * s
    got = ep_ops.graph_stats_cuda(x, *rows)
    assert got.shape == (bh, 4)
    ep_parity.compare([got], [ep_ref.graph_stats_ref(x, *rows)],
                      f"graph_stats {s}")
    assert ep_ops.LAUNCHES == {k: v + 1 for k, v in before.items()}
    ep_parity.compare([ep_ops.attention_graph_stats(x)],
                      [ep_ref.attention_graph_stats_ref(x)],
                      f"attention_graph_stats {s}")


def test_entropy_probe_repeats_bit_for_bit(cuda):
    x = ep_parity.make_case(16, 300, seed=2, device=cuda)
    a = ep_ops.attention_graph_stats(x)
    b = ep_ops.attention_graph_stats(x)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_entropy_probe_workspace_is_reused_and_bits_repeat(cuda):
    """Shapes up and down on one stream's cached workspace (the per-head
    counters are reset by each launch): every result bit-equal to the
    first call at its shape, two launches and two allocations (the two
    outputs) a call."""
    xs = {shape: ep_parity.make_case(*shape, seed=shape[1], device=cuda)
          for shape in ((192, 128), (8, 1024), (5, 65), (48, 1000))}
    first = {k: ep_ops.attention_graph_stats(x) for k, x in xs.items()}
    before = dict(ep_ops.LAUNCHES)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    order = ((8, 1024), (5, 65), (192, 128), (48, 1000), (8, 1024))
    got = [ep_ops.attention_graph_stats(xs[k]) for k in order]
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs + 2 * len(order)
    assert ep_ops.LAUNCHES == {k: v + len(order) for k, v in before.items()}
    for k, g in zip(order, got):
        torch.testing.assert_close(g, first[k], atol=0, rtol=0)
        ep_parity.compare([g], [ep_ref.attention_graph_stats_ref(xs[k])],
                          f"attention_graph_stats {k}")
    stream = torch.cuda.current_stream().cuda_stream
    work, counter = ep_ops._WORKSPACE[(cuda.index or 0, stream)]
    assert work.numel() >= 192 * ep_ops._head_floats(128)
    assert work.numel() >= 48 * ep_ops._head_floats(1000)
    assert counter.numel() >= 192
    assert int(counter.abs().sum()) == 0


def test_entropy_probe_on_two_streams(cuda):
    """Two side streams at once, each with its own workspace and
    counters: the same bits as the default stream's call."""
    x = ep_parity.make_case(48, 1000, seed=5, device=cuda)
    want = ep_ops.attention_graph_stats(x)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append([ep_ops.attention_graph_stats(x) for _ in range(20)])
    torch.cuda.synchronize()
    for got in (o for batch in outs for o in batch):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    keys = {(cuda.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(ep_ops._WORKSPACE)


def test_entropy_probe_refuses_by_name(cuda):
    x = ep_parity.make_case(4, 64, seed=0, device=cuda)
    rm, dn = ep_ops.row_stats_cuda(x)
    with pytest.raises(TypeError, match="float32"):
        ep_ops.row_stats_cuda(x.double())
    with pytest.raises(ValueError, match="not contiguous"):
        ep_ops.row_stats_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="BH, S, S"):
        ep_ops.graph_stats_cuda(x[:, :32], rm, dn)
    with pytest.raises(ValueError, match="denom"):
        ep_ops.graph_stats_cuda(x, rm, dn[:2])


@pytest.mark.parametrize("label", list(bs_parity.CASES))
def test_bsr_matvec_matches_plain(cuda, label):
    """The phase-2 cases: ragged n, b = 64, max_bpr = 1, a stripe of
    padding only, and the large case."""
    n, b, kind = bs_parity.CASES[label]
    m, x = bs_parity.make_case(n, b, seed=2, device=cuda, kind=kind)
    before = dict(bs_ops.LAUNCHES)
    got = bs_ops.bsr_matvec(m, x)
    torch.cuda.synchronize()
    assert bs_ops.LAUNCHES == {"bsr_matvec": before["bsr_matvec"] + 1}
    bs_parity.compare(got, bsr_matvec_ref(m, x), label)


def test_bsr_matvec_repeats_bit_for_bit(cuda):
    m, x = bs_parity.make_case(4096, 128, seed=3, device=cuda)
    a, b = bs_ops.bsr_matvec(m, x), bs_ops.bsr_matvec(m, x)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bsr_matvec_uneven_counts_repeat_bit_for_bit(cuda):
    """Stripes of max_bpr, 1–3 and 0 real slots, launched longest first:
    two launches agree bit for bit, and with the plain version."""
    n, b, kind = bs_parity.CASES["uneven counts n=2000 b=64"]
    m, x = bs_parity.make_case(n, b, seed=6, device=cuda, kind=kind)
    counts = m.counts.tolist()
    assert counts[0] == m.col_ids.shape[1] and counts[-1] == 0
    a, b = bs_ops.bsr_matvec(m, x), bs_ops.bsr_matvec(m, x)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    bs_parity.compare(a, bsr_matvec_ref(m, x), "uneven counts")


def test_bsr_matvec_refuses_by_name(cuda):
    m, x = bs_parity.make_case(300, 128, seed=0, device=cuda)
    with pytest.raises(ValueError, match="b in"):
        bs_ops.bsr_matvec_cuda(m.values[:, :, :32, :32].contiguous(),
                               m.col_ids, m.counts, x[:96].contiguous())
    with pytest.raises(TypeError, match="float32"):
        bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x.double())
    with pytest.raises(ValueError, match="not contiguous"):
        bs_ops.bsr_matvec_cuda(m.values.transpose(2, 3), m.col_ids,
                               m.counts, x)
    with pytest.raises(TypeError, match="int32"):
        bs_ops.bsr_matvec_cuda(m.values, m.col_ids.long(), m.counts, x)
    with pytest.raises(TypeError, match="counts"):
        bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts.long(), x)
    with pytest.raises(ValueError, match="counts must lie"):
        bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts + 99, x)


def test_bsr_power_iteration_launches_and_matches_plain(cuda):
    m, _ = bs_parity.make_case(4096, 64, seed=4, device=cuda)
    before = bs_ops.LAUNCHES["bsr_matvec"]
    info = {}
    got = bs_ops.power_iteration_lmax_bsr(m, info=info)
    assert bs_ops.LAUNCHES["bsr_matvec"] - before == info["iterations"] + 2
    want = bs_ops.power_iteration_lmax_bsr(m.to("cpu"))
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=1e-5)
