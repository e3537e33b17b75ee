"""The port's fused serving tick against the JAX reference, on the CPU.

On CPU tensors `stream_tick_fused` runs its plain version, so these tests
hold the port's tick semantics to the reference:

- against the JAX `stream_tick_fused` and `stream_tick_fused_stacked` in
  Pallas interpret mode, on the fixture of
  `repro/kernels/stream_tick/parity.py` (B = 8, n_pad = 32, k_pad = 8;
  three shards for the stacked form);
- against the JAX `stream_tick_ref` on the port's edge-case batch
  (`repro_torch.kernels.stream_tick.parity.make_case`): mixed-n masks,
  padded lanes and join slots, repeated ids, join and leave of one node,
  an emptying delta, a revive, all-masked deltas — with every id inside
  the layout, since the reference clamps out-of-range ids where the
  port gates them (gating has its own test below).

Tolerance: atol 1e-5 with rtol 1e-5 on scores and carried state (the
reference's kernel parity tolerance), masks exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_tick import ops as jops
from repro.kernels.stream_tick.parity import _shard_fixture
from repro.kernels.stream_tick.ref import stream_tick_ref as jax_tick_ref
from repro_torch.engine import StreamEngine, stack_deltas
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.stream_tick import ops as tops
from repro_torch.kernels.stream_tick.parity import make_case
from _torch_parity import (assert_close, assert_state_close,
                           delta_to_jax, delta_to_port, state_to_jax,
                           state_to_port)


@pytest.mark.parametrize("exact", [False, True])
def test_matches_jax_fused_tick_on_reference_fixture(exact):
    states, stacked = _shard_fixture(4)
    jdist, jnew = jops.stream_tick_fused(states, stacked, exact_smax=exact,
                                         interpret=True)
    tdist, tnew = tops.stream_tick_fused(state_to_port(states),
                                         delta_to_port(stacked),
                                         exact_smax=exact)
    assert_close(tdist, jdist, "dist")
    assert_state_close(tnew, jnew)


def test_stacked_matches_jax_stacked_on_reference_fixture():
    shards = [_shard_fixture(s) for s in (4, 5, 6)]
    sstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[st for st, _ in shards])
    sdeltas = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[d for _, d in shards])
    jdist, jnew = jops.stream_tick_fused_stacked(
        sstates, sdeltas, exact_smax=True, interpret=True)
    tdist, tnew = tops.stream_tick_fused_stacked(
        state_to_port(sstates), delta_to_port(sdeltas), exact_smax=True)
    assert tdist.shape == (3, 8)
    assert_close(tdist, jdist, "dist")
    assert_state_close(tnew, jnew)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(12, 40, 8, 3), (9, 70, 13, 2)])
def test_edge_cases_match_jax_ref(shape, exact):
    tst, tdl = make_case(*shape, seed=sum(shape), device="cpu",
                         out_of_range=False)
    jdist, jnew = jax_tick_ref(state_to_jax(tst), delta_to_jax(tdl),
                               exact_smax=exact)
    tdist, tnew = tops.stream_tick_fused(tst, tdl, exact_smax=exact)
    assert_close(tdist, jdist, "dist")
    assert_state_close(tnew, jnew)
    # the named rows did what they are for
    assert float(tnew.s_total[0]) == 0.0 and float(tnew.q[0]) == 1.0
    assert float(tnew.s_total[1]) > 0.0
    assert float(tnew.s_total[3]) == 0.0 and float(tdist[3]) == 0.0
    assert float(tnew.node_mask[6, int(tst.node_mask[6].sum()) - 1]) == 0


def test_out_of_range_lanes_are_gated():
    tst, tdl = make_case(10, 40, 8, 2, seed=1, device="cpu")
    row = 4
    assert int(tdl.senders[row, 0]) < 0
    assert int(tdl.senders[row, 1]) >= 40
    clean = tdl.map_tensors(torch.clone)
    clean.mask[row, :2] = 0.0
    d_got, s_got = tops.stream_tick_fused(tst, tdl, exact_smax=True)
    d_want, s_want = tops.stream_tick_fused(tst, clean, exact_smax=True)
    torch.testing.assert_close(d_got, d_want, atol=0, rtol=0)
    torch.testing.assert_close(s_got.strengths, s_want.strengths,
                               atol=0, rtol=0)


def test_in_place_tick_writes_the_given_state():
    tst, tdl = make_case(8, 40, 8, 2, seed=2, device="cpu")
    d_want, s_want = tops.stream_tick_fused(tst, tdl, exact_smax=True)
    mine = tst.map_tensors(torch.clone)
    d_got, s_got = tops.stream_tick_fused(mine, tdl, exact_smax=True,
                                          inplace=True)
    assert s_got.strengths.data_ptr() == mine.strengths.data_ptr()
    for f, want in s_want.tensors().items():
        torch.testing.assert_close(getattr(mine, f), want, atol=0, rtol=0)


def test_maskless_and_larger_layout_states_raise():
    g = erdos_renyi(10, 0.3, seed=0, weighted=True)
    maskless = StreamEngine.init_states([g], device="cpu")
    maskless = dataclasses.replace(maskless, node_mask=None)
    d = stack_deltas([GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                             n_nodes=10)])
    with pytest.raises(ValueError, match="mask-aware"):
        tops.stream_tick_fused(maskless, d)
    padded = StreamEngine.init_states([g], n_pad=16, device="cpu")
    big = stack_deltas([GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                               n_nodes=10, n_pad=32)])
    with pytest.raises(ValueError, match="migrate the state"):
        tops.stream_tick_fused(padded, big)


@pytest.mark.parametrize("method", ["dense", "compact", "fused_tick"])
def test_engine_tick_and_run_match_per_stream_reference(method):
    """The port's engine against the JAX per-stream `jsdist_incremental`
    (the reference's own engine-vs-loop test fails at 1e-6 between two
    of its float32 paths; this holds the port at 1e-5)."""
    from repro.core import jsdist_incremental
    from repro.engine import stack_deltas as jstack

    states, stacked = _shard_fixture(5)
    eng = StreamEngine(exact_smax=True, method=method, device="cpu")
    tdist, tnew = eng.tick(state_to_port(states), delta_to_port(stacked))
    per = [jsdist_incremental(
        jax.tree_util.tree_map(lambda x: x[b], states),
        jax.tree_util.tree_map(lambda x: x[b], stacked),
        exact_smax=True) for b in range(8)]
    assert_close(tdist, np.array([float(d) for d, _ in per]), method)
    seq = jstack([stacked, stacked])
    t2, _ = eng.run(state_to_port(states), delta_to_port(seq))
    assert t2.shape == (2, 8)
    assert_close(t2[0], tdist, method)


# an H100 at the serving layouts: 4 blocks an SM × 132 SMs × 8 warps
H100_WARPS = 4 * 132 * 8


@pytest.mark.parametrize("rows, n, kw, want", [
    (524288, 12288, {}, 1),      # as-oregon: the rows fill the card
    (512, 262144, {}, 8),        # amazon-copurchase: 512 blocks of 8 warps
    (2048, 1024, {}, 2),         # 4 warps a stream would overflow it
    (H100_WARPS, 1 << 20, {}, 1),
    (1000, 1 << 20, {}, 4),      # 8 warps a stream would overflow the card
    (512, 512, {}, 4),           # too short a row for 8 whole row steps
    (512, 256, {}, 2),
    (512, 255, {}, 1),
    (512, 262144, {"warps_per_block": 4}, 4),  # a large-k layout
    (512, 262144, {"warps_per_block": 3}, 1),
    (H100_WARPS - 1, 1 << 20, {}, 1),  # below the card, yet no W fits
])
def test_warps_per_stream(rows, n, kw, want):
    """The tick kernel's warps a stream from the launch's shape alone:
    one where the rows fill the card's resident warps, else the most of
    2, 4 and 8 that still fit and leave each warp a whole row step."""
    assert tops.warps_per_stream(rows, n, H100_WARPS, **kw) == want
