"""The stress cases of the tick kernels' parity modules against the JAX
reference, on the CPU.

`kernels/stream_tick/parity.py` and `kernels/sparse_tick/parity.py`
build, with ``kind="stress"``, batches that stress how the CUDA tick
splits a stream over one warp: a hub whose segment spans all 2k
endpoints, a star across the lanes, joins and leaves on touched nodes,
all-masked rows without node slots beside live ones, an empty snap and
a revive, at k odd, at the serving k and above the keys a warp sorts in
registers. On CPU tensors the wrappers run their plain versions; these
tests hold those to the reference's `stream_tick_ref` /
`sparse_tick_ref` on the same numpy inputs (every id inside the layout,
since the reference clamps out-of-range ids where the port gates them),
at every shape the card runs. The card holds the kernels to the plain
versions on the same cases (`tests/test_torch_cuda_kernels.py`,
``chip_smoke.py`` phase 2).

Tolerance: atol 1e-5 with rtol 1e-5 on carried state and the edge store
(the reference's kernel parity tolerance), masks exactly, and the score
as a divergence (score²) at atol 1e-5 / rtol 1e-5: the score is the
square root of a divergence near 0 on a quiet stream, where the root
magnifies rounding.
"""
import numpy as np
import pytest
import torch

from repro.kernels.sparse_tick.ref import sparse_tick_ref as j_sparse_ref
from repro.kernels.stream_tick.ref import stream_tick_ref as j_stream_ref
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.sparse_tick import parity as sp_parity
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.kernels.stream_tick import parity as st_parity
from _torch_parity import (ATOL, RTOL, assert_state_close, delta_to_jax,
                           state_to_jax)
from test_torch_sparse import (assert_sparse_state_close,
                               sparse_delta_to_jax, sparse_state_to_jax)


def assert_divergence_close(got, want, label):
    np.testing.assert_allclose(np.asarray(got, np.float64) ** 2,
                               np.asarray(want, np.float64) ** 2,
                               atol=ATOL, rtol=RTOL,
                               err_msg=f"{label}: divergence")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("label", list(st_parity.STRESS))
def test_stream_tick_stress_matches_jax_ref(label, exact):
    shape = st_parity.STRESS[label]
    tst, tdl = st_parity.make_case(*shape, seed=11, device="cpu",
                                   out_of_range=False, kind="stress")
    jdist, jnew = j_stream_ref(state_to_jax(tst), delta_to_jax(tdl),
                               exact_smax=exact)
    tdist, tnew = st_ops.stream_tick_fused(tst, tdl, exact_smax=exact)
    assert_divergence_close(tdist, jdist, label)
    assert_state_close(tnew, jnew, label)
    # the stress rows did what they are for: the hub loop and the star
    # moved their hubs, the joiners of row 10 are live after the tick and
    # its leaver is not, the all-masked rows kept their state
    k, j = shape[2], shape[3]
    for row in (8, 9):
        hub = int(tdl.senders[row, 0])
        assert float(tnew.strengths[row, hub]) != float(tst.strengths[row,
                                                                      hub])
    joiner = int(tdl.node_ids[10, 0])
    assert float(tst.node_mask[10, joiner]) == 0.0
    assert float(tnew.node_mask[10, joiner]) == 1.0
    leaver = int(tdl.node_ids[10, min(j, 3) - 1])
    assert float(tnew.node_mask[10, leaver]) == 0.0
    for row in (11, 13):
        assert not bool(tdl.mask[row].any())
        assert torch.equal(tnew.strengths[row], tst.strengths[row] *
                           tst.node_mask[row])
    assert k == tdl.dw.shape[1]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("label", list(sp_parity.STRESS))
def test_sparse_tick_stress_matches_jax_ref(label, exact):
    """Both ticks of the case (row 0 empties, then revives)."""
    shape = sp_parity.STRESS[label]
    states, d1, d2 = sp_parity.make_case(*shape, seed=13, device="cpu",
                                         out_of_range=False, kind="stress")
    jstate = sparse_state_to_jax(states)
    for t, d in enumerate((d1, d2)):
        jdist, jnew = j_sparse_ref(jstate, sparse_delta_to_jax(d),
                                   exact_smax=exact)
        tdist, tnew = sp_ops.sparse_tick_fused(states, d, exact_smax=exact)
        assert_divergence_close(tdist, jdist, f"{label} tick {t}")
        assert_sparse_state_close(tnew, jnew, f"{label} tick {t}")
        if t == 0:
            assert float(tnew.s_total[0]) == 0.0
            assert not bool(tnew.edge_weights[0].any())
        states, jstate = tnew, jnew
    assert float(states.s_total[0]) > 0.0  # row 0 revived


def test_stress_kind_needs_sixteen_streams_and_names_its_kinds():
    with pytest.raises(ValueError, match="16 for the stress rows"):
        st_parity.make_case(8, 200, 16, 4, seed=0, device="cpu",
                            kind="stress")
    with pytest.raises(ValueError, match="unknown stream_tick case kind"):
        st_parity.make_case(8, 200, 16, 4, seed=0, device="cpu",
                            kind="hub")
