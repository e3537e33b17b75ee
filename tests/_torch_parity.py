"""Shared helpers of the port's parity tests: feed one numpy input to
both packages and compare their results.

The JAX package is the reference. Values cross between the packages as
numpy arrays through `repro_torch.interop`. The tolerance is that of
`repro.kernels.parity.assert_close`, the reference's own kernel parity
checks: atol 1e-5 with rtol 1e-5, masks compared exactly.
"""
import jax.numpy as jnp
import numpy as np

from repro.core.state import FingerState
from repro.graphs.layout import NodeLayout
from repro.graphs.types import GraphDelta
from repro_torch import interop

ATOL = 1e-5
RTOL = 1e-5
STATE_FIELDS = ("q", "s_total", "s_max", "strengths")


def np_arrays(obj, fields):
    return {f: None if getattr(obj, f) is None else np.asarray(
        getattr(obj, f)) for f in fields}


def state_to_port(jst, device="cpu"):
    """A JAX FingerState (single or stacked) → the port's."""
    arrays = np_arrays(jst, STATE_FIELDS + ("node_mask",))
    if jst.layout is None:
        return interop.state_from_numpy(arrays, device=device)
    return interop.state_from_numpy(arrays, jst.layout.n_pad,
                                    jst.layout.generation, device=device)


def delta_to_port(jd, device="cpu"):
    """A JAX GraphDelta (single or stacked) → the port's."""
    arrays = np_arrays(jd, ("senders", "receivers", "dw", "w_old", "mask",
                            "node_ids", "node_flag"))
    return interop.delta_from_numpy(arrays, jd.n_nodes, device=device,
                                    layout_generation=jd.layout_generation)


def assert_state_close(port_state, jax_state, label=""):
    got, n_pad, gen = interop.state_to_numpy(port_state)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(
            got[f], np.asarray(getattr(jax_state, f)), atol=ATOL,
            rtol=RTOL, err_msg=f"{label}: {f}")
    if jax_state.node_mask is None:
        assert "node_mask" not in got, label
    else:
        np.testing.assert_array_equal(
            got["node_mask"], np.asarray(jax_state.node_mask),
            err_msg=f"{label}: node_mask")
    if jax_state.layout is None:
        assert n_pad is None, label
    else:
        assert (n_pad, gen) == (jax_state.layout.n_pad,
                                jax_state.layout.generation), label


def assert_close(got, want, label=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=label)


def state_to_jax(tst):
    """The port's FingerState → a JAX one (layout kept)."""
    arrays, n_pad, gen = interop.state_to_numpy(tst)
    return FingerState(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        layout=None if n_pad is None else NodeLayout(n_pad, gen))


def delta_to_jax(td):
    """The port's GraphDelta → a JAX one."""
    arrays = interop.delta_to_numpy(td)
    return GraphDelta(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      n_nodes=td.n_nodes,
                      layout_generation=td.layout_generation)
