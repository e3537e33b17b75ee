"""Carry state and deltas across packages as numpy arrays.

A `FingerState` crosses as a dict of numpy arrays (``q``, ``s_total``,
``s_max``, ``strengths`` and, for a mask-aware state, ``node_mask``)
plus its layout's ``n_pad`` and generation; a `SparseStreamState` as
the same dict plus ``edge_weights`` and its `SparseLayout`'s
``(n_slots, m_pad, generation)``; a `GraphDelta` as a dict of its
arrays (``edge_slots`` included when it has them) plus ``n_nodes``. A
`SlotMap` crosses as its JSON (`SlotMap.to_json` / `from_json`, the same
format in both packages). A `BsrMatrix` crosses as ``{"values",
"col_ids"}`` plus its ``(n, n_orig)``. Model parameters cross as a nested dict of
numpy arrays with the reference's keys (the JAX parameter pytree after
``np.asarray`` on each leaf), and an AdamW state as
``{"step", "mu", "nu"}`` of the same. A decode cache crosses as
nested dicts with the reference's keys: a `KVCache` as ``{"k", "v"}``,
an `SsmState` as ``{"s", "conv"}`` (whisper's cache is ``{"self",
"cross"}`` of KV dicts), each leaf in its own dtype (a bf16 leaf as an
``ml_dtypes`` bfloat16 array, the dtype JAX's ``np.asarray`` gives).
This is how the tests feed the JAX package's state, deltas, parameters,
optimizer state and caches into the port and the port's back, and it
imports nothing of either package beyond the port itself.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse import SparseLayout, SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.bsr_spmv.ref import BsrMatrix
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import SsmState
from repro_torch.models.params import map_tree
from repro_torch.optim.adamw import AdamWState

_INT_FIELDS = ("senders", "receivers", "node_ids", "edge_slots")


def _tensor(name: str, x, device: torch.device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     n_pad: Optional[int] = None, generation: int = 0,
                     device: Device = None) -> FingerState:
    """Dict of numpy arrays → FingerState on ``device`` (``None`` is
    CUDA). ``n_pad=None`` gives the legacy unmasked state (no layout)."""
    device = resolve_device(device)
    t = {k: _tensor(k, v, device) for k, v in arrays.items()
         if v is not None}
    layout = None if n_pad is None else NodeLayout(int(n_pad),
                                                   int(generation))
    return FingerState(q=t["q"], s_total=t["s_total"], s_max=t["s_max"],
                       strengths=t["strengths"],
                       node_mask=t.get("node_mask"), layout=layout)


def state_to_numpy(state: FingerState
                   ) -> Tuple[dict, Optional[int], int]:
    """FingerState → (dict of numpy arrays, n_pad, generation)."""
    arrays = {k: v.detach().cpu().numpy()
              for k, v in state.tensors().items()}
    if state.layout is None:
        return arrays, None, 0
    return arrays, state.layout.n_pad, state.layout.generation


def sparse_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            layout: Tuple[int, int, int],
                            device: Device = None) -> SparseStreamState:
    """Dict of numpy arrays (``q``, ``s_total``, ``s_max``,
    ``strengths``, ``node_mask``, ``edge_weights``) and the layout's
    ``(n_slots, m_pad, generation)`` → SparseStreamState on ``device``
    (``None`` is CUDA). Leading batch axes are kept."""
    device = resolve_device(device)
    t = {k: _tensor(k, v, device) for k, v in arrays.items()}
    return SparseStreamState(
        q=t["q"], s_total=t["s_total"], s_max=t["s_max"],
        strengths=t["strengths"], node_mask=t["node_mask"],
        edge_weights=t["edge_weights"],
        layout=SparseLayout(*(int(x) for x in layout)))


def sparse_state_to_numpy(state: SparseStreamState
                          ) -> Tuple[dict, Tuple[int, int, int]]:
    """SparseStreamState → (dict of numpy arrays, (n_slots, m_pad,
    generation))."""
    arrays = {k: v.detach().cpu().numpy()
              for k, v in state.tensors().items()}
    lay = state.layout
    return arrays, (lay.n_slots, lay.m_pad, lay.generation)


def delta_from_numpy(arrays: Mapping[str, np.ndarray], n_nodes: int,
                     device: Device = None,
                     layout_generation: Optional[int] = None
                     ) -> GraphDelta:
    """Dict of numpy arrays (``senders``, ``receivers``, ``dw``,
    ``w_old``, ``mask`` and optionally ``node_ids``/``node_flag`` and
    ``edge_slots``) → GraphDelta on ``device`` (``None`` is CUDA).
    Leading batch axes are kept."""
    device = resolve_device(device)
    t = {k: _tensor(k, v, device) for k, v in arrays.items()
         if v is not None}
    return GraphDelta(senders=t["senders"], receivers=t["receivers"],
                      dw=t["dw"], w_old=t["w_old"], mask=t["mask"],
                      n_nodes=int(n_nodes), node_ids=t.get("node_ids"),
                      node_flag=t.get("node_flag"),
                      layout_generation=layout_generation,
                      edge_slots=t.get("edge_slots"))


def delta_to_numpy(delta: GraphDelta) -> dict:
    """GraphDelta → dict of numpy arrays (``n_nodes`` not included)."""
    return {k: v.detach().cpu().numpy() for k, v in delta.tensors().items()}


def params_from_numpy(tree: Mapping, device: Device = None) -> dict:
    """Nested dict of numpy arrays (the JAX parameter pytree) → the
    port's nested dict of float32 tensors on ``device`` (``None`` is
    CUDA), with the same keys."""
    device = resolve_device(device)
    return map_tree(lambda x: torch.from_numpy(
        np.array(x, dtype=np.float32)).to(device), tree)


def params_to_numpy(params: Mapping) -> dict:
    """The port's parameters → nested dict of numpy arrays."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)


def opt_state_from_numpy(arrays: Mapping, device: Device = None
                         ) -> AdamWState:
    """``{"step": int32 (), "mu": tree, "nu": tree}`` of numpy arrays
    (the JAX `AdamWState`'s fields) → the port's `AdamWState`."""
    device = resolve_device(device)
    step = torch.from_numpy(np.array(arrays["step"], dtype=np.int32))
    return AdamWState(step=step.to(device),
                      mu=params_from_numpy(arrays["mu"], device),
                      nu=params_from_numpy(arrays["nu"], device))


def opt_state_to_numpy(state: AdamWState) -> dict:
    """The port's `AdamWState` → ``{"step", "mu", "nu"}`` of numpy."""
    return {"step": state.step.detach().cpu().numpy(),
            "mu": params_to_numpy(state.mu),
            "nu": params_to_numpy(state.nu)}


def bsr_from_numpy(arrays: Mapping[str, np.ndarray], n: int, n_orig: int,
                   device: Device = None) -> BsrMatrix:
    """``{"values": (n_rb, max_bpr, b, b), "col_ids": (n_rb, max_bpr)}``
    of numpy arrays (a reference `BsrMatrix`'s fields) → the port's
    `BsrMatrix` on ``device`` (``None`` is CUDA).

    The reference keeps no per-stripe count; ``counts`` is derived by its
    own keep rule: a slot is real if its block has ``abs().sum() > 0``
    (a padding slot has col 0 like a real block at column 0, so only the
    values tell them apart), and the real slots come first."""
    device = resolve_device(device)
    values = np.array(arrays["values"], np.float32)
    counts = (np.abs(values).sum(axis=(2, 3)) > 0).sum(axis=1)
    return BsrMatrix(
        values=torch.from_numpy(values).to(device),
        col_ids=torch.from_numpy(np.array(arrays["col_ids"], np.int32))
        .to(device),
        counts=torch.from_numpy(counts.astype(np.int32)).to(device),
        n=int(n), n_orig=int(n_orig))


def bsr_to_numpy(m: BsrMatrix) -> Tuple[dict, int, int]:
    """The port's `BsrMatrix` → (``{"values", "col_ids"}`` of numpy
    arrays, n, n_orig)."""
    return ({"values": m.values.detach().cpu().numpy(),
             "col_ids": m.col_ids.detach().cpu().numpy()}, m.n, m.n_orig)


def _leaf_from_numpy(x, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def cache_from_numpy(tree: Mapping, device: Device = None) -> dict:
    """A reference decode cache as nested dicts of numpy arrays (``{"k",
    "v"}`` → `KVCache`, ``{"s", "conv"}`` → `SsmState`) → the port's
    cache on ``device`` (``None`` is CUDA), every leaf's dtype kept."""
    device = resolve_device(device)

    def conv(node):
        if set(node) == {"k", "v"}:
            return KVCache(k=_leaf_from_numpy(node["k"], device),
                           v=_leaf_from_numpy(node["v"], device))
        if set(node) == {"s", "conv"}:
            return SsmState(s=_leaf_from_numpy(node["s"], device),
                            conv=_leaf_from_numpy(node["conv"], device))
        return {k: conv(v) for k, v in node.items()}

    return conv(tree)


def cache_to_numpy(cache: Mapping) -> dict:
    """The port's decode cache → nested dicts of numpy arrays with the
    reference's keys (`cache_from_numpy`'s inverse)."""
    def conv(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {f: _leaf_to_numpy(getattr(node, f))
                    for f in node._fields}
        return {k: conv(v) for k, v in node.items()}

    return conv(cache)
