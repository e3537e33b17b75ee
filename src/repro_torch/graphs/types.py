"""Graph representations of the port: dataclasses of tensors.

The port's copy of `repro.graphs.types`, with the same semantics:

- ``DenseGraph`` : (n, n) symmetric weight matrix.
- ``EdgeList``   : padded COO with an explicit validity mask; each
  undirected edge (i, j), i < j, is stored once.
- ``GraphDelta`` : a padded set of undirected edge-weight changes plus
  optional node join/leave slots (Theorem 2's ΔG), and, once a
  `repro_torch.core.sparse.SlotMap` has translated it into slot space,
  the edge-store slot of each lane (``edge_slots``).
- ``apply_delta_dense`` : G ⊕ ΔG on the dense form (the oracle path).
- ``coalesce_edges`` : an edge list with duplicates summed, the form
  that Σ_E w² and the BSR layout need.

Node ids are int32 and weights float32 at the public surface, as in the
JAX package. Every field may carry leading batch axes: a stacked
(B, k_pad) delta is a `GraphDelta` whose tensors are (B, k_pad).

Mask-aware node layout: the node dimension is a layout size ``n_pad``
shared by a whole batch; the per-stream ``node_mask`` marks the live
slots, and inactive slots contribute exactly zero to every statistic.
Joins activate before a delta's edge changes, leaves deactivate after
them, and a leave requires the node to be isolated by then.

Out-of-range node ids. An id outside ``[0, n_pad)`` is gated off — it
never contributes and is never used to address memory (`take_nodes`,
`scatter_nodes`). The JAX package's scatters drop such ids and its
gathers clamp them; the port gates them in every path.

Host-side constructors (``from_arrays``, ``from_weights``) build CPU
tensors, as the JAX package builds host arrays; the engine and the
service move them to their device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.graphs.layout import NodeLayout
from repro_torch.kernels.dispatch import Device, resolve_device

F32 = torch.float32


def _drop_self_loops(senders: np.ndarray, receivers: np.ndarray,
                     *payloads: np.ndarray, kind: str):
    """Drop i == j slots host-side (Lemma 1 assumes a zero diagonal)."""
    loops = senders == receivers
    if not loops.any():
        return (senders, receivers, *payloads)
    warnings.warn(
        f"{kind}: dropping {int(loops.sum())} self-loop slot(s) "
        "(i == j); Lemma 1 assumes a zero diagonal",
        stacklevel=3,
    )
    keep = ~loops
    return (senders[keep], receivers[keep],
            *(p[keep] for p in payloads))


def in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Whether each node id lies in ``[0, n)`` (bool, ids' shape)."""
    return (ids >= 0) & (ids < n)


def take_nodes(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[..., ids]`` along the last axis, 0 where an id is out of range.

    ``ids`` carries the same leading axes as ``x``; the gather indexes
    with int64, as torch requires, and never with an out-of-range id.
    """
    n = x.shape[-1]
    ok = in_range(ids, n)
    idx = torch.where(ok, ids, 0).long()
    return torch.where(ok, torch.gather(x, -1, idx), 0.0).to(x.dtype)


def scatter_nodes(x: torch.Tensor, ids: torch.Tensor, src: torch.Tensor,
                  reduce: str = "sum") -> torch.Tensor:
    """Out-of-place ``x[..., ids] (+)= src`` along the last axis;
    out-of-range ids are dropped. ``reduce`` is ``sum``, ``amax`` or
    ``amin``."""
    n = x.shape[-1]
    ok = in_range(ids, n)
    idx = torch.where(ok, ids, 0).long()
    if reduce == "sum":
        return x.scatter_add(-1, idx, torch.where(ok, src, 0.0).to(x.dtype))
    # Dropped lanes write the target's own value at slot 0: a no-op for
    # amax/amin.
    own = torch.gather(x, -1, idx)
    return x.scatter_reduce(-1, idx, torch.where(ok, src.to(x.dtype), own),
                            reduce=reduce, include_self=True)


def on_device(obj, device: Device):
    """``obj`` (anything with ``.to``) moved to ``device``. ``None``
    leaves it where its tensors lie; ``cuda`` without a card raises
    (`resolve_device`). The offline entry points take their ``device=``
    through here."""
    if device is None:
        return obj
    return obj.to(resolve_device(device))


def _n_active(node_mask: Optional[torch.Tensor], lead, n: int,
              device) -> torch.Tensor:
    """Live node slots, int32 over the leading axes ``lead``: the layout
    size ``n`` where ``node_mask`` is None."""
    if node_mask is None:
        return torch.full(lead, n, dtype=torch.int32, device=device)
    return node_mask.sum(-1).to(torch.int32)


def _resolve_layout_args(n_nodes: int, n_pad, node_mask, layout, kind: str):
    resolved, mask = NodeLayout.resolve(n_nodes, n_pad, node_mask,
                                        layout=layout, kind=kind)
    if resolved is None:
        return int(n_nodes), None
    return resolved.n_pad, mask


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Symmetric dense weighted adjacency, ``weights[i, j] == weights[j, i]``.

    ``n_nodes`` is the layout size; ``node_mask`` (optional, (n,) 0/1)
    marks which slots hold real nodes.
    """

    weights: torch.Tensor  # (n, n), nonnegative, zero diagonal
    n_nodes: int
    node_mask: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.n_nodes

    @property
    def n_pad(self) -> int:
        return self.n_nodes

    @property
    def layout(self) -> NodeLayout:
        return NodeLayout(self.n_nodes)

    def n_active(self) -> torch.Tensor:
        """Live node slots (``n_nodes`` when unmasked), int32."""
        return _n_active(self.node_mask, self.weights.shape[:-2],
                         self.n_nodes, self.weights.device)

    def masked_weights(self) -> torch.Tensor:
        if self.node_mask is None:
            return self.weights
        m = self.node_mask.to(self.weights.dtype)
        return self.weights * m[..., :, None] * m[..., None, :]

    def strengths(self) -> torch.Tensor:
        return self.masked_weights().sum(-1)

    def to(self, device) -> "DenseGraph":
        return DenseGraph(
            weights=self.weights.to(device), n_nodes=self.n_nodes,
            node_mask=None if self.node_mask is None
            else self.node_mask.to(device))

    def pad_to(self, n_pad: Union[int, NodeLayout]) -> "DenseGraph":
        """Embed into an n_pad layout; new slots are inactive."""
        layout = n_pad if isinstance(n_pad, NodeLayout) \
            else NodeLayout(int(n_pad))
        n = self.n_nodes
        if layout.n_pad < n:
            raise ValueError(f"pad_to: n_pad={layout.n_pad} < n_nodes={n}")
        mask = layout.embed_mask(self.node_mask, n, self.weights.dtype,
                                 self.weights.device)
        extra = layout.n_pad - n
        w = torch.nn.functional.pad(self.weights, (0, extra, 0, extra))
        return DenseGraph(weights=w, n_nodes=layout.n_pad, node_mask=mask)

    @staticmethod
    def from_weights(w, n_pad: Optional[int] = None, node_mask=None,
                     layout: Optional[NodeLayout] = None) -> "DenseGraph":
        w = torch.as_tensor(w, dtype=F32)
        n = w.shape[0]
        w = 0.5 * (w + w.T)
        w = w * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))
        if n_pad is None and node_mask is None and layout is None:
            return DenseGraph(weights=w, n_nodes=n)
        n_layout, node_mask = _resolve_layout_args(
            n, n_pad, node_mask, layout, kind="DenseGraph.from_weights")
        node_mask = node_mask.to(w.dtype).to(w.device)
        extra = n_layout - n
        w = torch.nn.functional.pad(w, (0, extra, 0, extra))
        w = w * node_mask[:, None] * node_mask[None, :]
        return DenseGraph(weights=w, n_nodes=n_layout, node_mask=node_mask)


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Padded undirected edge list; padding slots have mask 0."""

    senders: torch.Tensor  # (..., m_pad) int32
    receivers: torch.Tensor  # (..., m_pad) int32
    weights: torch.Tensor  # (..., m_pad) float32
    mask: torch.Tensor  # (..., m_pad) float32 0/1
    n_nodes: int
    node_mask: Optional[torch.Tensor] = None  # (..., n) 0/1

    @property
    def n(self) -> int:
        return self.n_nodes

    @property
    def n_pad(self) -> int:
        return self.n_nodes

    @property
    def layout(self) -> NodeLayout:
        return NodeLayout(self.n_nodes)

    @property
    def m_pad(self) -> int:
        return int(self.senders.shape[-1])

    def n_active(self) -> torch.Tensor:
        """Live node slots (``n_nodes`` when unmasked), int32."""
        return _n_active(self.node_mask, self.senders.shape[:-1],
                         self.n_nodes, self.senders.device)

    def n_edges(self) -> torch.Tensor:
        """Valid edge slots, int32."""
        return self.mask.sum(-1).to(torch.int32)

    def masked_weights(self) -> torch.Tensor:
        """Edge weights, zero on padding and on edges touching an
        inactive or out-of-range node."""
        w = self.weights * self.mask
        ok = in_range(self.senders, self.n_nodes) \
            & in_range(self.receivers, self.n_nodes)
        w = torch.where(ok, w, 0.0)
        if self.node_mask is not None:
            nm = self.node_mask
            w = w * take_nodes(nm, self.senders) \
                * take_nodes(nm, self.receivers)
        return w

    def strengths(self) -> torch.Tensor:
        w = self.masked_weights()
        lead = self.senders.shape[:-1]
        s = torch.zeros((*lead, self.n_nodes), dtype=w.dtype,
                        device=w.device)
        s = scatter_nodes(s, self.senders, w)
        s = scatter_nodes(s, self.receivers, w)
        if self.node_mask is not None:
            s = s * self.node_mask
        return s

    def to(self, device) -> "EdgeList":
        return EdgeList(
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            weights=self.weights.to(device), mask=self.mask.to(device),
            n_nodes=self.n_nodes,
            node_mask=None if self.node_mask is None
            else self.node_mask.to(device))

    def pad_to(self, n_pad: Union[int, NodeLayout]) -> "EdgeList":
        """Embed into an n_pad layout (edge arrays unchanged); new slots
        are inactive."""
        layout = n_pad if isinstance(n_pad, NodeLayout) \
            else NodeLayout(int(n_pad))
        n = self.n_nodes
        if layout.n_pad < n:
            raise ValueError(f"pad_to: n_pad={layout.n_pad} < n_nodes={n}")
        mask = layout.embed_mask(self.node_mask, n, self.weights.dtype,
                                 self.weights.device)
        return dataclasses.replace(self, n_nodes=layout.n_pad,
                                   node_mask=mask)

    def to_dense(self) -> DenseGraph:
        """Single-graph (unbatched) dense view."""
        w = self.masked_weights()
        n = self.n_nodes
        ok = in_range(self.senders, n) & in_range(self.receivers, n)
        s = torch.where(ok, self.senders, 0).long()
        r = torch.where(ok, self.receivers, 0).long()
        a = torch.zeros((n, n), dtype=w.dtype, device=w.device)
        a.index_put_((s, r), w, accumulate=True)
        a.index_put_((r, s), w, accumulate=True)
        return DenseGraph(weights=a, n_nodes=n, node_mask=self.node_mask)

    @staticmethod
    def from_dense(g: DenseGraph, m_pad: Optional[int] = None) -> "EdgeList":
        """Host-side conversion of one dense graph: its nonzero upper
        triangle in row-major order, padded to ``m_pad``; CPU tensors."""
        w = g.masked_weights().detach().cpu().numpy()
        iu, ju = np.triu_indices(g.n_nodes, k=1)
        nz = w[iu, ju] != 0.0
        node_mask = None if g.node_mask is None else g.node_mask.cpu()
        return EdgeList.from_arrays(iu[nz], ju[nz], w[iu, ju][nz],
                                    g.n_nodes, m_pad=m_pad,
                                    node_mask=node_mask)

    @staticmethod
    def from_arrays(senders, receivers, weights, n_nodes: int,
                    m_pad: Optional[int] = None,
                    n_pad: Optional[int] = None, node_mask=None,
                    layout: Optional[NodeLayout] = None) -> "EdgeList":
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        weights = np.asarray(weights, np.float32)
        senders, receivers, weights = _drop_self_loops(
            senders, receivers, weights, kind="EdgeList.from_arrays")
        lo = np.minimum(senders, receivers)
        hi = np.maximum(senders, receivers)
        m = len(lo)
        if m_pad is None:
            m_pad = max(m, 1)
        if m > m_pad:
            raise ValueError(f"m={m} exceeds m_pad={m_pad}")
        pad = m_pad - m
        n_layout, node_mask = _resolve_layout_args(
            n_nodes, n_pad, node_mask, layout, kind="EdgeList.from_arrays")
        zi = np.zeros(pad, np.int32)
        zf = np.zeros(pad, np.float32)
        return EdgeList(
            senders=torch.from_numpy(np.concatenate([lo, zi])),
            receivers=torch.from_numpy(np.concatenate([hi, zi])),
            weights=torch.from_numpy(np.concatenate([weights, zf])),
            mask=torch.from_numpy(np.concatenate(
                [np.ones(m, np.float32), zf])),
            n_nodes=n_layout, node_mask=node_mask)


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """Padded set of undirected edge-weight deltas (Theorem 2's ΔG).

    ``dw[k]`` is the signed change of edge (senders[k], receivers[k]);
    ``w_old[k]`` its weight before the delta (0 for additions). Node
    joins/leaves ride in the optional ``node_ids``/``node_flag`` slots
    (+1 join, -1 leave, 0 padding). ``layout_generation`` names the
    migration generation of the layout the delta is addressed in
    (None = unstamped). ``edge_slots`` is the sparse path's edge-store
    addressing: for a delta translated into slot space, the slot of
    each lane in the stream's (m_pad,) edge-weight store
    (`EDGE_SLOT_SENTINEL` on padding and dropped lanes); dense-path
    deltas leave it None.
    """

    senders: torch.Tensor  # (..., k_pad) int32
    receivers: torch.Tensor  # (..., k_pad) int32
    dw: torch.Tensor  # (..., k_pad) float32
    w_old: torch.Tensor  # (..., k_pad) float32
    mask: torch.Tensor  # (..., k_pad) float32 0/1
    n_nodes: int
    node_ids: Optional[torch.Tensor] = None  # (..., j_pad) int32
    node_flag: Optional[torch.Tensor] = None  # (..., j_pad) float32
    layout_generation: Optional[int] = None
    edge_slots: Optional[torch.Tensor] = None  # (..., k_pad) int32

    @property
    def n(self) -> int:
        return self.n_nodes

    @property
    def n_pad(self) -> int:
        return self.n_nodes

    @property
    def layout(self) -> NodeLayout:
        """The layout the delta is addressed in (generation 0 when
        unstamped)."""
        return NodeLayout(self.n_nodes,
                          generation=self.layout_generation or 0)

    @property
    def has_node_slots(self) -> bool:
        return self.node_ids is not None

    def delta_strengths(self, n: Optional[int] = None) -> torch.Tensor:
        """Δs_i for all n nodes (zero off ΔV; ids outside [0, n)
        dropped)."""
        n = self.n_nodes if n is None else int(n)
        dwm = self.dw * self.mask
        ds = torch.zeros((*dwm.shape[:-1], n), dtype=dwm.dtype,
                         device=dwm.device)
        ds = scatter_nodes(ds, self.senders, dwm)
        return scatter_nodes(ds, self.receivers, dwm)

    def delta_s_total(self) -> torch.Tensor:
        """ΔS = Σ_i Δs_i = 2 Σ_E Δw."""
        return 2.0 * (self.dw * self.mask).sum(-1)

    def tensors(self) -> dict:
        """The tensor fields by name (absent node and edge slots left
        out)."""
        out = {f: getattr(self, f) for f in
               ("senders", "receivers", "dw", "w_old", "mask")}
        if self.node_ids is not None:
            out["node_ids"] = self.node_ids
            out["node_flag"] = self.node_flag
        if self.edge_slots is not None:
            out["edge_slots"] = self.edge_slots
        return out

    def map_tensors(self, fn) -> "GraphDelta":
        """A copy with ``fn`` applied to every tensor field."""
        return dataclasses.replace(
            self, **{k: fn(v) for k, v in self.tensors().items()})

    def to(self, device) -> "GraphDelta":
        return self.map_tensors(lambda t: t.to(device))

    def scaled(self, factor: float) -> "GraphDelta":
        """ΔG/2 for Algorithm 2: joins are kept (a joining node exists
        in Ḡ), leaves dropped (a leaving node is still in Ḡ)."""
        flag = self.node_flag
        if flag is not None:
            flag = torch.clamp(flag, min=0.0)
        return dataclasses.replace(self, dw=self.dw * factor,
                                   node_flag=flag)

    @staticmethod
    def from_arrays(senders, receivers, dw, w_old, n_nodes: int,
                    k_pad: Optional[int] = None,
                    n_pad: Optional[int] = None,
                    join=(), leave=(),
                    j_pad: Optional[int] = None,
                    layout: Optional[NodeLayout] = None) -> "GraphDelta":
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        dw = np.asarray(dw, np.float32)
        w_old = np.asarray(w_old, np.float32)
        senders, receivers, dw, w_old = _drop_self_loops(
            senders, receivers, dw, w_old, kind="GraphDelta.from_arrays")
        lo = np.minimum(senders, receivers)
        hi = np.maximum(senders, receivers)
        k = len(lo)
        if k_pad is None:
            k_pad = max(k, 1)
        if k > k_pad:
            raise ValueError(f"k={k} delta edges exceed k_pad={k_pad}")
        pad = k_pad - k
        z = np.zeros(pad, np.float32)
        if layout is not None:
            if n_pad is not None and int(n_pad) != layout.n_pad:
                raise ValueError(
                    f"GraphDelta.from_arrays: n_pad={n_pad} conflicts "
                    f"with layout.n_pad={layout.n_pad}")
            n_pad = layout.n_pad
        n_layout = int(n_nodes) if n_pad is None else int(n_pad)
        if n_layout < n_nodes:
            raise ValueError(
                f"GraphDelta.from_arrays: n_pad={n_layout} < "
                f"n_nodes={n_nodes}")
        node_ids = node_flag = None
        join = np.asarray(join, np.int32).ravel()
        leave = np.asarray(leave, np.int32).ravel()
        for name, ids in (("join", join), ("leave", leave)):
            if ids.size and (ids.min() < 0 or ids.max() >= n_layout):
                bad = sorted(set(int(i) for i in ids
                                 if i < 0 or i >= n_layout))
                raise ValueError(
                    f"GraphDelta.from_arrays: {name} node id(s) {bad} "
                    f"outside the n_pad={n_layout} layout; re-pad the "
                    "stream to a larger n_pad to grow past it")
        if join.size or leave.size or j_pad is not None:
            j = int(join.size + leave.size)
            if j_pad is None:
                j_pad = max(j, 1)
            if j > j_pad:
                raise ValueError(
                    f"{j} node join/leave slots exceed j_pad={j_pad}")
            jpad = j_pad - j
            node_ids = torch.from_numpy(np.concatenate(
                [join, leave, np.zeros(jpad, np.int32)]))
            node_flag = torch.from_numpy(np.concatenate(
                [np.ones(join.size, np.float32),
                 -np.ones(leave.size, np.float32),
                 np.zeros(jpad, np.float32)]))
        zi = np.zeros(pad, np.int32)
        return GraphDelta(
            senders=torch.from_numpy(np.concatenate([lo, zi])),
            receivers=torch.from_numpy(np.concatenate([hi, zi])),
            dw=torch.from_numpy(np.concatenate([dw, z])),
            w_old=torch.from_numpy(np.concatenate([w_old, z])),
            mask=torch.from_numpy(np.concatenate(
                [np.ones(k, np.float32), z])),
            n_nodes=n_layout, node_ids=node_ids, node_flag=node_flag,
            layout_generation=None if layout is None else layout.generation,
        )


def node_mask_after_joins(node_mask: torch.Tensor,
                          delta: GraphDelta) -> torch.Tensor:
    """Activate the delta's join slots (flag > 0)."""
    join = (delta.node_flag > 0).to(node_mask.dtype)
    return scatter_nodes(node_mask, delta.node_ids, join, reduce="amax")


def node_mask_after_leaves(node_mask: torch.Tensor,
                           delta: GraphDelta) -> torch.Tensor:
    """Deactivate the delta's leave slots (flag < 0)."""
    stay = 1.0 - (delta.node_flag < 0).to(node_mask.dtype)
    return scatter_nodes(node_mask, delta.node_ids, stay, reduce="amin")


def gate_delta_by_nodes(delta: GraphDelta,
                        node_mask: torch.Tensor) -> GraphDelta:
    """Zero the validity of delta edges touching an inactive (or
    out-of-range) node; ``node_mask`` is the post-join mask."""
    gate = take_nodes(node_mask, delta.senders) \
        * take_nodes(node_mask, delta.receivers)
    return dataclasses.replace(delta,
                               mask=delta.mask * gate.to(delta.mask.dtype))


def apply_delta_dense(g: DenseGraph, delta: GraphDelta) -> DenseGraph:
    """G' = G ⊕ ΔG on one dense graph (the oracle path).

    Joins activate before the edge changes, edges are gated by the
    post-join mask (and by the layout: an out-of-range endpoint adds
    nothing), leaves deactivate after them and zero the left nodes' rows
    and columns.
    """
    has_slots = delta.node_ids is not None
    mask = g.node_mask
    if has_slots and mask is None:
        mask = torch.ones((g.n_nodes,), dtype=g.weights.dtype,
                          device=g.weights.device)
    if has_slots:
        mask = node_mask_after_joins(mask, delta)
    if mask is not None:
        delta = gate_delta_by_nodes(delta, mask)
    n = g.n_nodes
    ok = in_range(delta.senders, n) & in_range(delta.receivers, n)
    s = torch.where(ok, delta.senders, 0).long()
    r = torch.where(ok, delta.receivers, 0).long()
    dwm = torch.where(ok, delta.dw * delta.mask, 0.0).to(g.weights.dtype)
    w = g.weights.clone()
    w.index_put_((s, r), dwm, accumulate=True)
    w.index_put_((r, s), dwm, accumulate=True)
    if has_slots:
        mask = node_mask_after_leaves(mask, delta)
    if mask is not None:
        w = w * mask[:, None] * mask[None, :]
    return DenseGraph(weights=w, n_nodes=n, node_mask=mask)


def coalesce_edges(senders: torch.Tensor, receivers: torch.Tensor,
                   weights: torch.Tensor, n: int):
    """One (lo, hi, w) entry per undirected edge, lo < hi, in ascending
    (lo, hi) order, on the inputs' device.

    Duplicate (i, j) lanes are summed in lane order, lanes that are self
    loops or touch an id outside ``[0, n)`` are dropped, and so are
    edges whose summed weight is 0. This is the physical merge that
    Σ_E w² needs (duplicates only sum correctly in the strengths) and
    the input form of `kernels.bsr_spmv.edges_to_bsr`.
    """
    s = senders.long()
    r = receivers.long()
    w = weights.to(F32)
    keep = in_range(s, n) & in_range(r, n) & (s != r) & (w != 0)
    lo = torch.minimum(s, r)[keep]
    hi = torch.maximum(s, r)[keep]
    key, inv = torch.unique(lo * n + hi, sorted=True, return_inverse=True)
    total = torch.zeros(key.shape, dtype=F32, device=w.device)
    total.index_add_(0, inv, w[keep])
    live = total != 0
    key = key[live]
    return ((key // n).to(torch.int32), (key % n).to(torch.int32),
            total[live])
