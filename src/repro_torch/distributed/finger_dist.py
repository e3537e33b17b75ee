"""Distributed FINGER: edge-sharded Q, S, s_max and power iteration.

The port's counterpart of `repro.distributed.finger_dist`. The paper's
O(n + m) statistics are sums over nodes and edges, so they distribute
over an edge-sharded graph: each rank holds one shard of the edge list
(`shard_edge_list`), scatter-adds its partial strengths with
``index_add_`` and one `torch.distributed.all_reduce` completes them,
O(m/p + n) a rank. The power iteration's matvec shards the same way:
each rank adds its partial W·x and an all-reduce completes the product
(x is replicated on every rank, the 1D SpMV decomposition).

The reference runs the shards as devices of one program (``shard_map``
and ``psum``); the port runs one process a rank, as a PyTorch user runs
a graph no single card holds: NCCL on the card, gloo on the CPU. The
functions take this rank's shard and ``group`` (the default process
group when None) and run where the shard lies.

Two deliberate differences from the reference:

- the start vector of the power iteration is an explicit ``x0=`` or a
  draw of a seeded ``torch.Generator``, as in the port's serial
  `graphs.spectral.power_iteration_lmax` (JAX's threefry has no torch
  counterpart), and the loop is that function's `power_iterate`;
- `shard_edge_list` keeps the graph's node mask (replicated), so a
  masked graph gives the serial function's statistics.

``index_add_`` on CUDA adds in no fixed order, so results match the
serial functions within float32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.state import FingerState
from repro_torch.core.vnge import c_from_s_total
from repro_torch.graphs.spectral import power_iterate, start_vector
from repro_torch.graphs.types import EdgeList, in_range


def shard_edge_list(g: EdgeList, rank: int, world_size: int) -> EdgeList:
    """Rank ``rank``'s contiguous shard of ``g``'s edge arrays, on g's
    device: the arrays are padded (mask 0) to a multiple of
    ``world_size`` and cut into equal shards. The node mask, if any, is
    kept whole on every shard."""
    if not 0 <= rank < world_size:
        raise ValueError(f"shard_edge_list: rank {rank} outside a world "
                         f"of {world_size}")
    m = int(g.weights.shape[-1])
    per = -(-m // world_size)
    pad = per * world_size - m
    lo = rank * per

    def cut(x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (0, pad))[lo:lo + per].contiguous()

    return EdgeList(senders=cut(g.senders), receivers=cut(g.receivers),
                    weights=cut(g.weights), mask=cut(g.mask),
                    n_nodes=g.n_nodes, node_mask=g.node_mask)


def _endpoints(edges: EdgeList):
    """(masked weights, sender ids, receiver ids): lanes with an
    out-of-range endpoint carry weight 0 and index node 0."""
    n = edges.n_nodes
    ok = in_range(edges.senders, n) & in_range(edges.receivers, n)
    return (edges.masked_weights(),
            torch.where(ok, edges.senders, 0).long(),
            torch.where(ok, edges.receivers, 0).long())


def _partial_strengths(w, snd, rcv, n: int) -> torch.Tensor:
    s = torch.zeros(n, dtype=w.dtype, device=w.device)
    s.index_add_(0, snd, w)
    s.index_add_(0, rcv, w)
    return s


def distributed_finger_state(edges: EdgeList, group=None) -> FingerState:
    """`FingerState` of the graph whose edge shard this rank holds: one
    pass over the shard and one all-reduce of n + 1 floats (the partial
    strengths and Σ w²). Every rank gets the whole state."""
    n = edges.n_nodes
    w, snd, rcv = _endpoints(edges)
    buf = torch.empty(n + 1, dtype=w.dtype, device=w.device)
    buf[:n] = _partial_strengths(w, snd, rcv, n)
    buf[n] = (w * w).sum()
    dist.all_reduce(buf, group=group)
    s, sum_w2 = buf[:n], buf[n]
    if edges.node_mask is not None:
        s = s * edges.node_mask
    s_total = s.sum()
    c = c_from_s_total(s_total)
    q = 1.0 - c * c * ((s * s).sum() + 2.0 * sum_w2)
    return FingerState(q=q, s_total=s_total, s_max=s.amax(), strengths=s,
                       node_mask=edges.node_mask,
                       layout=edges.layout if edges.node_mask is not None
                       else None)


def distributed_power_iteration(edges: EdgeList, group=None,
                                num_iters: int = 100, tol: float = 1e-7,
                                seed: int = 0, x0=None,
                                info: Optional[dict] = None) -> torch.Tensor:
    """λ_max of L_N of the edge-sharded graph by power iteration: one
    all-reduce of the strengths and trace(L) before the loop, one of
    W·x a matvec. ``x0`` (replicated) or ``seed`` give the start vector
    as `power_iteration_lmax` draws it; ``info`` gets ``iterations`` and
    ``matvecs``. Every rank returns the same λ."""
    n = edges.n_nodes
    w, snd, rcv = _endpoints(edges)
    buf = torch.empty(n + 1, dtype=w.dtype, device=w.device)
    buf[:n] = _partial_strengths(w, snd, rcv, n)
    buf[n] = 2.0 * w.sum()
    dist.all_reduce(buf, group=group)
    s, s_total = buf[:n], buf[n]
    if edges.node_mask is not None:
        s = s * edges.node_mask
    c = torch.where(s_total > 0, 1.0 / s_total, 0.0)

    def ln_mv(x: torch.Tensor) -> torch.Tensor:
        wx = torch.zeros_like(x)
        wx.index_add_(0, snd, w * x[rcv])
        wx.index_add_(0, rcv, w * x[snd])
        dist.all_reduce(wx, group=group)
        return c * (s * x - wx)

    x = start_vector(n, seed, x0, w.device)
    return power_iterate(ln_mv, x, num_iters, tol, info)
