"""Capacity migration of the sparse serving state.

The port's counterpart of the sparse part of `repro.serving.migrate`:

- ``grow_sparse_stacked`` embeds a stacked `SparseStreamState` into
  grown capacities on its device: the (B, n_slots) strengths and mask
  and the (B, m_pad) edge store are padded with inactive zeros, which
  is exact for every FINGER statistic. Slot ids are kept (growth only
  appends free slots to each `SlotMap`), so nothing is renumbered.
- ``embed_sparse_delta`` re-addresses a queued slot-space delta into
  the grown slot space: slot ids, and the edge-slot sentinel, are
  unchanged by a growth, so only the static size changes.

The dense migrations (repad, compact, truncate, the delta remaps and
the layout journal) are not yet ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sparse import SparseLayout, SparseStreamState
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfigError


class LayoutMigrationError(ServiceConfigError):
    """A layout migration would lose information (shrinking a
    capacity, shrinking the sparse virtual space)."""


def grow_sparse_stacked(states: SparseStreamState,
                        new_layout: SparseLayout) -> SparseStreamState:
    """A stacked `SparseStreamState` padded to grown capacities, on its
    own device (the stacked state never visits the host)."""
    old_n, old_m = states.n_slots, states.m_pad
    if new_layout.n_slots < old_n or new_layout.m_pad < old_m:
        raise LayoutMigrationError(
            f"grow_sparse_stacked: new capacities (n_slots="
            f"{new_layout.n_slots}, m_pad={new_layout.m_pad}) shrink "
            f"the current ({old_n}, {old_m}); sparse capacity only "
            "grows (freed slots are reused by the SlotMap, so there is "
            "nothing to compact)")
    dn, dm = new_layout.n_slots - old_n, new_layout.m_pad - old_m
    pad = torch.nn.functional.pad
    return SparseStreamState(
        q=states.q, s_total=states.s_total, s_max=states.s_max,
        strengths=pad(states.strengths, (0, dn)),
        node_mask=pad(states.node_mask, (0, dn)),
        edge_weights=pad(states.edge_weights, (0, dm)),
        layout=new_layout)


def embed_sparse_delta(delta: GraphDelta, new_n_slots: int) -> GraphDelta:
    """Re-address a slot-space delta into a grown slot capacity: only
    the static slot-space size changes (no tensor work)."""
    if new_n_slots < delta.n_nodes:
        raise LayoutMigrationError(
            f"embed_sparse_delta: new_n_slots={new_n_slots} < delta "
            f"slot space {delta.n_nodes}")
    return dataclasses.replace(delta, n_nodes=int(new_n_slots))
