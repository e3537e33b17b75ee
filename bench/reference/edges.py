"""Plain reference of a stream's edge weights after some ticks of its
cycle, the weights that a sparse tick's edge store has to hold.

It makes the stream's graph again from the seed (`bench.graphs`) and
applies the deltas as `GraphDelta` documents them and as
`bench.reference.finger` applies them: joins first, then each live lane
whose two endpoints are live and inside the id space adds ``dw`` to its
edge (it never reads ``w_old``), then leaves. It imports nothing of the
program. ``dtype`` float64 is the reference; in bfloat16, the control,
every weight and every sum is rounded to it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bench import graphs


def weights(graph_spec: dict, seed: int, stream: int,
            deltas: Dict[str, np.ndarray], n_pad: int, ticks: int,
            dtype: torch.dtype = torch.float64
            ) -> Dict[Tuple[int, int], float]:
    """Every edge the stream has held by tick ``ticks`` of the cycle of
    ``deltas`` (each field (period, ·)), ``(lo, hi)`` to its weight then
    (0 for one deleted, or named by a lane that changed nothing)."""
    g = graphs.stream_graph(graph_spec, seed, stream)
    return weights_from(g["lo"], g["hi"], g["w"], g["n_live"], deltas, n_pad,
                        ticks, dtype)


def weights_from(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
                 n_live: int, deltas: Dict[str, np.ndarray], n_pad: int,
                 ticks: int, dtype: torch.dtype = torch.float64
                 ) -> Dict[Tuple[int, int], float]:
    """`weights` from an explicit graph: its edges ``lo < hi``, their
    float64 weights ``w`` and its first ``n_live`` live nodes."""
    def rnd(x):
        return torch.as_tensor(x, dtype=torch.float64).to(dtype).double()

    w = dict(zip(zip(lo.tolist(), hi.tolist()), rnd(w).tolist()))
    live = np.zeros(n_pad, bool)
    live[:n_live] = True
    for t in range(ticks):
        ids = deltas["node_ids"][t].astype(np.int64)
        flag = deltas["node_flag"][t]
        inside = (ids >= 0) & (ids < n_pad)
        live[ids[inside & (flag > 0)]] = True
        for a, b, dw, on in zip(deltas["senders"][t].tolist(),
                                deltas["receivers"][t].tolist(),
                                deltas["dw"][t].tolist(),
                                deltas["mask"][t].tolist()):
            if on > 0 and 0 <= min(a, b) and max(a, b) < n_pad \
                    and live[a] and live[b]:
                key = (min(a, b), max(a, b))
                w[key] = float(rnd(w.get(key, 0.0) + float(rnd(dw))))
        live[ids[inside & (flag < 0)]] = False
    return w
