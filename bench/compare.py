"""The comparison that decides ``correct``.

The program's outputs (every tick's scores of the sampled streams, the
top-k of the judged ticks, the sampled streams' state once the window
has closed) are held against the plain reference (`bench.reference`).
The numbers, each against the limit the configuration file states:

- ``score_gap``: the widest |score − reference score| over the sampled
  streams and every recorded tick;
- ``state_gap``: the widest relative gap of the state: a sampled
  stream's strength row (against the reference's s_max), and the
  s_total of the streams whose scalars are checked (drawn from the
  seed: every stream, at most 65,536 and at most as many as hold 2^31
  edges, `harness.scalar_streams`);
- ``smax_gap``: the widest relative gap of those streams' s_max (the
  exact s_max the configuration guarantees);
- ``q_gap``: the widest |Q − reference Q| of those streams;
- ``mask_gap``: node-mask elements that differ (an exact comparison);
- ``topk_gap``: judged ticks whose top-k is not the stable descending
  top-k of that tick's served scores (an exact comparison);
- ``edge_gap`` (sparse_tick only): the widest gap of a sampled stream's
  edge store against the reference's weight of the same edge after the
  same ticks, relative to that stream's largest reference weight: every
  edge its slot map holds, every live edge of the reference (a store
  that lacks one holds 0 for it) and every slot that holds no edge
  (against 0);
- ``score_max`` and ``ref_score_max``: the largest score of the sampled
  streams, served and of the reference (readings, never compared).

A value that is not finite compares as infinitely far off.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

NUMBERS = ("score_gap", "state_gap", "smax_gap", "q_gap", "mask_gap",
           "topk_gap", "edge_gap")


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else float("inf")


def topk_gap(judged: Sequence, k: int) -> int:
    """Judged ticks ``(scores, values, ids)`` whose top-k is not the
    stable top-k of ``scores``."""
    bad = 0
    for scores, vals, ids in judged:
        want = np.argsort(-scores, kind="stable")[:k]
        if not (np.array_equal(ids, want)
                and np.array_equal(vals, scores[want])):
            bad += 1
    return bad


def gaps(ticks: np.ndarray, scores: np.ndarray, state: Dict[str, np.ndarray],
         refs: List[dict], final_tick: int, period: int,
         scalars=None) -> Dict[str, float]:
    """The numbers of the sampled streams: ``scores`` (ticks, streams) at
    global tick indices ``ticks``, ``state`` each field (streams, ·)
    after ``final_tick`` ticks, and ``refs`` one reference a stream
    (`reference.finger.cycle`); ``scalars``, if given, is ``(program,
    reference)``, each the q, s_total and s_max of the streams whose
    scalars are checked."""
    out = {"score_gap": 0.0, "state_gap": 0.0, "smax_gap": 0.0,
           "q_gap": 0.0, "mask_gap": 0.0}

    def rel(got, want):
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.abs(np.asarray(got, np.float64) - want) \
                / np.maximum(want, 1e-30)
        return _finite(np.max(r, initial=0.0))

    def widen(key, value):
        out[key] = max(out[key], value)

    if scalars is not None:
        got, want = scalars
        widen("state_gap", rel(got["s_total"], want["s_total"]))
        widen("smax_gap", rel(got["s_max"], want["s_max"]))
        widen("q_gap", _finite(np.max(np.abs(got["q"] - want["q"]),
                                      initial=0.0)))
    phase = ticks % period
    out["score_max"] = _finite(np.max(scores, initial=0.0))
    out["ref_score_max"] = max((float(r["scores"].max()) for r in refs),
                               default=0.0)
    for j, ref in enumerate(refs):
        if len(ticks):
            d = np.abs(scores[:, j].astype(np.float64)
                       - ref["scores"][phase]).max()
            widen("score_gap", _finite(d))
        want = ref["states"](final_tick % period)
        s_max = max(want["s_max"], 1e-30)
        widen("state_gap", max(
            _finite(np.abs(state["strengths"][j].astype(np.float64)
                           - want["strengths"]).max() / s_max),
            rel(state["s_total"][j], want["s_total"])))
        widen("smax_gap", rel(state["s_max"][j], want["s_max"]))
        widen("q_gap", _finite(abs(state["q"][j] - want["q"])))
        out["mask_gap"] += float(np.sum(state["node_mask"][j]
                                        != want["node_mask"]))
    return out


def edge_gap(stores: Sequence, refs: Sequence[dict]) -> float:
    """``edge_gap`` of the sampled streams: ``stores`` one ``(weights by
    (lo, hi), values of the slots that hold no edge)`` a stream, ``refs``
    the reference's weights by (lo, hi) (`reference.edges.weights`)."""
    out = 0.0
    for (got, free), want in zip(stores, refs):
        scale = max(max(want.values(), default=0.0), 1e-30)
        d = [abs(got.get(p, 0.0) - want.get(p, 0.0))
             for p in set(got) | set(want)]
        d.append(float(np.max(np.abs(free), initial=0.0)))
        out = max(out, _finite(max(d) / scale))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number that has a limit beside it (a number without one is a
    reading: no limit separates the program from the control there)."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in NUMBERS if k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
