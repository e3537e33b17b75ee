"""Hand-written CUDA kernels of the port, one package each.

- ``delta_stats``   : fused Theorem-2 ΔS/ΔQ/Δs_max of one update from the
  gated delta, the endpoint sort in the kernel (replaces
  `repro.kernels.delta_stats`);
- ``stream_tick``   : the whole batched serving tick in one launch
  (replaces `repro.kernels.stream_tick`);
- ``sparse_tick``   : the same tick over the slot axis plus the edge-store
  scatter (replaces `repro.kernels.sparse_tick`);
- ``vnge_q``        : Lemma-1 statistics of a dense W in one pass
  (replaces `repro.kernels.vnge_q`);
- ``entropy_probe`` : attention-graph statistics from logits without
  writing softmax, row stats then graph stats (replaces
  `repro.kernels.entropy_probe`);
- ``bsr_spmv``      : block-sparse W x for the λ_max power iteration
  behind FINGER-Ĥ (replaces `repro.kernels.bsr_spmv`).

Each package holds ``ref.py`` (the plain PyTorch version, used on CPU
tensors), ``ops.py`` (the wrapper, which launches the kernel from
``src/repro_torch/csrc/`` on CUDA tensors and counts its ``LAUNCHES``)
and ``parity.py`` (its kernel-vs-plain cases for the card; `parity`
finds them and fails by name for a package without one). `dispatch`
builds and loads the kernels.

The public ops are exported here as in the reference, resolved at first
access: the graph and core modules import `dispatch` from this package,
and the ops import them in turn.
"""
import importlib

_EXPORTS = {
    "BsrMatrix": "bsr_spmv.ops", "bsr_matvec": "bsr_spmv.ops",
    "dense_to_bsr": "bsr_spmv.ops", "edges_to_bsr": "bsr_spmv.ops",
    "power_iteration_lmax_bsr": "bsr_spmv.ops",
    "attention_graph_entropy": "entropy_probe.ops",
    "attention_graph_stats": "entropy_probe.ops",
    "delta_stats_fused": "delta_stats.ops",
    "prepare_sorted_delta": "delta_stats.ops",
    "stream_tick_fused": "stream_tick.ops",
    "quadratic_q_dense": "vnge_q.ops", "vnge_q_stats": "vnge_q.ops",
    "vnge_tilde_dense": "vnge_q.ops",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
