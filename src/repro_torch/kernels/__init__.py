"""Hand-written CUDA kernels of the port, one package each.

- ``delta_stats``   : fused Theorem-2 ΔS/ΔQ/Δs_max over sorted endpoints
  (replaces `repro.kernels.delta_stats`);
- ``stream_tick``   : the whole batched serving tick in one launch
  (replaces `repro.kernels.stream_tick`);
- ``sparse_tick``   : the same tick over the slot axis plus the edge-store
  scatter (replaces `repro.kernels.sparse_tick`);
- ``vnge_q``        : Lemma-1 statistics of a dense W in one pass
  (replaces `repro.kernels.vnge_q`);
- ``entropy_probe`` : attention-graph statistics from logits without
  writing softmax, row stats then graph stats (replaces
  `repro.kernels.entropy_probe`).

Each package holds ``ref.py`` (the plain PyTorch version, used on CPU
tensors), ``ops.py`` (the wrapper, which launches the kernel from
``src/repro_torch/csrc/`` on CUDA tensors and counts its ``LAUNCHES``)
and ``parity.py`` (its kernel-vs-plain cases for the card; `parity`
finds them and fails by name for a package without one). `dispatch`
builds and loads the kernels.
"""
