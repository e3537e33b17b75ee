"""Hand-written CUDA kernels of the port, one package each.

- ``delta_stats`` : fused Theorem-2 ΔS/ΔQ/Δs_max over sorted endpoints
  (replaces `repro.kernels.delta_stats`);
- ``stream_tick`` : the whole batched serving tick in one launch
  (replaces `repro.kernels.stream_tick`).

Each package holds ``ref.py`` (the plain PyTorch version, used on CPU
tensors) and ``ops.py`` (the wrapper, which launches the kernel from
``src/repro_torch/csrc/`` on CUDA tensors and counts its ``LAUNCHES``).
`dispatch` builds and loads the kernels.
"""
