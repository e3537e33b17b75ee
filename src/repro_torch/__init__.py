"""repro_torch: the PyTorch/CUDA port of the FINGER system.

A second package beside the JAX reference `repro`, with the same module
paths and public names. It imports torch and numpy only — never JAX and
never `repro`. Its entry points run on CUDA unless the caller passes
``device="cpu"``; on CUDA the serving ticks, the single-stream
Δ-statistics and the trainer's FINGER telemetry probes run hand-written
kernels (`repro_torch.kernels`), built from `csrc/` at first use.
"""
