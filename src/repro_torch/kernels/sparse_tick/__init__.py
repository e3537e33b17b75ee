"""The sparse slot-space serving tick: ``ref`` (plain version), ``ops``
(the wrapper of `csrc/sparse_tick.cu`) and ``parity`` (kernel-vs-plain
cases)."""
