"""Batched multi-stream FINGER engine of the port (see `stream`)."""
from repro_torch.engine.stream import (
    StreamEngine,
    stack_deltas,
    stack_states,
    unstack_states,
)

__all__ = ["StreamEngine", "stack_deltas", "stack_states",
           "unstack_states"]
