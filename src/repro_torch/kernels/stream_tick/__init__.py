"""The fused batched serving tick (see ops.py)."""
