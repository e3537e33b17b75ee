"""Fused Theorem-2 delta statistics (see ops.py)."""
