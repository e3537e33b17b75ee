"""Fused Lemma-1 statistics of a dense W in one pass (see ops.py)."""
