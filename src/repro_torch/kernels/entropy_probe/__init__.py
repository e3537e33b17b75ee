"""Attention-graph VNGE statistics without writing softmax (see ops.py)."""
