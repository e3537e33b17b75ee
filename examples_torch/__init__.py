"""Twins of the examples under ``examples/`` on the PyTorch/CUDA port:
the same graphs, seeds and printed lines, on the card by default
(``--device cpu`` for the plain PyTorch path)."""
