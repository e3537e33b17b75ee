"""Block-sparse (ELL-of-blocks) SpMV for the λ_max power iteration (see
ops.py)."""
