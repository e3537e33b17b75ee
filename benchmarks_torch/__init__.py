"""Twins of the paper scripts under ``benchmarks/`` on the PyTorch/CUDA
port: the same rows under the same names, on the card by default.

    PYTHONPATH=src python -m benchmarks_torch.run [--only fig1,table2]
        [--device cuda|cpu]
"""
