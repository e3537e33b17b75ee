"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, MoE 128e
top-1. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_period=2,  # Maverick interleaves MoE/dense every other layer
    shared_expert=True,
    rope_theta=500000.0,
    notes="Source unverified; treated as full attention (long_500k skipped). "
          "40 heads padded to 48 for 16-way TP (DESIGN.md §5).",
))
