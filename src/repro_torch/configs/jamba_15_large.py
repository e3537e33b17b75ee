"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Layer pattern: one attention layer per 8 (1:7 attn:mamba); MoE FFN every
other layer. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    attn_period=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    rope_theta=10000.0,
    notes="long_500k runnable: SSM layers O(1) state; the 9 attention "
          "layers keep a sequence-sharded KV cache (flash-decode).",
))
