"""granite-moe-3b-a800m [moe] — 40 experts, top-8, tiny expert FFNs.

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 40e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — the verified HF sibling
uses 32e top-8; the assignment specifies 40e top-8 which we follow
(`n_experts` is a config field either way).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    rope_theta=10000.0,
))
