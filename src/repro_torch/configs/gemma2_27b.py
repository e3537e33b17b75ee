"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16, head_dim=128) d_ff=36864 vocab=256000.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=4096,
    local_global_period=2,  # layer 2k: local SWA(4096); layer 2k+1: global
    rope_theta=10000.0,
    notes="GeGLU MLP; final-logit softcap 30, attention softcap 50.",
))
