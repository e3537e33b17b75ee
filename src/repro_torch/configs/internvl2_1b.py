"""internvl2-1b [vlm] — InternViT stub frontend + Qwen2-0.5B-family LM.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings prepended to the text tokens. [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1000000.0,
    frontend="vision_stub",
    n_frontend_tokens=256,  # one 448px tile -> 256 patch embeddings
    notes="14 heads not divisible by TP=16 -> attention heads replicated "
          "across the model axis (tiny attn; DESIGN.md §5).",
))
