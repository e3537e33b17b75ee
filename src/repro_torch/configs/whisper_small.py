"""whisper-small [audio] — encoder-decoder, conv frontend stubbed.

12L (decoder; + 12L encoder) d_model=768 12H (kv=12) d_ff=3072
vocab=51865. input_specs() provides precomputed audio frame embeddings
(post-conv, 1500 frames per 30 s window). [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=0.0,  # learned absolute positions instead of RoPE
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_stub",
    tie_embeddings=True,
    notes="LayerNorm + learned positions (no RoPE); 12 heads -> attention "
          "replicated across model axis (tiny).",
))
