"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    notes="Attention-free: FINGER attention-graph probe inapplicable "
          "(DESIGN.md §5); long_500k runnable (O(1) state).",
))
