"""Populate the architecture registry with all 10 assigned configs."""
import repro_torch.configs.gemma2_27b  # noqa: F401
import repro_torch.configs.granite_moe_3b  # noqa: F401
import repro_torch.configs.h2o_danube_18b  # noqa: F401
import repro_torch.configs.internlm2_20b  # noqa: F401
import repro_torch.configs.internvl2_1b  # noqa: F401
import repro_torch.configs.jamba_15_large  # noqa: F401
import repro_torch.configs.llama4_maverick  # noqa: F401
import repro_torch.configs.mamba2_130m  # noqa: F401
import repro_torch.configs.qwen15_05b  # noqa: F401
import repro_torch.configs.whisper_small  # noqa: F401

ARCH_IDS = [
    "gemma2-27b",
    "qwen1.5-0.5b",
    "h2o-danube-1.8b",
    "internlm2-20b",
    "granite-moe-3b-a800m",
    "llama4-maverick-400b-a17b",
    "internvl2-1b",
    "jamba-1.5-large-398b",
    "whisper-small",
    "mamba2-130m",
]
