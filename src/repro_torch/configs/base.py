"""Model configuration dataclass and the architecture registry.

The port's own copy of `repro.configs.base` (the ten published
configurations are plain hyperparameters, copied exactly), with the
reference's four input-shape cells (`ShapeConfig`, `SHAPES`) that the
dry run (`launch.dryrun`) lowers every architecture against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. All sizes are the published full configs; smoke
    tests instantiate `reduced()` variants."""

    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavor
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # SWA window (all attn layers)
    local_global_period: int = 0  # gemma2: period-2 local/global alternation
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1  # MoE FFN every `moe_period` layers (jamba: 2)
    shared_expert: bool = False  # llama4-style always-on expert
    capacity_factor: float = 1.25
    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_period: int = 0  # jamba: one attention layer per `attn_period`
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30 s @ 50 Hz after conv stub
    # modality frontend stub (vlm / audio): input_specs provides embeddings
    frontend: Optional[str] = None  # None | "vision_stub" | "audio_stub"
    n_frontend_tokens: int = 0  # prepended embedding tokens (vlm)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # §Perf knobs (hillclimbed per-cell; defaults = paper-faithful baseline)
    flash_triangular: bool = False
    remat_policy: str = "full"  # full | dots | none
    norm_f32: bool = True  # False: bf16 norm math (§Perf iteration)
    # noted deviations from the assignment table (DESIGN.md §5)
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    def n_params(self) -> float:
        """Approximate total parameter count (embedding included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.n_experts:
            ff_routed = 3 * d * f * self.n_experts + d * self.n_experts
            if self.shared_expert:
                ff_routed += 3 * d * f
            ff = ff_routed
        else:
            ff = 3 * d * f
        ssm = 0
        if self.ssm_state:
            di = self.d_inner
            nh = di // self.ssm_head_dim
            ssm = d * (2 * di + 2 * self.ssm_state + nh) + di * d \
                + self.ssm_conv * (di + 2 * self.ssm_state)
        per_layer = 0.0
        n_attn, n_ssm = self.layer_counts()
        per_layer += n_attn * attn + n_ssm * ssm
        n_moe_layers = self.n_layers // self.moe_period if self.n_experts else 0
        n_dense_ff = self.n_layers - n_moe_layers
        if self.n_experts:
            per_layer += n_moe_layers * ff + n_dense_ff * 3 * d * f
        else:
            per_layer += self.n_layers * ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (attn + 3 * d * f) \
                + self.n_layers * attn  # cross-attention
        return float(per_layer + emb + enc)

    def n_active_params(self) -> float:
        """Active parameters per token (MoE top-k instead of all experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        full = self.n_params()
        n_moe_layers = self.n_layers // self.moe_period
        routed_all = 3 * d * f * self.n_experts * n_moe_layers
        routed_active = 3 * d * f * self.top_k * n_moe_layers
        return float(full - routed_all + routed_active)

    def layer_counts(self) -> Tuple[int, int]:
        """(attention layers, ssm layers) in the decoder stack."""
        if self.family == "ssm":
            return 0, self.n_layers
        if self.attn_period:
            n_attn = self.n_layers // self.attn_period
            return n_attn, self.n_layers - n_attn
        return self.n_layers, 0

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, self.attn_period or 2, 2 * self.moe_period),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            sliding_window=64 if self.sliding_window else None,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=64 if self.is_encoder_decoder else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            # no token drops in smoke tests (decode==prefill exactness)
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            n_frontend_tokens=8 if self.frontend == "vision_stub" else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs.archs  # noqa: F401  (populate registry)
    return _REGISTRY[name]


def all_arch_names():
    import repro_torch.configs.archs  # noqa: F401

    return sorted(_REGISTRY)
