"""Mamba-2 (SSD — state-space duality) mixer, chunked-parallel form.

The port's copy of `repro.models.mamba2` for one device (no head
padding: the reference pads SSD heads only to a tensor-parallel degree
above 1). The selective state space recurrence per head h (head dim p,
state n):

  S_t = exp(-exp(A_log)·dt_t) · S_{t-1} + dt_t · (B_t ⊗ x_t)
  y_t = C_t · S_t + D · x_t

is evaluated with the SSD chunk decomposition (arXiv:2405.21060): within
a chunk of 128 the dual quadratic (attention-like) form, across chunks a
Python loop carrying the (h, n, p) state, where the reference scans.
Each of the reference's three-operand einsums is written as an
elementwise product and one batched matmul: `torch.einsum` contracts
left to right without ``opt_einsum``, and could otherwise form a
(B, chunks, q, k, h, p) intermediate. `ssd_decode_step` is the O(1)
recurrent step of serving. ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` computes it (`torch.nn.functional.softplus` returns
x above 20).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import PDef, TensorSpec


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_heads, head_dim, d_state)."""
    return cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def ssm_param_defs(cfg: ModelConfig, n_layers: int):
    d = cfg.d_model
    h, p_dim, n = ssm_dims(cfg)
    di = h * p_dim
    L = n_layers
    conv_ch = di + 2 * n
    return {
        "in_proj": PDef((L, d, 2 * di + 2 * n + h),
                        ("layers", "embed", "d_inner")),
        "conv_w": PDef((L, cfg.ssm_conv, conv_ch),
                       ("layers", None, "d_inner")),
        "conv_b": PDef((L, conv_ch), ("layers", "d_inner"), init="zeros"),
        "a_log": PDef((L, h), ("layers", "d_inner"), init="zeros"),
        "d_skip": PDef((L, h), ("layers", "d_inner"), init="ones"),
        "dt_bias": PDef((L, h), ("layers", "d_inner"), init="zeros"),
        "norm": PDef((L, di), ("layers", "d_inner"), init="zeros"),
        "out_proj": PDef((L, di, d), ("layers", "d_inner", "embed")),
    }


class SsmState(NamedTuple):
    """Decode cache: recurrent state + conv tail."""

    s: torch.Tensor  # (B, h, n, p) f32
    conv: torch.Tensor  # (B, conv_width-1, conv_channels)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(zxbcdt, di, n, h):
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + n]
    c = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xs, b, c, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x (B, S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + bias)


def ssd_mixer(p, x: torch.Tensor, cfg: ModelConfig,
              chunk: int = 128) -> torch.Tensor:
    """Full-sequence (train/prefill) SSD pass: x (B, S, D) → (B, S, D)."""
    bsz, s, _ = x.shape
    h, pd, n = ssm_dims(cfg)
    di = h * pd
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_mixer: S={s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk

    zxbcdt = x @ p["in_proj"]
    z, xs, b, c, dt = _split_proj(zxbcdt, di, n, h)
    xbc = _causal_conv(torch.cat([xs, b, c], -1), p["conv_w"], p["conv_b"])
    xs, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = _softplus(dt.float() + p["dt_bias"])  # (B, S, h)
    a = -torch.exp(p["a_log"].float())  # (h,) negative
    log_da = dt * a  # (B, S, h) log decay ≤ 0
    xh = xs.reshape(bsz, s, h, pd).float()
    dtx = xh * dt[..., None]  # dt-scaled input
    bc_ = b.float().reshape(bsz, nc, chunk, n)
    cc_ = c.float().reshape(bsz, nc, chunk, n)
    dtxc = dtx.reshape(bsz, nc, chunk, h, pd)

    cum = torch.cumsum(log_da.reshape(bsz, nc, chunk, h), dim=2)
    total = cum[:, :, -1, :]  # (B, nc, h)

    # intra-chunk (dual quadratic form):
    # y_q += Σ_{k≤q} C_q·B_k decay(q, k) dtx_k
    scores = cc_ @ bc_.transpose(-1, -2)  # (B, nc, q, k)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,q,k,h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # clamp BEFORE exp: masked (future) pairs have decay > 0 and would
    # overflow; where(mask, inf, 0) back-propagates 0·inf = NaN
    decay = torch.where(causal[:, :, None], decay, -1e30)
    w_qk = (scores[..., None] * torch.exp(decay)).permute(0, 1, 4, 2, 3)
    y_intra = (w_qk @ dtxc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk summary states: S_m = Σ_k decay_to_end(k) B_k ⊗ dtx_k
    to_end = torch.exp(total[:, :, None, :] - cum)  # (B, nc, k, h)
    scaled = (to_end[..., None] * dtxc).reshape(bsz, nc, chunk, h * pd)
    s_chunk = (bc_.transpose(-1, -2) @ scaled).reshape(
        bsz, nc, n, h, pd).permute(0, 1, 3, 2, 4)  # (B, nc, h, n, p)

    # inter-chunk recurrence over the summaries: the state entering
    # each chunk
    s_prev = torch.zeros((bsz, h, n, pd), dtype=torch.float32,
                         device=x.device)
    s_prevs = []
    for m in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * torch.exp(total[:, m])[..., None, None] \
            + s_chunk[:, m]
    s_prevs = torch.stack(s_prevs, dim=1)  # (B, nc, h, n, p)

    # inter-chunk contribution: y_q += C_q · S_prev · decay_from_start(q)
    y_inter = (cc_ @ s_prevs.permute(0, 1, 3, 2, 4).reshape(
        bsz, nc, n, h * pd)).reshape(bsz, nc, chunk, h, pd) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, pd)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"]


def ssd_decode_step(p, x: torch.Tensor, state: SsmState, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, SsmState]:
    """O(1) recurrent decode step: x (B, 1, D) → (out (B, 1, D), the
    new `SsmState`)."""
    bsz = x.shape[0]
    h, pd, n = ssm_dims(cfg)
    di = h * pd
    zxbcdt = (x @ p["in_proj"])[:, 0]
    z, xs, b, c, dt = _split_proj(zxbcdt, di, n, h)
    xbc = torch.cat([xs, b, c], -1)[:, None, :]  # (B, 1, C)
    conv_in = torch.cat([state.conv, xbc.to(state.conv.dtype)], dim=1)
    k = p["conv_w"].shape[0]
    out = sum(conv_in[:, i, :] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(out + p["conv_b"])
    xs, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = _softplus(dt.float() + p["dt_bias"])  # (B, h)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)  # (B, h)
    xh = xs.reshape(bsz, h, pd).float()
    s_new = state.s * da[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", b.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", c.float(), s_new)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, di)
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.norm_eps)
    out = (y.to(x.dtype) @ p["out_proj"])[:, None]
    return out, SsmState(s=s_new, conv=conv_in[:, 1:, :])


def ssm_state_structs(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.float32) -> SsmState:
    """The decode state's shapes and dtypes (the recurrent state is
    always f32; ``dtype`` is the conv tail's)."""
    h, pd, n = ssm_dims(cfg)
    di = h * pd
    return SsmState(
        s=TensorSpec((batch, h, n, pd), torch.float32),
        conv=TensorSpec((batch, cfg.ssm_conv - 1, di + 2 * n), dtype))


def init_ssm_state(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> SsmState:
    st = ssm_state_structs(cfg, batch, dtype)
    return SsmState(s=st.s.zeros(device), conv=st.conv.zeros(device))
