"""The port's train path against the JAX reference on the CPU.

Same numpy inputs (seeded), parameters carried into the port with
`repro_torch.interop.params_from_numpy`, reduced configs (2 layers,
d_model 128). The parameters are the JAX init's tree with every
layer weight redrawn from numpy at 1/sqrt(its real fan-in): the init
recipe of both packages takes the fan-in as the stacked layer count
(ROADMAP Queue 3), which puts activations near 10³ and makes float32
rounding alone move outputs and gradients past 1e-5 in either package.
`test_init_keeps_the_reference_fan_in_quirk` holds the port's init to
the recipe itself. Tolerances: layers, projections, attention and the
forward logits at 1e-5; the MoE FFN at 1e-5; ``lm_loss`` at rtol 1e-5
with its gradients at atol 1e-5 / rtol 1e-4 (sums over tokens run in
another order); AdamW
with fed gradients at 1e-6 (elementwise arithmetic repeated op for op);
three whole train steps at rtol 1e-4 on losses and gradient norms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import pair as jax_model
from repro.configs import base as jax_base
from repro.configs.archs import ARCH_IDS
from repro.distributed.sharding import NO_SHARDING
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.launch.train import run as pt_run
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as pt_tf
from repro_torch.models.params import (flatten_names, init_params,
                                       unflatten_names)
from repro_torch.optim import adamw as pt_adamw
from repro_torch.train.step import build_train_step as pt_build_train_step

CPU = "cpu"


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=1e-5, rtol=1e-5, label=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got)
                               else got, np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=label)


def batch_np(seed, b, s, v=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, v, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_config_equals_the_reference(name):
    ref, port = jax_base.get_config(name), pt_base.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.n_params() == ref.n_params()
    assert sorted(pt_base.all_arch_names()) == sorted(ARCH_IDS)


@pytest.mark.parametrize("layer", ["rms_norm", "apply_rope", "swiglu",
                                   "cross_entropy_loss"])
def test_layers_match(layer):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    if layer == "rms_norm":
        scale = rng.normal(size=(32,)).astype(np.float32)
        close(pt_layers.rms_norm(t(x), t(scale), 1e-6),
              jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    elif layer == "apply_rope":
        pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
        close(pt_layers.apply_rope(t(x), t(pos), 10000.0),
              jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    10000.0))
    elif layer == "swiglu":
        w = [rng.normal(size=sh).astype(np.float32) * 0.2
             for sh in ((32, 48), (32, 48), (48, 32))]
        for act in ("silu", "gelu"):
            close(pt_layers.swiglu(t(x), *map(t, w), act=act),
                  jax_layers.swiglu(jnp.asarray(x),
                                    *map(jnp.asarray, w), act=act),
                  label=act)
    else:
        logits = rng.normal(0, 3, (4, 8, 50)).astype(np.float32)
        labels = rng.integers(0, 50, (4, 8)).astype(np.int32)
        mask = (rng.random((4, 8)) < 0.7).astype(np.float32)
        close(pt_layers.cross_entropy_loss(t(logits), t(labels)),
              jax_layers.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(labels)))
        close(pt_layers.cross_entropy_loss(t(logits), t(labels), t(mask)),
              jax_layers.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(labels),
                                            jnp.asarray(mask)))


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "qwen1.5-0.5b"])
def test_qkv_project_and_attention_match(name):
    cfg, params, pcfg = jax_model(name)
    rng = np.random.default_rng(5)
    p_np = jax.tree_util.tree_map(lambda a: a[0],
                                  params["blocks"]["L0"]["attn"])
    if cfg.qkv_bias:  # zeros at init: give the biases values
        for key in ("bq", "bk", "bv"):
            p_np[key] = rng.normal(0, 0.5, p_np[key].shape).astype(np.float32)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64), (2, 64)).astype(np.int32)
    p_j = jax.tree_util.tree_map(jnp.asarray, p_np)
    p_t = interop.params_from_numpy(p_np, CPU)
    want = jax_attn.qkv_project(p_j, jnp.asarray(x), jnp.asarray(pos), cfg,
                                NO_SHARDING)
    got = pt_attn.qkv_project(p_t, t(x), t(pos), pcfg)
    for g, w, lab in zip(got, want, "qkv"):
        close(g, w, label=lab)
    for window in (None, 16):
        close(pt_attn.attention_block(p_t, t(x), t(pos), pcfg, window=window),
              jax_attn.attention_block(p_j, jnp.asarray(x), jnp.asarray(pos),
                                       cfg, NO_SHARDING, window=window),
              label=f"attention window={window}")


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_ffn_matches(capacity_factor):
    cfg, params, pcfg = jax_model("granite-moe-3b-a800m",
                                  capacity_factor=capacity_factor)
    p_np = jax.tree_util.tree_map(lambda a: a[0],
                                  params["blocks"]["L0"]["moe"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    out, aux = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p_np),
                               jnp.asarray(x), cfg, NO_SHARDING)
    got, got_aux = pt_moe.moe_ffn(interop.params_from_numpy(p_np, CPU),
                                  t(x), pcfg)
    close(got, out, label="out")
    close(got_aux, aux, label="aux")
    # the small capacity really drops pairs (which tests the order)
    logits = x.reshape(-1, cfg.d_model) @ p_np["router"]
    top = np.argsort(-logits, axis=-1)[:, :cfg.top_k].reshape(-1)
    cap = max(1, int(capacity_factor * 64 * cfg.top_k / cfg.n_experts))
    dropped = np.bincount(top, minlength=cfg.n_experts).max() > cap
    assert dropped == (capacity_factor == 1.0)


@pytest.mark.parametrize("vocab", [512, 500])
def test_lm_loss_value_and_grads_match(vocab):
    """vocab 500 pads to 512: the padded logits are -1e30."""
    cfg, params, pcfg = jax_model("granite-moe-3b-a800m", vocab_size=vocab)
    assert params["embed"].shape[0] == 512
    batch = batch_np(4, 2, 32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_tf.lm_loss(p, b, cfg, NO_SHARDING)))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {k: v.requires_grad_(True) for k, v in flatten_names(
        interop.params_from_numpy(params, CPU)).items()}
    got = pt_tf.lm_loss(unflatten_names(flat),
                        {k: t(v) for k, v in batch.items()}, pcfg)
    close(got, loss, atol=0.0, rtol=1e-5, label="loss")
    got_g = dict(zip(flat, torch.autograd.grad(got, list(flat.values()))))
    want_g = flatten_names(jax.tree_util.tree_map(np.asarray, grads))
    assert set(got_g) == set(want_g)
    for k in want_g:
        close(got_g[k], want_g[k], atol=1e-5, rtol=1e-4, label=k)


@pytest.mark.parametrize("name", ["gemma2-27b", "llama4-maverick-400b-a17b"])
def test_forward_logits_match(name):
    """gemma2: local/global windows, softcaps, post-norms, GeGLU and the
    embedding scale; llama4: dense and MoE layers in one period and the
    shared expert. Both through `build_forward_fn`."""
    from repro.models.api import build_forward_fn as jax_forward_fn
    from repro_torch.models.api import build_forward_fn

    cfg, params, pcfg = jax_model(name)
    toks = batch_np(9, 2, 80)["tokens"]
    want = jax_forward_fn(cfg, NO_SHARDING)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"tokens": jnp.asarray(toks)})
    got = build_forward_fn(pcfg)(interop.params_from_numpy(params, CPU),
                                 {"tokens": t(toks)})
    assert got.shape == want.shape
    close(got, want, atol=1e-5, rtol=1e-5)


def test_apply_update_matches_over_three_steps():
    cfg, params, _ = jax_model("granite-moe-3b-a800m")
    opt_cfg = jax_adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                    total_steps=3)
    pt_cfg = pt_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))
    j_update = jax.jit(lambda p, g, s: jax_adamw.apply_update(p, g, s,
                                                              opt_cfg))
    rng = np.random.default_rng(6)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = jax_adamw.init_state(j_params)
    p_params = interop.params_from_numpy(params, CPU)
    p_state = pt_adamw.init_state(p_params)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
        j_params, j_state, j_m = j_update(
            j_params, jax.tree_util.tree_map(jnp.asarray, g), j_state)
        p_params, p_state, p_m = pt_adamw.apply_update(
            p_params, interop.params_from_numpy(g, CPU), p_state, pt_cfg)
        close(p_m["grad_norm"], j_m["grad_norm"], rtol=1e-6, label="norm")
        close(p_m["lr"], j_m["lr"], atol=0.0, rtol=1e-6, label="lr")
        assert int(p_state.step) == int(j_state.step) == step + 1
        for tree_p, tree_j, lab in ((p_params, j_params, "p"),
                                    (p_state.mu, j_state.mu, "m"),
                                    (p_state.nu, j_state.nu, "v")):
            want = flatten_names(jax.tree_util.tree_map(np.asarray, tree_j))
            for k, v in flatten_names(tree_p).items():
                close(v, want[k], atol=1e-6, rtol=1e-6, label=f"{lab} {k}")


def test_three_train_steps_match_from_carried_params():
    cfg, params, pcfg = jax_model("granite-moe-3b-a800m")
    opt_cfg = jax_adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                    total_steps=3)
    j_step = jax.jit(jax_build_train_step(cfg, NO_SHARDING, opt_cfg))
    p_step = pt_build_train_step(
        pcfg, pt_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg)))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = jax_adamw.init_state(j_params)
    p_params = interop.params_from_numpy(params, CPU)
    p_state = pt_adamw.init_state(p_params)
    for step in range(3):
        b = batch_np(10 + step, 2, 32)
        j_params, j_state, jm = j_step(
            j_params, j_state, {k: jnp.asarray(v) for k, v in b.items()})
        p_params, p_state, pm = p_step(p_params, p_state,
                                       {k: t(v) for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            close(pm[key], jm[key], atol=0.0, rtol=1e-4,
                  label=f"step {step} {key}")


def test_microbatches_accumulate_to_the_full_batch_gradient():
    _, params, pcfg = jax_model("qwen1.5-0.5b")
    opt_cfg = pt_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                                   total_steps=2)
    b = {k: t(v) for k, v in batch_np(7, 4, 16).items()}
    out = []
    for m in (1, 2):
        p = interop.params_from_numpy(params, CPU)
        step = pt_build_train_step(pcfg, opt_cfg, n_microbatches=m)
        p, _, metrics = step(p, pt_adamw.init_state(p), b)
        out.append((metrics, flatten_names(p)))
    close(out[1][0]["loss"], out[0][0]["loss"].numpy(), rtol=1e-5)
    close(out[1][0]["grad_norm"], out[0][0]["grad_norm"].numpy(), rtol=1e-4)
    for k, v in out[0][1].items():
        close(out[1][1][k], v.numpy(), atol=1e-6, rtol=1e-5, label=k)


def test_init_keeps_the_reference_fan_in_quirk():
    """Same tree, shapes, zero/one leaves and scales as the JAX init:
    a stacked (L, d, ...) weight has std 1/sqrt(L), not 1/sqrt(d)."""
    from repro_torch.models.api import model_param_defs
    from repro_torch.models.params import count_params

    cfg = jax_base.get_config("granite-moe-3b-a800m").reduced()
    pcfg = pt_base.get_config("granite-moe-3b-a800m").reduced()
    jdefs = jax_tf.param_defs(cfg, NO_SHARDING)
    want = flatten_names(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jdefs, jax.random.PRNGKey(0))))
    got = flatten_names(init_params(model_param_defs(pcfg),
                                    torch.Generator().manual_seed(0)))
    assert count_params(model_param_defs(pcfg)) == sum(
        a.size for a in want.values())
    assert list(got) == list(want)
    for k, a in want.items():
        g = got[k].numpy()
        assert g.shape == a.shape and g.dtype == a.dtype, k
        if not a.std():
            np.testing.assert_array_equal(g, a, err_msg=k)
        else:
            assert abs(g.std() / a.std() - 1) < 0.1, k
    assert abs(got["blocks/L0/attn/wq"].std().item() - 2 ** -0.5) < 0.02


def test_launcher_cpu_smoke_runs_both_probes():
    cfg = pt_base.get_config("granite-moe-3b-a800m").reduced()
    _, _, history = pt_run(cfg, steps=6, batch_size=4, seq=64,
                           probe_every=2, lr=3e-3, log=lambda *a: None,
                           device="cpu")
    assert [h["step"] for h in history] == list(range(6))
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0 for h in history)
    probes = [h for h in history if h["step"] % 2 == 0]
    assert all(np.isfinite(h["attn_entropy_mean"]) for h in probes)
    dists = [h["routing_jsdist"] for h in probes[1:]]
    assert len(dists) == 2 and all(d >= 0 for d in dists)
    assert "routing_jsdist" not in history[0]
