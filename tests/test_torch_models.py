"""The port's model families against the JAX reference on the CPU: the
SSM mixer (mamba2, jamba), the encoder–decoder (whisper) and the vision
stub (internvl2), and what the train path gained with them.

Reduced configs, b = 2, s = 16 (s = 32 where the SSD chunks are
tested), numpy inputs from a seed, the reference's parameters carried
across with `params_from_numpy` and layer weights redrawn at
1/sqrt(fan-in) (`_torch_models.pair`; the init's fan-in quirk is ROADMAP
Queue 3). Tolerances: `layer_norm`, the SSD mixer and its decode step,
whisper's encoder, decoder and loss and every forward at 1e-5; each
gradient leaf at rtol 1e-4 and atol 1e-4 × its largest element
(`close_grad`): an element is a sum over tokens and layers, run in
another order in each package, so its rounding scales with the leaf's
largest terms, not with its own value (jamba's eight layers move the
embedding's gradient by 6.5e-6 of its largest element).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import CPU, close, front_inputs, jnp_tree, pair, t
from repro.configs.archs import ARCH_IDS
from repro.configs import base as jax_base
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.distributed.sharding import NO_SHARDING
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import mamba2 as jax_mamba
from repro.models import whisper as jax_whisper
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.train import run as pt_run
from repro_torch.models import api as pt_api
from repro_torch.models import layers as pt_layers
from repro_torch.models import mamba2 as pt_mamba
from repro_torch.models import whisper as pt_whisper
from repro_torch.models.params import (count_params, flatten_names,
                                       init_params, unflatten_names)

R = NO_SHARDING


def close_grad(got, want, label):
    want = np.asarray(want)
    close(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=1e-4,
          label=label)


def tokens_np(seed, b, s, v):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_tree_equals_the_reference(name):
    """Every family's tree: the same leaf names, shapes and count, at
    full width (shapes only) and reduced (the init's zero/one leaves)."""
    for reduce in (False, True):
        ref_cfg = jax_base.get_config(name)
        cfg = pt_base.get_config(name)
        if reduce:
            ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
        want = flatten_names(jax_api.model_param_defs(ref_cfg, R))
        got = flatten_names(pt_api.model_param_defs(cfg))
        assert list(got) == list(want)
        assert all(got[k].shape == want[k].shape
                   and got[k].init == want[k].init
                   and got[k].scale == want[k].scale for k in want)
        assert count_params(pt_api.model_param_defs(cfg)) == sum(
            int(np.prod(d.shape)) for d in want.values())


def test_layer_norm_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (2, 16, 64)).astype(np.float32)
    scale, bias = (rng.normal(size=(64,)).astype(np.float32)
                   for _ in range(2))
    close(pt_layers.layer_norm(t(x), t(scale), t(bias)),
          jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias)))
    got = pt_layers.layer_norm(t(x).to(torch.bfloat16), t(scale), t(bias))
    assert got.dtype == torch.bfloat16


def _ssm_params(name="mamba2-130m"):
    cfg, params, pcfg = pair(name)
    blk = "L0" if cfg.family == "ssm" else "L1"
    p_np = jax.tree_util.tree_map(lambda a: a[0],
                                  params["blocks"][blk]["ssm"])
    rng = np.random.default_rng(4)
    for key in ("conv_b", "a_log", "dt_bias", "norm"):  # zeros at init
        p_np[key] = rng.normal(0, 0.5, p_np[key].shape).astype(np.float32)
    return cfg, p_np, pcfg


@pytest.mark.parametrize("chunk", [8, 128])
def test_ssd_mixer_matches(chunk):
    """chunk 8 at s = 32: four chunks and the inter-chunk recurrence;
    chunk 128: one chunk of 32."""
    cfg, p_np, pcfg = _ssm_params()
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jax_mamba.ssd_mixer(p, x, cfg, R,
                                                    chunk=chunk))(
        jnp_tree(p_np), jnp.asarray(x))
    got = pt_mamba.ssd_mixer(interop.params_from_numpy(p_np, CPU), t(x),
                             pcfg, chunk=chunk)
    close(got, want)


def test_ssd_mixer_gradient_is_finite_and_matches():
    """The clamp before the exp keeps the masked pairs out of the
    backward (0·inf would be NaN)."""
    cfg, p_np, pcfg = _ssm_params()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    gj = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_mamba.ssd_mixer(
        p, x, cfg, R, chunk=8) * w)))(jnp_tree(p_np), jnp.asarray(x))
    flat = {k: v.requires_grad_(True) for k, v in flatten_names(
        interop.params_from_numpy(p_np, CPU)).items()}
    out = pt_mamba.ssd_mixer(unflatten_names(flat), t(x), pcfg, chunk=8)
    grads = torch.autograd.grad(torch.sum(out * t(w)),
                                list(flat.values()))
    want = flatten_names(jax.tree_util.tree_map(np.asarray, gj))
    for k, g in zip(flat, grads):
        assert torch.isfinite(g).all(), k
        close_grad(g, want[k], k)


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_ssd_decode_step_matches(name):
    """Eight steps from a random state: the output and the carried
    `SsmState` (recurrent state and conv tail) each step."""
    cfg, p_np, pcfg = _ssm_params(name)
    rng = np.random.default_rng(7)
    st = jax_mamba.ssm_state_structs(cfg, 2, R)
    s_np = {"s": rng.normal(size=st.s.shape).astype(np.float32),
            "conv": rng.normal(size=st.conv.shape).astype(np.float32)}
    spec = pt_mamba.ssm_state_structs(pcfg, 2)
    assert spec.s.shape == st.s.shape and spec.conv.shape == st.conv.shape
    j_state = jax_mamba.SsmState(**jnp_tree(s_np))
    p_state = pt_mamba.SsmState(**{k: t(v) for k, v in s_np.items()})
    pj, pp = jnp_tree(p_np), interop.params_from_numpy(p_np, CPU)
    j_step = jax.jit(lambda p, x, st: jax_mamba.ssd_decode_step(p, x, st,
                                                                cfg, R))
    for step in range(8):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        yj, j_state = j_step(pj, jnp.asarray(x), j_state)
        yp, p_state = pt_mamba.ssd_decode_step(pp, t(x), p_state, pcfg)
        close(yp, yj, label=f"out {step}")
        close(p_state.s, j_state.s, label=f"s {step}")
        close(p_state.conv, j_state.conv, label=f"conv {step}")


def _whisper():
    cfg, params, pcfg = pair("whisper-small")
    rng = np.random.default_rng(3)
    flat = flatten_names(params)
    for key, a in flat.items():  # the biases: zeros at init
        if key.endswith(("/b1", "/b2", "/bias")):
            flat[key] = rng.normal(0, 0.1, a.shape).astype(np.float32)
    return cfg, unflatten_names(flat), pcfg


def test_whisper_params_cross_as_the_nested_tree():
    cfg, params, pcfg = _whisper()
    got = interop.params_from_numpy(params, CPU)
    assert set(got) == {"embed", "pos_dec", "pos_enc", "enc",
                        "enc_final_ln", "dec", "dec_final_ln"}
    want = flatten_names(params)
    got_flat = flatten_names(got)
    assert list(got_flat) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got_flat[k].numpy(), a, err_msg=k)
    assert flatten_names(interop.params_to_numpy(got)).keys() == want.keys()


def test_whisper_encode_decode_train_and_loss_match():
    cfg, params, pcfg = _whisper()
    frames = front_inputs(cfg, 2)["frames"]
    toks = tokens_np(2, 2, 17, cfg.vocab_size)
    pj, pp = jnp_tree(params), interop.params_from_numpy(params, CPU)
    enc_j = jax.jit(lambda p, f: jax_whisper.encode(p, f, cfg, R))(
        pj, jnp.asarray(frames))
    enc_p = pt_whisper.encode(pp, t(frames), pcfg)
    close(enc_p, enc_j, label="encode")
    close(pt_whisper.decode_train(pp, t(toks[:, :-1]), enc_p, pcfg),
          jax.jit(lambda p, x, e: jax_whisper.decode_train(p, x, e, cfg, R))(
              pj, jnp.asarray(toks[:, :-1]), enc_j), label="decode_train")
    batch = {"frames": frames, "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}
    loss_j = jax.jit(lambda p, b: jax_whisper.loss_fn(p, b, cfg, R))(
        pj, jnp_tree(batch))
    loss_p = pt_whisper.loss_fn(pp, {k: t(v) for k, v in batch.items()},
                                pcfg)
    close(loss_p, loss_j, atol=0.0, label="loss")


def test_whisper_positions_past_448_are_sinusoids():
    cfg, params, pcfg = _whisper()
    pp = interop.params_from_numpy(params, CPU)
    got = pt_whisper._dec_positions(pp, 450, pcfg.d_model)
    want = jax_whisper._dec_positions(jnp_tree(params), 450, cfg.d_model)
    close(got, want, atol=1e-5, rtol=1e-5)
    assert got.shape == (450, pcfg.d_model)
    close(pt_whisper._dec_positions(pp, 448, pcfg.d_model),
          params["pos_dec"], atol=0, rtol=0)


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-1.5-large-398b",
                                  "internvl2-1b", "whisper-small"])
def test_forward_and_loss_gradients_match(name):
    """`build_forward_fn` and the loss's value and gradients through
    `build_loss_fn`: internvl2 with its prepended ``extra_embeds`` (the
    loss drops their logits), whisper with its frames."""
    cfg, params, pcfg = _whisper() if name == "whisper-small" \
        else pair(name)
    toks = tokens_np(9, 2, 17, 64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **front_inputs(cfg, 2)}
    pj = jnp_tree(params)
    logits = jax.jit(jax_api.build_forward_fn(cfg, R))(pj, jnp_tree(batch))
    got = pt_api.build_forward_fn(pcfg)(
        interop.params_from_numpy(params, CPU),
        {k: t(v) for k, v in batch.items()})
    assert got.shape == logits.shape
    close(got, logits, label="forward")
    loss, grads = jax.jit(jax.value_and_grad(jax_api.build_loss_fn(
        cfg, R)))(pj, jnp_tree(batch))
    flat = {k: v.requires_grad_(True) for k, v in flatten_names(
        interop.params_from_numpy(params, CPU)).items()}
    got_loss = pt_api.build_loss_fn(pcfg)(unflatten_names(flat),
                                          {k: t(v) for k, v in batch.items()})
    close(got_loss, loss, atol=0.0, label="loss")
    got_g = dict(zip(flat, torch.autograd.grad(got_loss,
                                               list(flat.values()))))
    want_g = flatten_names(jax.tree_util.tree_map(np.asarray, grads))
    assert set(got_g) == set(want_g)
    for k in want_g:
        close_grad(got_g[k], want_g[k], k)


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-1b",
                                  "qwen1.5-0.5b"])
def test_synthetic_batch_front_inputs(name):
    """The new keys: the reference's shapes and dtype, and its 0.02
    scale (the draws differ: a torch generator against threefry)."""
    cfg = pt_base.get_config(name).reduced()
    got = synthetic_batch(cfg, 4, 16, seed=3, step=1, device=CPU)
    want = jax_synthetic_batch(jax_base.get_config(name).reduced(), 4, 16,
                               3, 1)
    assert set(got) == set(want)
    for key in set(got) - {"tokens", "labels"}:
        g, w = got[key], np.asarray(want[key])
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.05
        assert abs(float(g.mean())) < 2e-3
    again = synthetic_batch(cfg, 4, 16, seed=3, step=1, device=CPU)
    for key in got:
        assert torch.equal(got[key], again[key])


@pytest.mark.parametrize("name", ["mamba2-130m", "whisper-small",
                                  "internvl2-1b", "jamba-1.5-large-398b"])
def test_launcher_trains_every_new_family(name):
    """The train launcher on the CPU: finite losses, and the probes
    where the reference runs them (none for whisper, an encoder–decoder;
    no attention probe for attention-free mamba2; jamba's attention
    probe reads L0 and its routing graph L1)."""
    cfg = pt_base.get_config(name).reduced()
    if name == "internvl2-1b":  # 256 frontend tokens + 16 text tokens
        cfg = dataclasses.replace(cfg, n_frontend_tokens=16)
    _, _, history = pt_run(cfg, steps=3, batch_size=2, seq=16,
                           probe_every=2, lr=3e-3, log=lambda *a: None,
                           device=CPU)
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in history)
    probed = {k for h in history for k in h} & {"attn_entropy_mean",
                                               "routing_jsdist"}
    want = {"mamba2-130m": set(), "whisper-small": set(),
            "internvl2-1b": {"attn_entropy_mean"},
            "jamba-1.5-large-398b": {"attn_entropy_mean",
                                     "routing_jsdist"}}[name]
    assert probed == want


def test_init_params_of_every_new_family_is_finite():
    for name in ("mamba2-130m", "whisper-small", "internvl2-1b",
                 "jamba-1.5-large-398b"):
        cfg = pt_base.get_config(name).reduced()
        params = init_params(pt_api.model_param_defs(cfg),
                             torch.Generator().manual_seed(0))
        assert all(torch.isfinite(v).all()
                   for v in flatten_names(params).values())
