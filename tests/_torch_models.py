"""Shared fixtures of the model-stack parity tests (`test_torch_models.py`,
`test_torch_decode.py`): a reduced reference config with its parameters
as numpy (layer weights redrawn at 1/sqrt(fan-in), see
`test_torch_train.py`'s docstring) and the port's config of the same
name, for every family, whisper's ``enc``/``dec`` stacks included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jax_base
from repro.distributed.sharding import NO_SHARDING
from repro.models import api as jax_api
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import base as pt_base
from repro_torch.models.params import flatten_names, unflatten_names

CPU = "cpu"
STACKS = ("blocks/", "enc/", "dec/")


def fan_in(name, shape):
    """The contracted width of a stacked (L, ...) layer weight."""
    if name.endswith("/wo"):
        return shape[1] * shape[2]
    if "/moe/w_" in name:
        return shape[2]
    return shape[1]


def pair(name, seed=0, **changes):
    """(reference config, numpy params, port config) of a reduced arch."""
    cfg = dataclasses.replace(jax_base.get_config(name).reduced(), **changes)
    params = jax_init_params(jax_api.model_param_defs(cfg, NO_SHARDING),
                             jax.random.PRNGKey(seed))
    flat = flatten_names(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    for key, a in flat.items():
        if key.startswith(STACKS) and a.ndim > 2 and a.any():
            flat[key] = (rng.normal(size=a.shape)
                         / np.sqrt(fan_in(key, a.shape))).astype(np.float32)
    pcfg = dataclasses.replace(pt_base.get_config(name).reduced(), **changes)
    return cfg, unflatten_names(flat), pcfg


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=1e-5, rtol=1e-5, label=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), atol=atol, rtol=rtol, err_msg=label)


def front_inputs(cfg, b, seed=8):
    """The modality stub's input of a batch, as numpy: whisper's frames or
    the vision stub's prepended embeddings (0.02 standard normals)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frames": (0.02 * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"extra_embeds": (0.02 * rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model))).astype(
                np.float32)}
    return {}
