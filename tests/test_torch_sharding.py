"""The port's model-sharding rules, padded models and dry-run inputs
against the JAX reference, on the CPU.

- `ShardingRules.spec_for` over every logical axis and every rules
  variant the dry run uses (`NO_SHARDING`, `single_pod_rules(16)`,
  `multi_pod_rules(16)`, each with a replicated batch and
  ``seq_kv_over_data``, and with ``fsdp=None``), entry for entry equal
  to the reference's ``PartitionSpec``; the padding helpers.
- For all ten architectures: the parameter tree's names, shapes, init
  recipes and specs leaf by leaf, and `count_params`, under TP-16
  padding; for every architecture × shape: `input_specs`,
  `input_logical_axes`, the cache's specs and axes, and `skip_reason`
  (the reference's function is read from its source: importing
  `repro.launch.dryrun` sets ``XLA_FLAGS`` for 512 devices).
- Reduced dense, MoE, SSM, encoder-decoder and vision-stub models under
  TP-16 padding: the loss and four decode steps' logits (f32 cache)
  within 1e-5 of the reference, weights carried from the reference's
  init (layer weights redrawn at 1/sqrt(fan-in) as in
  `_torch_models.pair`; a padded ``wo`` stays zero). The reference runs
  inside a 1×1 ``jax.sharding.Mesh`` with Auto axes built here:
  `repro.launch.mesh.make_host_mesh` gives Explicit axes under jax
  0.9.0, where its `constrain` raises (ROADMAP Queue 3).
- The padded port equals the unpadded port on zero-padded weights for
  head, expert and vocabulary padding. Expert padding keeps the logits
  but scales the aux loss by E_pad / E (the reference's aux multiplies
  by the padded count). SSM head padding is not invisible in either
  package: the gated RMSNorm spans the padded inner width.
- The attention probe and the routing graph under padding, and the
  padded parameter trees crossing both ways through `interop`.
"""
import ast
import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import base as jax_base
from repro.configs.archs import ARCH_IDS as JAX_ARCH_IDS
from repro.distributed import sharding as jsh
from repro.models import api as jax_api
from repro.models import params as jax_params
from repro.models import transformer as jax_tr
from repro.train import telemetry as jax_tel
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.configs.archs import ARCH_IDS
from repro_torch.distributed import sharding as psh
from repro_torch.launch.dryrun import skip_reason
from repro_torch.models import api as pt_api
from repro_torch.models import transformer as pt_tr
from repro_torch.models.params import (count_params, flatten_names,
                                       param_specs, param_structs,
                                       unflatten_names)
from repro_torch.train import telemetry as pt_tel
from _torch_models import STACKS, close, fan_in, front_inputs, t

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
AXES = ("batch", "embed", "ff_data", "seq_kv", "heads", "kv_heads", "ff",
        "vocab", "experts", "d_inner", "replicated", "layers", None)


def rules_variants(mod):
    out = {"none": mod.NO_SHARDING}
    for name, base in (("pod", mod.single_pod_rules(16)),
                       ("multipod", mod.multi_pod_rules(16))):
        out[name] = base
        out[name + "-replicated"] = dataclasses.replace(
            base, batch=(), seq_kv_over_data=True)
        out[name + "-resident"] = dataclasses.replace(base, fsdp=None)
    return out


VARIANTS = sorted(rules_variants(psh))


def spec(p):
    return tuple(p)


def host_mesh():
    """A 1×1 mesh with Auto axes (fact 3 of the slice's notes)."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_spec_for_matches_every_axis(variant):
    pr, jr = rules_variants(psh)[variant], rules_variants(jsh)[variant]
    assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
    for ax in AXES:
        assert pr.spec_for((ax,)) == spec(jr.spec_for((ax,))), ax
    axes = ("batch", None, "seq_kv", "heads")
    assert pr.spec_for(axes) == spec(jr.spec_for(axes))
    for mod in (pr, jr):
        with pytest.raises(ValueError, match="unknown logical axis"):
            mod.spec_for(("tokens",))


def test_padding_helpers_match():
    for tp in (1, 2, 3, 6, 16, 48, 256):
        for mod in (psh, jsh):
            assert mod.NO_SHARDING.tp_size == 1
        pr, jr = psh.single_pod_rules(tp), jsh.single_pod_rules(tp)
        for v in (1, 127, 128, 500, 49155, 151936, 256000):
            assert psh.padded_vocab(v, pr) == jsh.padded_vocab(v, jr)
            assert psh.padded_vocab(v, psh.NO_SHARDING) == \
                jsh.padded_vocab(v, jsh.NO_SHARDING)
        for h in (1, 3, 8, 12, 24, 32, 40):
            assert psh.effective_heads(h, pr) == jsh.effective_heads(h, jr)
            assert psh.kv_heads_shardable(h, pr) == \
                jsh.kv_heads_shardable(h, jr)
            assert psh.pad_to_multiple(h, tp) == jsh.pad_to_multiple(h, tp)
    r16 = psh.single_pod_rules(16)
    assert psh.padded_vocab(49155, r16) == 49280
    assert psh.effective_heads(24, r16) == 32
    # an inactive rules object leaves a tensor alone
    x = torch.ones(2, 3)
    assert psh.constrain(x, psh.NO_SHARDING, ("batch", None)) is x
    assert psh.constrain(x, r16, ("batch", None)) is x


def jdefs_flat(defs):
    return flatten_names(defs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_and_specs_match(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    cfg, pcfg = jax_base.get_config(arch), pt_base.get_config(arch)
    for variant in ("none", "pod", "multipod"):
        jr, pr = rules_variants(jsh)[variant], rules_variants(psh)[variant]
        jd = flatten_names(jax_api.model_param_defs(cfg, jr))
        pd = flatten_names(pt_api.model_param_defs(pcfg, rules=pr))
        assert list(pd) == list(jd)
        for k in jd:
            assert (pd[k].shape, pd[k].axes, pd[k].init, pd[k].scale) == (
                tuple(jd[k].shape), tuple(jd[k].axes), jd[k].init,
                jd[k].scale), k
        js = flatten_names(jax_params.param_specs(
            jax_api.model_param_defs(cfg, jr), jr))
        ps = flatten_names(param_specs(pt_api.model_param_defs(
            pcfg, rules=pr), pr))
        assert {k: spec(v) for k, v in js.items()} == ps
        assert count_params(pt_api.model_param_defs(pcfg, rules=pr)) == \
            jax_params.count_params(jax_api.model_param_defs(cfg, jr))
        st = flatten_names(param_structs(pt_api.model_param_defs(
            pcfg, rules=pr)))
        assert all(s.dtype == torch.bfloat16 and s.shape == pd[k].shape
                   for k, s in st.items())


def reference_skip_reason():
    """The reference's `skip_reason`, compiled from its source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "skip_reason")
    ns = {"Optional": Optional, "ModelConfig": object,
          "ShapeConfig": object}
    exec(compile(ast.Module([fn], []), "skip_reason", "exec"), ns)
    return ns["skip_reason"]


def _dtype(x):
    return str(x).replace("torch.", "")


def _structs(tree):
    return {k: (tuple(v.shape), _dtype(v.dtype))
            for k, v in flatten_names(tree).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_caches_and_skips_match(arch):
    ref_skip = reference_skip_reason()
    cfg, pcfg = jax_base.get_config(arch), pt_base.get_config(arch)
    assert set(pt_base.SHAPES) == set(jax_base.SHAPES)
    for name, shape in jax_base.SHAPES.items():
        pshape = pt_base.SHAPES[name]
        assert dataclasses.asdict(pshape) == dataclasses.asdict(shape)
        assert skip_reason(pcfg, pshape) == ref_skip(cfg, shape)
        for variant in ("none", "pod", "multipod-replicated"):
            jr = rules_variants(jsh)[variant]
            pr = rules_variants(psh)[variant]
            want = jax_api.input_specs(cfg, shape, jr)
            got = pt_api.input_specs(pcfg, pshape, pr)
            assert _structs(got) == _structs(want), (name, variant)
            assert flatten_names(pt_api.input_logical_axes(
                pcfg, pshape, pr)) == flatten_names(
                    jax_api.input_logical_axes(cfg, shape, jr))
            js, ja = jax_api.cache_spec(cfg, 2, 64, jr)
            ps = pt_api.cache_spec(pcfg, 2, 64, rules=pr)
            assert _structs(ps) == _structs(js)
            assert flatten_names(pt_api.cache_axes(pcfg, pr)) == \
                flatten_names(ja)


# -- reduced padded models against the reference ----------------------------

MODELS = ["qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-130m",
          "whisper-small", "internvl2-1b"]
R16 = (jsh.single_pod_rules(16), psh.single_pod_rules(16))


def padded_pair(name, seed=0, draw_wo=False):
    """(reference config, numpy params under TP-16 padding, port
    config): the reference's init, layer weights redrawn at
    1/sqrt(fan-in) where they are not zero; with ``draw_wo``, the
    padded ``wo`` (zero whole at the reference's init) too."""
    cfg = jax_base.get_config(name).reduced()
    params = jax_params.init_params(
        jax_api.model_param_defs(cfg, R16[0]), jax.random.PRNGKey(seed))
    flat = flatten_names(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    for key, a in flat.items():
        drawn = a.any() or draw_wo and key.endswith("/wo")
        if key.startswith(STACKS) and a.ndim > 2 and drawn:
            flat[key] = (rng.normal(size=a.shape)
                         / np.sqrt(fan_in(key, a.shape))).astype(np.float32)
    return cfg, unflatten_names(flat), pt_base.get_config(name).reduced()


def batch_of(cfg, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out.update(front_inputs(cfg, b))
    return out


def decode_logits_ref(cfg, params, toks, n):
    rules = R16[0]
    cache = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.float32),
        jax_api.init_cache_arrays(cfg, toks.shape[0], 8, rules))
    step = jax.jit(jax_api.build_decode_fn(cfg, rules))
    out = []
    for i in range(n):
        logits, cache = step(params, jnp.asarray(toks[:, i:i + 1]), cache,
                             jnp.int32(i))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1)


def decode_logits_port(pcfg, params, toks, n, rules):
    cache = pt_api.init_cache_arrays(pcfg, toks.shape[0], 8, CPU,
                                     torch.float32, rules)
    step = pt_api.build_decode_fn(pcfg, rules)
    out = []
    with torch.no_grad():
        for i in range(n):
            logits, cache = step(params, t(toks[:, i:i + 1]), cache, i)
            out.append(logits[:, 0])
    return torch.stack(out, 1)


@pytest.mark.parametrize("name", MODELS)
def test_padded_loss_and_decode_match_the_reference(name):
    cfg, p_np, pcfg = padded_pair(name)
    jr, pr = R16
    b = batch_of(cfg)
    with host_mesh():
        want = jax.jit(jax_api.build_loss_fn(cfg, jr))(
            jax.tree_util.tree_map(jnp.asarray, p_np),
            {k: jnp.asarray(v) for k, v in b.items()})
        dec_want = decode_logits_ref(
            cfg, jax.tree_util.tree_map(jnp.asarray, p_np), b["tokens"], 4)
    params = interop.params_from_numpy(p_np, CPU)
    got = pt_api.build_loss_fn(pcfg, rules=pr)(
        params, {k: t(v) for k, v in b.items()})
    close(got, want, label=f"{name} loss")
    got_dec = decode_logits_port(pcfg, params, b["tokens"], 4, pr)
    v = cfg.vocab_size
    close(got_dec[..., :v], dec_want[..., :v], label=f"{name} decode")
    # with wo zero the attention adds nothing: draw it, and hold the
    # padded attention (the padded q heads, their kv map) to the
    # reference through the loss and the prefill's logits (the decode
    # departs from the reference's there: the next test)
    wo = [k for k in flatten_names(p_np) if k.endswith("/wo")]
    assert all(not flatten_names(p_np)[k].any() for k in wo)
    cfg, p_np, pcfg = padded_pair(name, draw_wo=True)
    assert all(flatten_names(p_np)[k].any() for k in wo)
    with host_mesh():
        pj = jax.tree_util.tree_map(jnp.asarray, p_np)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        want = jax.jit(jax_api.build_loss_fn(cfg, jr))(pj, jb)
        fwd_want = jax.jit(jax_api.build_forward_fn(cfg, jr))(pj, jb)
    params = interop.params_from_numpy(p_np, CPU)
    tb = {k: t(v) for k, v in b.items()}
    close(pt_api.build_loss_fn(pcfg, rules=pr)(params, tb), want,
          label=f"{name} loss, wo drawn")
    with torch.no_grad():
        fwd = pt_api.build_forward_fn(pcfg, rules=pr)(params, tb)
    close(fwd[..., :v], np.asarray(fwd_want)[..., :v],
          label=f"{name} prefill, wo drawn")


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_reference_padded_decode_departs_from_its_prefill(name):
    """A reference red (ROADMAP Queue 3), pinned: once ``wo`` is drawn,
    the reference's padded decode groups q heads by n_q / n_kv and
    leaves its own prefill (by 1.13 in these draws' logits), while the
    port's padded decode maps heads as the prefill does and equals the
    reference's prefill."""
    cfg, p_np, pcfg = padded_pair(name, draw_wo=True)
    b = batch_of(cfg)
    toks = b["tokens"][:, :4]
    v = cfg.vocab_size
    with host_mesh():
        pj = jax.tree_util.tree_map(jnp.asarray, p_np)
        prefill = np.asarray(jax.jit(jax_api.build_forward_fn(
            cfg, R16[0]))(pj, {"tokens": jnp.asarray(toks)}))[..., :v]
        dec_ref = decode_logits_ref(cfg, pj, b["tokens"], 4)[..., :v]
    gap = float(np.abs(dec_ref - prefill).max())
    assert gap > 0.1, gap
    got = decode_logits_port(pcfg, interop.params_from_numpy(p_np, CPU),
                             b["tokens"], 4, R16[1])
    close(got[..., :v], prefill, label=f"{name} decode vs prefill")


def zero_padded(unpadded, padded_defs):
    """An unpadded parameter tree (numpy) zero-padded at the end of every
    axis to the padded tree's shapes."""
    flat, want = flatten_names(unpadded), flatten_names(padded_defs)
    out = {}
    for k, d in want.items():
        a = flat[k]
        out[k] = np.pad(a, [(0, n - m) for n, m in zip(d.shape, a.shape)])
    return unflatten_names(out)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "whisper-small", "internvl2-1b"])
def test_padded_equals_unpadded_on_zero_padded_weights(name):
    _, p_np, pcfg = padded_pair(name)
    pr = R16[1]
    # the unpadded model's weights: the padded draw cut to the real
    # heads and experts (the reference zero-inits a padded wo whole,
    # so it is drawn here)
    defs_u = flatten_names(pt_api.model_param_defs(pcfg))
    rng = np.random.default_rng(4)
    flat = flatten_names(p_np)
    unp = {}
    for k, d in defs_u.items():
        a = flat[k][tuple(slice(0, n) for n in d.shape)]
        if k.endswith("/wo"):
            a = (rng.normal(size=a.shape) / np.sqrt(
                fan_in(k, a.shape))).astype(np.float32)
        unp[k] = a
    unp = unflatten_names(unp)
    padded = zero_padded(unp, pt_api.model_param_defs(pcfg, rules=pr))
    b = batch_of(pcfg)
    tb = {k: t(v) for k, v in b.items()}
    pu = interop.params_from_numpy(unp, CPU)
    pp = interop.params_from_numpy(padded, CPU)
    v = pcfg.vocab_size
    with torch.no_grad():
        if pcfg.is_encoder_decoder:
            lu = pt_api.build_forward_fn(pcfg)(pu, tb)
            lp = pt_api.build_forward_fn(pcfg, rules=pr)(pp, tb)
            close(lp[..., :v], lu[..., :v], atol=1e-4, rtol=1e-4)
            close(pt_api.build_loss_fn(pcfg, rules=pr)(pp, tb),
                  pt_api.build_loss_fn(pcfg)(pu, tb))
        else:
            lu, aux_u = pt_tr.forward(pu, tb["tokens"], pcfg,
                                      extra_embeds=tb.get("extra_embeds"))
            lp, aux_p = pt_tr.forward(pp, tb["tokens"], pcfg,
                                      extra_embeds=tb.get("extra_embeds"),
                                      rules=pr)
            close(lp[..., :v], lu[..., :v], atol=1e-4, rtol=1e-4)
            e_pad = pt_tr.moe_param_defs(pcfg, 1, pr)["router"].shape[-1] \
                if pcfg.n_experts else 1
            e = pcfg.n_experts or 1
            close(aux_p, float(aux_u) * e_pad / e, label="aux")
            lo_u = pt_api.build_loss_fn(pcfg)(pu, tb) - 0.01 * aux_u
            lo_p = pt_api.build_loss_fn(pcfg, rules=pr)(pp, tb) \
                - 0.01 * aux_p
            close(lo_p, lo_u, label="cross entropy")
        got = decode_logits_port(pcfg, pp, b["tokens"], 4, pr)
        want = decode_logits_port(pcfg, pu, b["tokens"], 4,
                                  psh.NO_SHARDING)
    close(got[..., :v], want[..., :v], atol=1e-4, rtol=1e-4, label="decode")


def test_ssm_padding_shows_in_the_gated_norm():
    """mamba2's padded SSM heads are zero on zero-padded weights, but the
    gated RMSNorm averages over the padded inner width, so the padded
    model differs from the unpadded one (in the reference too)."""
    cfg, p_np, pcfg = padded_pair("mamba2-130m")
    defs_u = flatten_names(pt_api.model_param_defs(pcfg))
    assert defs_u["blocks/L0/ssm/norm"].shape[-1] \
        < flatten_names(p_np)["blocks/L0/ssm/norm"].shape[-1]


def test_probes_under_padding_match_the_reference():
    """The attention probe over padded heads (the reference's repeat
    map) and the routing graph over padded experts (pairs naming a
    padded expert dropped)."""
    cfg, p_np, pcfg = padded_pair("granite-moe-3b-a800m")
    jr, pr = R16
    b = batch_of(cfg, s=32)
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    pp = interop.params_from_numpy(p_np, CPU)
    with host_mesh():
        want = jax_tel.attention_entropy_probe(
            pj, jnp.asarray(b["tokens"]), cfg, jr, use_pallas=False)
        g_want = jax_tel.routing_graph(pj, {"tokens": jnp.asarray(
            b["tokens"])}, cfg, jr)
    got = pt_tel.attention_entropy_probe(pp, t(b["tokens"]), pcfg, rules=pr)
    assert got.shape == want.shape == (2 * 16,)
    close(got, want, atol=1e-4, rtol=1e-4)
    g = pt_tel.routing_graph(pp, {"tokens": t(b["tokens"])}, pcfg, rules=pr)
    # padded router columns are drawn, so some top-k pick padded experts
    assert g.weights.shape == (cfg.n_experts, cfg.n_experts)
    close(g.weights, g_want.weights)


def test_padded_params_cross_both_ways():
    for name in MODELS:
        cfg, p_np, pcfg = padded_pair(name)
        pp = interop.params_from_numpy(p_np, CPU)
        defs = flatten_names(pt_api.model_param_defs(pcfg, rules=R16[1]))
        assert {k: tuple(v.shape) for k, v in flatten_names(pp).items()} \
            == {k: d.shape for k, d in defs.items()}
        back = flatten_names(interop.params_to_numpy(pp))
        for k, a in flatten_names(p_np).items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)
        # and the port's own padded init crosses into the reference
        from repro_torch.models.params import init_params

        mine = init_params(pt_api.model_param_defs(pcfg, rules=R16[1]),
                           torch.Generator().manual_seed(0), device=CPU)
        as_np = interop.params_to_numpy(mine)
        ref_shapes = jax.tree_util.tree_map(
            lambda d: tuple(d.shape),
            jax_api.model_param_defs(cfg, R16[0]),
            is_leaf=lambda x: isinstance(x, jax_params.PDef))
        assert {k: v.shape for k, v in flatten_names(as_np).items()} == \
            flatten_names(ref_shapes)
        wo = [k for k in flatten_names(as_np) if k.endswith("/wo")]
        assert all(not flatten_names(as_np)[k].any() for k in wo)
