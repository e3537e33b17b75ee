"""The port's decode path against the JAX reference on the CPU.

`decode_step` (through `build_decode_fn`) is stepped over 16 tokens, b = 2,
on reduced configs with the reference's parameters carried across
(`_torch_models.pair`), and the same zero cache crossing with
`interop.cache_from_numpy` (whisper's cross-KV filled with the same
random values, so that its cross-attention is exercised). gemma2-27b and
h2o-danube-1.8b run with a sliding window of 8, so their ring buffers
wrap within the 16 steps.

- **f32 cache:** the logits of every step at 1e-5, every cache leaf at
  1e-5 of its largest element (`close_leaf`).
- **bf16 cache (the reference's):** the new key or value is an f32
  projection (the packages' agree within 1e-5) rounded to bf16, and the
  attention output is a bf16 product. Where an f32 value lies within
  1e-5 of the midpoint between two bf16 numbers, the packages may round
  it apart by one bf16 step. So, one layer alone
  (`test_decode_attention_bf16_cache_rounds_as_the_reference`): the
  new key and value bit-equal except at such ties, checked element by
  element against the port's f32 value, and the output within one bf16
  rounding of the attention output, a bound computed from the cached
  values and W_o. The whole model, each step from the reference's
  cache: every slot but the one written this step bit-equal; in the
  step's first attention layer (its inputs carry no bf16 rounding) the
  new slot equal but at ties; in later layers, whose inputs carry the
  step's earlier roundings, within two bf16 steps of the slot's largest
  element. The logits of a free run agree within the change that the
  bf16 roundings themselves make to them: the port's own logits over an
  f32 cache against its bf16 cache, on the same tokens (1e-5 for
  mamba2, which has no KV cache and rounds nothing to bf16).
- The port's decode against its own prefill at the reference's
  `test_decode_matches_prefill` tolerance, 2e-3, on its own init.
- `serve_batch` gives the reference's tokens from the reference's
  prompts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import CPU, close, jnp_tree, pair, t
from repro.configs.archs import ARCH_IDS
from repro.configs import base as jax_base
from repro.distributed.sharding import NO_SHARDING
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.launch.serve import serve_batch
from repro_torch.models import api as pt_api
from repro_torch.models import attention as pt_attn
from repro_torch.models.params import flatten_names, init_params
from repro_torch.models.transformer import n_periods, period_structure
from repro_torch.train.step import build_serve_step

R = NO_SHARDING
S = 16
DECODE_ARCHS = ["qwen1.5-0.5b", "gemma2-27b", "h2o-danube-1.8b",
                "granite-moe-3b-a800m", "mamba2-130m",
                "jamba-1.5-large-398b", "whisper-small"]
WINDOW = {"gemma2-27b": {"sliding_window": 8},
          "h2o-danube-1.8b": {"sliding_window": 8}}
PREFILL_ARCHS = ["qwen1.5-0.5b", "gemma2-27b", "h2o-danube-1.8b",
                 "mamba2-130m", "jamba-1.5-large-398b",
                 "granite-moe-3b-a800m"]


def ref_cache_np(cfg, b, length, kv_dtype, seed=11):
    """The reference's zero cache as numpy dicts, KV leaves in
    ``kv_dtype``; whisper's cross-KV random."""
    structs, _ = jax_api.cache_spec(cfg, b, length, R)
    out = {}
    for key, node in structs.items():
        leaves = {}
        for f, sd in node._asdict().items():
            dt = kv_dtype if sd.dtype == jnp.bfloat16 else sd.dtype
            leaves[f] = np.zeros(sd.shape, dt)
        out[key] = leaves
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(seed)
        for f, a in out["cross"].items():
            out["cross"][f] = rng.normal(size=a.shape).astype(kv_dtype)
    return out


def to_jax_cache(cfg, tree):
    kv = jax_attn.KVCache
    if cfg.is_encoder_decoder:
        return {k: kv(**jnp_tree(v)) for k, v in tree.items()}
    from repro.models.mamba2 import SsmState
    return {k: (kv if set(v) == {"k", "v"} else SsmState)(**jnp_tree(v))
            for k, v in tree.items()}


def from_jax_cache(cache):
    return {k: {f: np.asarray(x) for f, x in v._asdict().items()}
            for k, v in cache.items()}


def close_leaf(got, want, label):
    """A cache leaf at 1e-5 of its largest element: an SSM state is a
    sum over every step so far, whose rounding scales with the state,
    not with each element (jamba's: 3.3e-6 of its largest element at
    most)."""
    close(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())),
          rtol=1e-5, label=label)


def leaves(tree):
    return {f"{k}/{f}": a for k, node in tree.items()
            for f, a in node.items()}


class Decoder:
    """Both packages' decode of one reduced arch on the same tokens."""

    def __init__(self, name, seed=3):
        self.cfg, self.params, self.pcfg = pair(name, **WINDOW.get(name, {}))
        self.toks = np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (2, S)).astype(np.int32)
        self.jp = jnp_tree(self.params)
        self.pp = interop.params_from_numpy(self.params, CPU)
        self.jdec = jax.jit(jax_api.build_decode_fn(self.cfg, R))
        self.pdec = pt_api.build_decode_fn(self.pcfg)

    def ref_step(self, cache_np, i):
        logits, cache = self.jdec(self.jp, jnp.asarray(self.toks[:, i:i + 1]),
                                  to_jax_cache(self.cfg, cache_np),
                                  jnp.asarray(i, jnp.int32))
        return np.asarray(logits), from_jax_cache(cache)

    @torch.no_grad()
    def port_step(self, cache, i):
        return self.pdec(self.pp, t(self.toks[:, i:i + 1]), cache, i)

    def port_run(self, kv_dtype):
        cache = interop.cache_from_numpy(
            ref_cache_np(self.cfg, 2, S, kv_dtype), CPU)
        out = []
        for i in range(S):
            logits, cache = self.port_step(cache, i)
            out.append(logits[:, 0].numpy())
        return np.stack(out, 1)


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_step_f32_cache_matches(name):
    d = Decoder(name)
    v = d.cfg.vocab_size
    ref = ref_cache_np(d.cfg, 2, S, np.float32)
    cache = interop.cache_from_numpy(ref, CPU)
    for i in range(S):
        want, ref = d.ref_step(ref, i)
        got, cache = d.port_step(cache, i)
        close(got[..., :v], want[..., :v], label=f"logits {i}")
        got_c = leaves(interop.cache_to_numpy(cache))
        for key, a in leaves(ref).items():
            assert got_c[key].dtype == a.dtype == np.float32
            close_leaf(got_c[key], a, f"step {i} {key}")


def attention_calls(cfg):
    """(cache key, stack index) of each `decode_attention` call of one
    decode step, in call order."""
    if cfg.is_encoder_decoder:
        return [("self", layer) for layer in range(cfg.n_layers)]
    _, layers = period_structure(cfg)
    return [(f"L{i}", p) for p in range(n_periods(cfg))
            for i, (mixer, _, _) in enumerate(layers) if mixer == "attn"]


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_step_bf16_cache_matches(name, monkeypatch):
    d = Decoder(name)
    v = d.cfg.vocab_size
    projected = []  # the port's f32 (k, v) of each decode_attention call
    project = pt_attn.qkv_project

    def recording(p, x, positions, cfg):
        q, k, v_ = project(p, x, positions, cfg)
        if x.shape[1] == 1:
            projected.append((k[:, 0], v_[:, 0]))
        return q, k, v_

    monkeypatch.setattr(pt_attn, "qkv_project", recording)
    bf16 = jnp.bfloat16.dtype
    calls = attention_calls(d.pcfg)
    ref = ref_cache_np(d.cfg, 2, S, bf16)
    apart = 0
    for i in range(S):
        cache = interop.cache_from_numpy(ref, CPU)  # the reference's
        projected.clear()
        _, ref = d.ref_step(ref, i)
        _, cache = d.port_step(cache, i)
        got = leaves(interop.cache_to_numpy(cache))
        f32_kv = dict(zip(calls, projected))
        for key, want in leaves(ref).items():
            g = got[key]
            assert g.dtype == want.dtype, key
            if want.dtype != bf16:  # an SSM state: f32
                close_leaf(g, want, f"step {i} {key}")
                continue
            diff = g.view(np.uint16) != want.view(np.uint16)
            for stack in np.flatnonzero(diff.any(axis=(1, 2, 3, 4))):
                label = f"step {i} {key} {stack}"
                slot = i % g.shape[3]  # only the slot written this step
                assert not np.delete(diff[stack], slot, axis=2).any(), label
                gs, ws = (a[stack, :, :, slot].astype(np.float32)
                          for a in (g, want))
                call = (key.split("/")[0], stack)
                if call == calls[0]:  # its inputs carry no bf16 rounding
                    kv = f32_kv[call][key.endswith("/v")].numpy()
                    assert_ties(gs, ws, kv, diff[stack, :, :, slot], label)
                else:
                    assert np.abs(gs - ws).max() <= \
                        2.0 ** -7 * np.abs(ws).max(), label
                apart += int(diff[stack].sum())
    print(f"{name}: {apart} new cache elements rounded apart")

    monkeypatch.setattr(pt_attn, "qkv_project", project)
    # a free run of each package; the tolerance is what the roundings
    # themselves change: the port's f32-cache logits against its
    # bf16-cache logits
    ref = ref_cache_np(d.cfg, 2, S, bf16)
    want = []
    for i in range(S):
        logits, ref = d.ref_step(ref, i)
        want.append(logits[:, 0])
    want = np.stack(want, 1)[..., :v]
    got = d.port_run(bf16)[..., :v]
    rounding = np.abs(d.port_run(np.float32)[..., :v] - got).max()
    assert (rounding > 0) == bool(calls)  # mamba2 rounds nothing to bf16
    assert np.abs(got - want).max() <= max(rounding, 1e-5), (
        np.abs(got - want).max(), rounding)


def assert_ties(got, want, f32, diff, label):
    """Where the bf16 bits differ: one bf16 step apart, and the f32 value
    within 1e-5 of the midpoint between them, relative to the slot's
    largest value (a projection's rounding scales with its largest
    terms, as `close_leaf` says)."""
    g, w, x = got[diff], want[diff], f32[diff]
    spacing = np.maximum(np.abs(g), np.abs(w)) * 2.0 ** -7
    assert (np.abs(g - w) <= spacing).all(), (label, g, w)
    mid = (g + w) / 2
    band = 1e-5 * float(np.abs(f32).max())
    assert (np.abs(x - mid) <= band).all(), (label, x, mid, band)


@pytest.mark.parametrize("n_heads,n_kv,window", [(4, 2, None), (4, 2, 4),
                                                  (6, 4, None)])
def test_decode_attention_bf16_cache_rounds_as_the_reference(n_heads, n_kv,
                                                             window):
    """One layer from the same x and the same bf16 cache, 8 steps: the
    new key and value bit-equal but at ties, and the output within one
    bf16 rounding of the attention output: each of its elements, a
    convex combination of cached values, may round apart by one bf16
    step (2^-8 of max|v|), so |Δout| ≤ 2^-8 · Σ_hd max_k|v| · |W_o|."""
    cfg, params, pcfg = pair("qwen1.5-0.5b", n_heads=n_heads,
                             n_kv_heads=n_kv)
    p_np = jax.tree_util.tree_map(lambda a: a[0],
                                  params["blocks"]["L0"]["attn"])
    pj, pp = jnp_tree(p_np), interop.params_from_numpy(p_np, CPU)
    length = window or S
    sd = jax_attn.KVCache.shape(cfg, 2, length, R)
    jc = jax_attn.KVCache(k=jnp.zeros(sd.shape, jnp.bfloat16),
                          v=jnp.zeros(sd.shape, jnp.bfloat16))
    step = jax.jit(lambda p, x, c, pos: jax_attn.decode_attention(
        p, x, c, pos, cfg, R, window=window))
    rng = np.random.default_rng(13)
    wo = np.abs(p_np["wo"])
    for i in range(8):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        pc = interop.cache_from_numpy(
            {"L": {"k": np.asarray(jc.k), "v": np.asarray(jc.v)}},
            CPU)["L"]
        q, k_new, v_new = pt_attn.qkv_project(
            pp, t(x), torch.full((2, 1), i), pcfg)
        want, jc = step(pj, jnp.asarray(x), jc, jnp.asarray(i))
        got, pc = pt_attn.decode_attention(pp, t(x), pc, i, pcfg,
                                           window=window)
        slot = i % length
        for f32, name in ((k_new, "k"), (v_new, "v")):
            g = getattr(pc, name)[:, :, slot].float().numpy()
            w = np.asarray(getattr(jc, name))[:, :, slot].astype(np.float32)
            diff = g != w
            if diff.any():
                assert_ties(g, w, f32[:, 0].numpy(), diff, f"{name} {i}")
        vmax = np.abs(np.asarray(jc.v).astype(np.float32)).max(axis=2)
        kmap = np.array(pt_attn.kv_expand_map(pt_attn.attn_dims(pcfg)))
        bound = 2.0 ** -8 * np.einsum("bhd,hdm->bm", vmax[:, kmap], wo)
        assert (np.abs(got.numpy()[:, 0] - np.asarray(want)[:, 0])
                <= bound + 1e-5).all(), i


@pytest.mark.parametrize("name", PREFILL_ARCHS)
def test_decode_matches_own_prefill(name):
    """The reference's own test on the port: its init (seed 1), an f32
    cache, rtol = atol = 2e-3."""
    cfg = pt_base.get_config(name).reduced()
    params = init_params(pt_api.model_param_defs(cfg),
                         torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = pt_api.build_forward_fn(cfg)(params, {"tokens": toks})
        cache = pt_api.init_cache_arrays(cfg, 2, S, CPU, torch.float32)
        dec = pt_api.build_decode_fn(cfg)
        outs = []
        for i in range(S):
            logits, cache = dec(params, toks[:, i:i + 1], cache, i)
            outs.append(logits[:, 0])
    v = cfg.vocab_size
    close(torch.stack(outs, 1)[..., :v], full[..., :v].numpy(), atol=2e-3,
          rtol=2e-3)


def test_whisper_decode_matches_decode_train_over_zero_cross_kv():
    """What chip_smoke's whisper gate holds: with the cross-KV left at
    zeros (as `serve_batch` leaves it), decode equals `decode_train` on
    an encoder output of zeros, below the 448 learned positions."""
    from repro_torch.models import whisper as pt_whisper

    cfg = pt_base.get_config("whisper-small").reduced()
    params = init_params(pt_api.model_param_defs(cfg),
                         torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        enc = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
        full = pt_whisper.decode_train(params, toks, enc, cfg)
        cache = pt_api.init_cache_arrays(cfg, 2, S, CPU, torch.float32)
        outs = [pt_whisper.decode_step(params, toks[:, i:i + 1], cache, i,
                                       cfg)[0][:, 0] for i in range(S)]
    close(torch.stack(outs, 1), full.numpy(), atol=2e-3, rtol=2e-3)


def test_decode_attention_expand_branch_matches():
    """6 query heads on 4 kv heads: the `kv_expand_map` form (every
    registered config takes the grouped form), windowed and not, with a
    softcap."""
    cfg, params, pcfg = pair("qwen1.5-0.5b", n_heads=6, n_kv_heads=4)
    p_np = jax.tree_util.tree_map(lambda a: a[0],
                                  params["blocks"]["L0"]["attn"])
    pj, pp = jnp_tree(p_np), interop.params_from_numpy(p_np, CPU)
    rng = np.random.default_rng(12)
    for window, length in ((None, S), (4, 4)):
        spec = pt_attn.KVCache.shape(pcfg, 2, length, torch.float32)
        sd = jax_attn.KVCache.shape(cfg, 2, length, R)
        assert spec.shape == sd.shape
        jc = jax_attn.KVCache(k=jnp.zeros(sd.shape), v=jnp.zeros(sd.shape))
        pc = pt_attn.KVCache(k=spec.zeros(), v=spec.zeros())
        step = jax.jit(lambda p, x, c, pos: jax_attn.decode_attention(
            p, x, c, pos, cfg, R, window=window, attn_softcap_val=30.0))
        for i in range(8):
            x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
            want, jc = step(pj, jnp.asarray(x), jc, jnp.asarray(i))
            got, pc = pt_attn.decode_attention(pp, t(x), pc, i, pcfg,
                                               window=window,
                                               attn_softcap_val=30.0)
            close(got, want, label=f"out {window} {i}")
            close(pc.k, jc.k, label=f"k {window} {i}")
            close(pc.v, jc.v, label=f"v {window} {i}")


def test_full_cache_refuses_a_position_past_its_end():
    cfg = pt_base.get_config("qwen1.5-0.5b").reduced()
    params = init_params(pt_api.model_param_defs(cfg),
                         torch.Generator().manual_seed(0))
    cache = pt_api.init_cache_arrays(cfg, 1, 4, CPU)
    with pytest.raises(ValueError, match="pos 4 outside the cache's 4"):
        pt_api.build_decode_fn(cfg)(params, torch.zeros((1, 1), dtype=torch.long),
                                    cache, 4)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_arrays_match_the_reference(name):
    """`init_cache_arrays`: the reference's tree, shapes and dtypes (bf16
    KV and cross-KV, f32 SSM state and conv tail), zeros; at full width
    `cache_spec` alone."""
    for reduce in (True, False):
        ref_cfg = jax_base.get_config(name)
        cfg = pt_base.get_config(name)
        if reduce:
            ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
        structs, _ = jax_api.cache_spec(ref_cfg, 2, 24, R)
        want = {f"{k}/{f}": sd for k, node in structs.items()
                for f, sd in node._asdict().items()}
        got = {k.replace("/.", "/"): v for k, v in
               flatten_names(pt_api.cache_spec(cfg, 2, 24)).items()}
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            assert str(got[k].dtype).split(".")[1] == \
                jnp.dtype(w.dtype).name, k
    cache = pt_api.init_cache_arrays(cfg, 2, 24, CPU)
    assert not any(x.any() for x in flatten_names(cache).values())


@pytest.mark.parametrize("name", ["whisper-small", "jamba-1.5-large-398b"])
def test_cache_crosses_both_ways_bit_for_bit(name):
    cfg = jax_base.get_config(name).reduced()
    rng = np.random.default_rng(5)
    tree = ref_cache_np(cfg, 2, 8, jnp.bfloat16.dtype)
    tree = {k: {f: rng.normal(size=a.shape).astype(a.dtype)
                for f, a in node.items()} for k, node in tree.items()}
    cache = interop.cache_from_numpy(tree, CPU)
    back = interop.cache_to_numpy(cache)
    assert back.keys() == tree.keys()
    for key, a in leaves(tree).items():
        b = leaves(back)[key]
        assert b.dtype == a.dtype and b.shape == a.shape, key
        assert a.tobytes() == b.tobytes(), key
    kinds = {type(node).__name__ for node in cache.values()}
    assert kinds == ({"KVCache"} if cfg.is_encoder_decoder
                     else {"KVCache", "SsmState"})


def test_serve_step_keeps_the_argmax_on_the_device():
    cfg = pt_base.get_config("qwen1.5-0.5b").reduced()
    params = init_params(pt_api.model_param_defs(cfg),
                         torch.Generator().manual_seed(0))
    toks = torch.tensor([[3], [5]])
    for greedy in (True, False):
        cache = pt_api.init_cache_arrays(cfg, 2, 4, CPU)
        nxt, logits, _ = build_serve_step(cfg, greedy)(params, toks,
                                                       cache, 0)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        want = logits[:, -1].argmax(-1)[:, None] if greedy else toks
        assert torch.equal(nxt, want.to(torch.int32))
        assert not logits.requires_grad


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-130m"])
def test_serve_batch_gives_the_reference_tokens(name):
    """8 prompt tokens and 8 new ones, the reference's bf16 cache, from
    the reference's own prompts."""
    cfg, params, pcfg = pair(name)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 cfg.vocab_size)
    want = np.asarray(jax_serve_batch(cfg, jnp_tree(params), prompts, 8,
                                      cache_len=16))
    got = serve_batch(pcfg, interop.params_from_numpy(params, CPU),
                      t(prompts), 8, cache_len=16, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :8].numpy(), np.asarray(prompts))


def test_cache_dtypes_follow_the_dtype_argument():
    cfg = pt_base.get_config("jamba-1.5-large-398b").reduced()
    cache = pt_api.init_cache_arrays(cfg, 1, 8, CPU, torch.float32)
    assert {x.dtype for x in flatten_names(cache).values()} == {
        torch.float32}
    cache = pt_api.init_cache_arrays(cfg, 1, 8, CPU)
    dts = {k: x.dtype for k, x in flatten_names(cache).items()}
    assert dts["L0/.k"] == torch.bfloat16 and dts["L1/.s"] == torch.float32
    assert dataclasses.is_dataclass(pt_api.cache_spec(cfg, 1, 8)["L0"].k)
