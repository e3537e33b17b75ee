"""Serving launcher: batched greedy decoding with KV caches.

The port's copy of `repro.launch.serve`, on CUDA unless told
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

The reference's docstring says that it also runs "FINGER
attention-entropy telemetry per request batch", but its `serve_batch`
runs none; the port does what the reference does, and runs no
telemetry (and so launches no kernel of its own). The prompt is fed
through the decode path one token at a time, as the reference's
simple server does, and the loop copies nothing to the host until the
tokens are joined at the end.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import NO_SHARDING, ShardingRules
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models.api import init_cache_arrays, model_param_defs
from repro_torch.models.params import init_params
from repro_torch.train.step import build_serve_step

CACHE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def serve_batch(cfg, params, prompts: torch.Tensor, max_new: int,
                cache_len: int, device: Device = None,
                cache_dtype: torch.dtype = torch.bfloat16,
                rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """Greedy-decode ``max_new`` tokens for a batch of equal-length
    prompts (B, P) → (B, P + max_new) int32 on ``device`` (``None`` is
    CUDA); the cache holds ``cache_len`` positions in ``cache_dtype``
    (the reference's bf16 by default). ``rules`` are the parameters'
    `ShardingRules` (their padded shapes); the cache is plain."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    prompts = prompts.to(device=device, dtype=torch.int32)
    b, prompt_len = prompts.shape
    serve = build_serve_step(cfg, rules=rules)
    cache = init_cache_arrays(cfg, b, cache_len, device, cache_dtype,
                              rules)
    tok = prompts[:, :1]
    out = [tok]
    for t in range(prompt_len + max_new - 1):
        nxt, _, cache = serve(params, tok, cache, t)
        tok = prompts[:, t + 1:t + 2] if t + 1 < prompt_len else nxt
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", choices=sorted(CACHE_DTYPES),
                    default="bf16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_param_defs(cfg), gen, device=device)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device, dtype=torch.int32)
    t0 = time.time()
    seqs = serve_batch(cfg, params, prompts, args.max_new,
                       cache_len=args.prompt_len + args.max_new,
                       device=device,
                       cache_dtype=CACHE_DTYPES[args.cache_dtype])
    sample = seqs[0][:16].tolist()  # joins the device work
    dt = time.time() - t0
    n_tok = args.batch * (args.prompt_len + args.max_new)
    print(f"decoded {tuple(seqs.shape)} in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s); sample: {sample}")
    return seqs


if __name__ == "__main__":
    main()
