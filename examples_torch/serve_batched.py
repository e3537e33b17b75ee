"""Batched serving example: greedy decoding with KV caches for a batch of
requests on a reduced qwen model.

The twin of `examples/serve_batched.py`, with its flags, on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples_torch/serve_batched.py --batch 4 \\
        --max-new 24 --device cpu

Like the reference, it runs no FINGER telemetry: `serve_batch` decodes
and nothing else.
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models.api import model_param_defs
from repro_torch.models.params import init_params


def main(argv=None, params=None, prompts=None) -> torch.Tensor:
    """Decode, print the reference's lines and return the (batch,
    prompt + new) tokens. ``params`` and ``prompts`` replace the seeded
    draws (the tests pass the reference's threefry ones)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen1.5-0.5b").reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if params is None:
        params = init_params(model_param_defs(cfg), gen, device=device)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen, device=device)
    t0 = time.time()
    seqs = serve_batch(cfg, params, prompts, args.max_new,
                       cache_len=args.prompt_len + args.max_new,
                       device=device).cpu()
    dt = time.time() - t0
    toks = args.batch * (args.prompt_len + args.max_new)
    print(f"decoded {seqs.shape[0]} requests x {seqs.shape[1]} tokens "
          f"in {dt:.2f}s ({toks/dt:.0f} tok/s incl. compile)")
    for i in range(args.batch):
        # seqs is on the host already
        print(f"  req{i}: {seqs[i].tolist()}")  # lint: disable=per-item-host-sync
    return seqs


if __name__ == "__main__":
    main()
