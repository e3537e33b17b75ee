"""End-to-end training driver with FINGER telemetry on the port.

Trains a granite-family MoE LM (reduced config by default;
``--hundred-m`` for a ~100M-param variant) with checkpointing, resume,
straggler monitoring, and the two FINGER probes:
 - per-head attention-graph entropy (H̃ of the softmax graph; the
   ``entropy_probe`` kernels on the card)
 - routing-graph JS distance between consecutive steps (anomaly
   tracker; the ``vnge_q`` kernel on the card)

The twin of `examples/train_with_entropy_probe.py`, with its flags, on
the card unless ``--device cpu``:

    PYTHONPATH=src python examples_torch/train_with_entropy_probe.py \\
        --steps 40 --batch 8 --seq 64
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.launch.train import run


def main(argv=None) -> list:
    """Train, print the loss trajectory and the routing-graph JS
    distances; return the step records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "finger_ckpt"))
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M-param config (slower on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)

    cfg = get_config("granite-moe-3b-a800m").reduced()
    if args.hundred_m:
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
            d_ff=256, n_experts=8, top_k=2, vocab_size=32768, head_dim=64)
    _, _, history = run(cfg, args.steps, args.batch, args.seq,
                        ckpt_dir=args.ckpt_dir, ckpt_every=20,
                        probe_every=5, lr=3e-3, device=args.device)
    print("\nloss trajectory:",
          " -> ".join(f"{h['loss']:.3f}"
                      for h in history[:: max(1, len(history) // 8)]))
    probes = [h for h in history if "routing_jsdist" in h]
    if probes:
        print("routing-graph JS distances:",
              " ".join(f"{h['routing_jsdist']:.4f}" for h in probes))
    return history


if __name__ == "__main__":
    main()
