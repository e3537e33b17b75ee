"""Training launcher: the end-to-end driver with checkpointing, resume,
FINGER telemetry and straggler monitoring.

The port's copy of `repro.launch.train`. It runs on CUDA unless the
caller passes ``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --reduced --steps 6 --device cpu

Each step's record holds the reference's fields (``loss``,
``grad_norm``, ``straggler`` and, on probe steps,
``attn_entropy_mean`` and ``routing_jsdist``) plus ``step_ms``: the
step's time on the card (CUDA events around the step function) or on
the host clock on the CPU, which also feeds the straggler monitor. On
CUDA the attention probe launches the ``entropy_probe`` kernels and
the routing tracker the ``vnge_q`` kernel (three launches an update
after the first graph); an attention-free model has no attention
probe, a model without experts no routing graph, and an
encoder–decoder runs neither (as in the reference). Float32 matmuls
run without TF32.
``--compress-grads`` (``compress=True``) trains with int8
error-feedback gradient compression, its residuals carried across
steps, as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.distributed.compression import init_residuals
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models.api import model_param_defs
from repro_torch.models.params import count_params, init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.fault_tolerance import StragglerMonitor, maybe_resume
from repro_torch.train.step import build_train_step
from repro_torch.train.telemetry import (RoutingGraphTracker,
                                         attention_entropy_probe,
                                         routing_graph)


def _timed(fn, device: torch.device):
    """(fn's result, its milliseconds on the card or the host)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def run(cfg, steps: int, batch_size: int, seq: int, ckpt_dir=None,
        ckpt_every: int = 50, probe_every: int = 10, seed: int = 0,
        compress: bool = False, lr: float = 1e-3, log=print,
        device: Device = None):
    """Train ``steps`` steps → (params, opt_state, history)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    defs = model_param_defs(cfg)
    log(f"model {cfg.name}: {count_params(defs)/1e6:.1f}M params")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(defs, gen, device=device)
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)
    opt_state = init_state(params)

    start_step = 0
    if ckpt_dir:
        restored, start_step = maybe_resume(
            ckpt_dir, {"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            log(f"resumed from step {start_step}")

    residuals = init_residuals(params) if compress else None
    step_fn = build_train_step(cfg, opt_cfg, compress_grads=compress)

    def step_once(batch):
        nonlocal params, opt_state, residuals
        if compress:
            params, opt_state, residuals, metrics = step_fn(
                params, opt_state, residuals, batch)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        return metrics

    monitor = StragglerMonitor()
    tracker = RoutingGraphTracker()
    history = []
    for step in range(start_step, steps):
        batch = synthetic_batch(cfg, batch_size, seq, seed, step, device)
        metrics, ms = _timed(lambda: step_once(batch), device)
        straggler = monitor.stop(ms / 1e3)
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "straggler": straggler, "step_ms": ms}
        if probe_every and step % probe_every == 0 \
                and not cfg.is_encoder_decoder:
            ent = attention_entropy_probe(params, batch["tokens"], cfg,
                                          probe_len=min(seq, 128))
            if ent is not None:
                # probe metric: one deliberate sync per probe step
                rec["attn_entropy_mean"] = float(ent.mean())  # lint: disable=per-item-host-sync
            d = tracker.update(routing_graph(params, batch, cfg), step)
            if d is not None:
                rec["routing_jsdist"] = d
        history.append(rec)
        if step % max(1, steps // 20) == 0 or step == steps - 1:
            log(json.dumps(rec))
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            metadata={"arch": cfg.name})
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": params, "opt": opt_state},
                        metadata={"arch": cfg.name})
    return params, opt_state, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--probe-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    t0 = time.time()
    _, _, history = run(cfg, args.steps, args.batch, args.seq,
                        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        probe_every=args.probe_every,
                        compress=args.compress_grads, lr=args.lr,
                        device=args.device)
    print(f"done in {time.time()-t0:.1f}s; "
          f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
