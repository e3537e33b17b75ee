"""Multi-pod dry run on the meta device: every (arch × shape × mesh) cell.

The port's copy of `repro.launch.dryrun`. Where the reference lowers and
compiles each cell for 512 placeholder TPU devices, a cell here runs the
train step, the forward or the serve step of an architecture eagerly on
``device="meta"`` parameters, optimizer state and inputs (no data, no
allocation), laid out as DTensors by `param_shardings` and
`input_logical_axes` on `make_production_mesh` over a *fake* process
group of 256 or 512 ranks (``torch.testing._internal.distributed.
fake_pg``; if that module is missing the dry run fails by name). This
process plays rank 0; `launch.op_analysis` counts what that rank
computes, moves and allocates:

- FLOPs, bytes and collective bytes per device, op by op on the local
  shards. The layer loop is eager, so a cell counts its model at one
  and at two periods and extrapolates linearly to ``n_periods`` (the
  reference multiplies a ``while`` body by its trip count), after one
  uncounted run at one period: DTensor's first run of an op schema
  runs ops of its own that later runs do not repeat. A train
  cell counts one microbatch's loss and gradients and multiplies by
  the microbatch count, then adds one accumulation pass and one AdamW
  update of the full parameter tree.
- Memory per device: the arguments (parameters, optimizer state and
  inputs) from their local shard bytes, exactly; the temporaries from
  the peak of live bytes the run allocated (extrapolated the same way;
  a train cell's the larger of its backward's, with the gradient
  accumulator beside it under microbatches, and its update's, with the
  gradients beside it); the peak as arguments + temporaries, as the
  reference's ``mem_peak_gb``.

The roofline constants are one H100's, datasheet figures for "NVIDIA
H100 80GB HBM3, 700 W" (SXM): 989 TFLOP/s dense bf16, 3.35 TB/s of
HBM3, 450 GB/s of NVLink a direction; ``fits_hbm`` is against 80 GB, or
the card's ``total_memory`` where one is present. The meshes stay the
reference's 16×16 and 2×16×16 so that the cells compare one for one: on
H100s 16×16 is 32 nodes of 8 cards, so a collective that crosses nodes
runs on the network, not on NVLink, and its term here is a lower bound.
The multi-pod mesh folds ("pod", "data") into one axis for DTensor
(`distributed.sharding.fold_pods`): same layouts, one collective over
the pair instead of two.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --both-meshes [--out results.jsonl]

The numbers are estimates against datasheet peaks, not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.archs import ARCH_IDS
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.distributed.sharding import (fold_pods, multi_pod_rules,
                                              named_sharding,
                                              single_pod_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import COLLECTIVES, analyze, tree_bytes
from repro_torch.models.api import (build_forward_fn, build_loss_fn,
                                    input_logical_axes, input_specs,
                                    model_param_defs, spmd)
from repro_torch.models.params import (count_params, flatten_names,
                                       map_tree, param_shardings,
                                       unflatten_names)
from repro_torch.models.transformer import period_structure
from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_update
from repro_torch.train.step import build_serve_step

# One H100 SXM (NVIDIA H100 80GB HBM3, 700 W), datasheet peaks.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense
HBM_BW = 3.35e12          # B/s
NVLINK_BW = 450e9         # B/s a direction
HBM_BYTES = 80e9


class DryRunError(RuntimeError):
    """The dry run cannot start (no fake process group)."""


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """The assignment's skip rules (the reference's)."""
    if shape.name == "long_500k":
        runnable = (cfg.family in ("ssm", "hybrid")
                    or (cfg.sliding_window and not cfg.local_global_period))
        if not runnable:
            return ("full-attention arch: 500k decode requires "
                    "sub-quadratic attention (DESIGN.md §5)")
    if cfg.is_encoder_decoder and shape.name == "long_500k":
        return "enc-dec audio arch: 500k decode not meaningful"
    return None


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks
    (this process is rank 0), replacing any other."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise DryRunError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            f"(a fake process group), which this torch lacks: {e}") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(shape: Sequence[int], multi_pod: bool):
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(math.prod(shape))
    if tuple(shape) == ((2, 16, 16) if multi_pod else (16, 16)):
        return make_production_mesh(multi_pod=multi_pod)
    names = ("pod", "data", "model") if len(shape) == 3 \
        else ("data", "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _meta_tree(specs, axes, mesh, rules, dtype=None):
    """DTensors on the meta device for a tree of `TensorSpec`s laid out
    by the matching tree of logical axes."""
    from torch.distributed.tensor import distribute_tensor

    flat_s, flat_a = flatten_names(specs), flatten_names(axes)

    def one(name):
        spec = flat_s[name]
        t = torch.empty(spec.shape, dtype=dtype or spec.dtype,
                        device="meta")
        pl = named_sharding(mesh, rules, flat_a[name]).placements
        return distribute_tensor(t, mesh, list(pl))

    leaves = {k: one(k) for k in flat_s}
    return _rebuild(specs, leaves)


def _rebuild(tree, leaves, prefix=""):
    """``tree``'s structure (dicts and NamedTuples) over named leaves."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves,
                                     f"{prefix}/.{f}")
                            for f in tree._fields))
    return leaves[prefix]


def _meta_params(cfg, mesh, rules, dtype=torch.bfloat16):
    from torch.distributed.tensor import distribute_tensor

    defs = model_param_defs(cfg, rules)
    sh = flatten_names(param_shardings(defs, mesh, rules))
    return unflatten_names({
        k: distribute_tensor(torch.empty(d.shape, dtype=dtype,
                                         device="meta"),
                             mesh, list(sh[k].placements))
        for k, d in flatten_names(defs).items()})


def _depth(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` periods (whisper: k encoder and k decoder
    layers)."""
    p, _ = period_structure(cfg)
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, n_layers=k, n_encoder_layers=k)
    return dataclasses.replace(cfg, n_layers=k * p)


def _n_periods(cfg: ModelConfig) -> int:
    if cfg.is_encoder_decoder:
        if cfg.n_encoder_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: the period count needs as many "
                             "encoder as decoder layers")
        return cfg.n_layers
    p, _ = period_structure(cfg)
    return cfg.n_layers // p


def _extrapolate(c1: Dict, c2: Dict, n: int) -> Dict:
    """Counts at ``n`` periods from counts at one and two: linear in the
    periods, the peak too (what one period leaves live for the next,
    its saved activations under training; nothing at inference)."""
    def lin(a, b):
        return a + (n - 1) * (b - a)
    return {"flops": lin(c1["flops"], c2["flops"]),
            "bytes": lin(c1["bytes"], c2["bytes"]),
            "collectives": {k: lin(c1["collectives"][k],
                                   c2["collectives"][k])
                            for k in COLLECTIVES},
            "peak_bytes": lin(c1["peak_bytes"], c2["peak_bytes"]),
            "n_ops": lin(c1["n_ops"], c2["n_ops"])}


def _scaled(c: Dict, m: float) -> Dict:
    return {"flops": c["flops"] * m, "bytes": c["bytes"] * m,
            "collectives": {k: v * m for k, v in c["collectives"].items()},
            "peak_bytes": c["peak_bytes"], "n_ops": c["n_ops"] * m}


def _plus(a: Dict, b: Dict) -> Dict:
    return {"flops": a["flops"] + b["flops"],
            "bytes": a["bytes"] + b["bytes"],
            "collectives": {k: a["collectives"][k] + b["collectives"][k]
                            for k in COLLECTIVES},
            "peak_bytes": max(a["peak_bytes"], b["peak_bytes"]),
            "n_ops": a["n_ops"] + b["n_ops"]}


def _inputs(cfg, shape, mesh, rules, batch_replicated: bool, rows=None):
    """Meta DTensor inputs of this cell (``rows``: the global batch of a
    microbatch instead of the cell's)."""
    if rows is not None:
        shape = dataclasses.replace(shape, global_batch=rows)
    specs = input_specs(cfg, shape, rules)
    axes = input_logical_axes(cfg, shape, rules)
    if batch_replicated:
        axes = _unbatch(axes)
    if shape.kind == "decode":
        pos = specs.pop("pos")
        axes.pop("pos")
        out = _meta_tree(specs, axes, mesh, rules)
        out["pos"] = pos
        return out
    return _meta_tree(specs, axes, mesh, rules)


def _unbatch(axes):
    """Logical axes with "batch" replaced by None (a replicated batch)."""
    if isinstance(axes, dict):
        return {k: _unbatch(v) for k, v in axes.items()}
    if isinstance(axes, tuple) and hasattr(axes, "_fields"):
        return type(axes)(*(_unbatch(v) for v in axes))
    return tuple(None if x == "batch" else x for x in axes)


def _grad_fn(cfg, rules):
    loss_fn = build_loss_fn(cfg, rules=rules)

    def grads(params, batch):
        flat = {k: v.detach().requires_grad_(True)
                for k, v in flatten_names(params).items()}
        with spmd(flat):
            loss = loss_fn(unflatten_names(flat), batch)
            # whisper's learned decoder positions go unused above 448
            gs = torch.autograd.grad(loss, list(flat.values()),
                                     allow_unused=True)
        return loss.detach(), gs

    return grads


def _count(cfg, shape, mesh, rules, batch_replicated, k,
           micro_rows, param_dtype=torch.bfloat16) -> Dict:
    """One run of the cell's work at ``k`` periods, counted."""
    ck = _depth(cfg, k)
    params = _meta_params(ck, mesh, rules, param_dtype)
    if shape.kind == "train":
        batch = _inputs(ck, shape, mesh, rules, batch_replicated,
                        rows=micro_rows)
        return analyze(_grad_fn(ck, rules), params, batch)
    if shape.kind == "prefill":
        batch = _inputs(ck, shape, mesh, rules, batch_replicated)
        fwd = build_forward_fn(ck, rules=rules)
        with torch.no_grad():
            return analyze(fwd, params, batch)
    ins = _inputs(ck, shape, mesh, rules, batch_replicated)
    serve = build_serve_step(ck, rules=rules)
    # position 0: this rank (rank 0) holds the slot the step writes
    return analyze(serve, params, ins["tokens"], ins["cache"], 0)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                verbose: bool = True, n_microbatches: int = 0,
                triangular: bool = False, remat_policy: str = "full",
                serve_resident: bool = False, bf16_norms: bool = False,
                cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None,
                mesh_shape: Optional[Sequence[int]] = None,
                tp: int = 16,
                param_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """One cell → the reference's result keys (and ``n_ops``,
    ``count_s`` and the argument bytes by part: ``mem_param_bytes``,
    ``mem_opt_bytes`` (both moments), ``mem_step_bytes``,
    ``mem_input_bytes``). ``cfg`` / ``shape`` / ``mesh_shape`` / ``tp``
    / ``param_dtype`` replace the registry's config, the named shape,
    the production mesh, the TP degree of the rules and the reference's
    bf16 parameters (tests and the card's cross-check run cut
    cells)."""
    cfg = cfg or get_config(arch)
    if triangular or remat_policy != "full" or bf16_norms:
        cfg = dataclasses.replace(cfg, flash_triangular=triangular,
                                  remat_policy=remat_policy,
                                  norm_f32=not bf16_norms)
    shape = shape or SHAPES[shape_name]
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    result: Dict = {"arch": arch, "shape": shape.name,
                    "mesh": "x".join(str(s) for s in mesh_shape)}
    reason = skip_reason(cfg, shape)
    if reason:
        result.update(status="SKIP", reason=reason)
        return result

    mesh = _mesh(mesh_shape, multi_pod)
    n_chips = mesh.size()
    rules = multi_pod_rules(tp) if multi_pod else single_pod_rules(tp)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    batch_shards = math.prod(sizes[ax] for ax in rules.batch)
    batch_replicated = shape.global_batch % batch_shards != 0
    if batch_replicated:
        rules = dataclasses.replace(rules, batch=())
        if shape.kind == "decode":
            # idle data axis -> spread the KV sequence over (data, model)
            rules = dataclasses.replace(rules, seq_kv_over_data=True)
    if serve_resident and shape.kind == "decode":
        rules = dataclasses.replace(rules, fsdp=None)
    mesh, rules = fold_pods(mesh, rules)

    defs = model_param_defs(cfg, rules)
    n_params = count_params(defs)
    t0 = time.time()
    n = _n_periods(cfg)
    full_params = _meta_params(cfg, mesh, rules, param_dtype)
    parts = {"param": tree_bytes(full_params), "opt": 0, "step": 0}
    micro = 1
    if shape.kind == "train":
        big = n_params > 100e9  # bf16 optimizer state tier
        mdt = torch.bfloat16 if big else torch.float32
        rows_per_dev = max(shape.global_batch // batch_shards, 1)
        default_micro = rows_per_dev if big else max(1, rows_per_dev // 2)
        micro = n_microbatches or max(1, min(default_micro, 16))
        while shape.global_batch % (micro * batch_shards) and micro > 1:
            micro -= 1
        result["n_microbatches"] = micro
    micro_rows = shape.global_batch // micro
    # one uncounted run at one period first (see the module docstring)
    _, c1, c2 = (_count(cfg, shape, mesh, rules, batch_replicated, k,
                        micro_rows, param_dtype) for k in (1, 1, 2))
    counts = _scaled(_extrapolate(c1, c2, n), micro)
    inputs = _inputs(cfg, shape, mesh, rules, batch_replicated)
    parts["input"] = tree_bytes({k: v for k, v in inputs.items()
                                 if k != "pos"})
    if shape.kind == "train":
        opt = AdamWState(
            step=torch.zeros((), dtype=torch.int32, device="meta"),
            mu=map_tree(lambda p: torch.zeros_like(p, dtype=mdt),
                        full_params),
            nu=map_tree(lambda p: torch.zeros_like(p, dtype=mdt),
                        full_params))
        parts["opt"] = tree_bytes((opt.mu, opt.nu))
        parts["step"] = tree_bytes(opt.step)
        grads = map_tree(lambda p: torch.zeros_like(p, dtype=mdt),
                         full_params)

        def acc_and_update():
            with spmd(full_params):
                if micro > 1:
                    map_tree(lambda g: g + g, grads)
                return apply_update(full_params, grads, opt, AdamWConfig())

        # the update runs while the gradients are live; with microbatches
        # the accumulator is live through every microbatch's backward
        update = analyze(acc_and_update)
        grad_bytes = tree_bytes(grads)
        if micro > 1:
            counts["peak_bytes"] += grad_bytes
        update["peak_bytes"] += grad_bytes
        counts = _plus(counts, update)
    count_s = time.time() - t0
    args_bytes = sum(parts.values())

    flops = float(counts["flops"])
    bytes_hbm = float(counts["bytes"])
    coll = {k: float(v) for k, v in counts["collectives"].items()}
    coll_total = float(sum(coll.values()))
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    flops_per_tok = (6.0 if shape.kind == "train" else 2.0) \
        * cfg.n_active_params()
    model_flops_per_device = flops_per_tok * tokens / n_chips
    temp = float(counts["peak_bytes"])
    hbm = torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else HBM_BYTES
    result.update(
        status="OK",
        n_chips=n_chips,
        n_params=n_params,
        count_s=round(count_s, 2),
        n_ops=int(counts["n_ops"]),
        device_flops=flops,
        device_bytes=bytes_hbm,
        model_flops_per_device=model_flops_per_device,
        useful_flops_ratio=(model_flops_per_device / flops) if flops else 0.0,
        collective_bytes=coll,
        collective_total=coll_total,
        compute_term_s=flops / PEAK_FLOPS_BF16,
        memory_term_s=bytes_hbm / HBM_BW,
        collective_term_s=coll_total / NVLINK_BW,
        mem_args_bytes=int(args_bytes),
        **{f"mem_{k}_bytes": int(v) for k, v in parts.items()},
        mem_args_gb=round(args_bytes / 2**30, 3),
        mem_temp_gb=round(temp / 2**30, 3),
        mem_peak_gb=round((args_bytes + temp) / 2**30, 3),
        fits_hbm=bool(args_bytes + temp <= hbm),
        batch_replicated=batch_replicated,
    )
    terms = {"compute": result["compute_term_s"],
             "memory": result["memory_term_s"],
             "collective": result["collective_term_s"]}
    result["bottleneck"] = max(terms, key=terms.get)
    if verbose:
        print(json.dumps(result, indent=None, default=str), flush=True)
    return result


def _cell(job):
    """One cell in a worker process; a failure is a FAIL row."""
    arch, shape, mp, kw = job
    try:
        return dryrun_cell(arch, shape, multi_pod=mp, verbose=False, **kw)
    except DryRunError:
        raise
    except Exception as e:  # a failure here is a bug
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "FAIL", "error": repr(e)[:500]}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FINGER framework dry run "
                                             "on the meta device")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="write JSONL results here")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--triangular", action="store_true")
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--serve-resident", action="store_true")
    ap.add_argument("--bf16-norms", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each cell runs in a fresh one)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    kw = dict(n_microbatches=args.microbatches, triangular=args.triangular,
              remat_policy=args.remat_policy,
              serve_resident=args.serve_resident,
              bf16_norms=args.bf16_norms)
    jobs = [(a, s, mp, kw) for a in archs for s in shapes for mp in meshes]

    t0 = time.time()
    # a process a cell: a default process group cannot be replaced once
    # a mesh has been built on it; a SKIP cell builds none and is made
    # here
    import concurrent.futures as cf
    import multiprocessing as mp_

    skip = [skip_reason(get_config(a), SHAPES[s]) is not None
            for a, s, _, _ in jobs]
    with cf.ProcessPoolExecutor(max(args.jobs, 1), max_tasks_per_child=1,
                                mp_context=mp_.get_context("spawn")) as pool:
        counted = pool.map(_cell, [j for j, s in zip(jobs, skip) if not s])
        results = _report((_cell(j) if s else next(counted)
                           for j, s in zip(jobs, skip)), args.out)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} OK, "
          f"{sum(r['status'] == 'SKIP' for r in results)} SKIP, "
          f"{n_fail} FAIL in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


def _report(rows, out):
    """Print each row as it comes (in the cells' order), append it to
    ``out``; → the rows."""
    results = []
    for r in rows:
        print(json.dumps(r, default=str), flush=True,
              file=sys.stderr if r["status"] == "FAIL" else sys.stdout)
        results.append(r)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(r, default=str) + "\n")
    return results


if __name__ == "__main__":
    sys.exit(main())
