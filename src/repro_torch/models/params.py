"""Abstract parameter definitions and the parameter tree's names.

The port's copy of `repro.models.params`. A `PDef` holds a parameter's
shape, logical axes and init recipe; `init_params` materializes a
nested dict of tensors from a tree of them. The same tree gives the
three sharding views of the reference: `param_structs` (`TensorSpec`s,
no allocation), `param_specs` (each leaf's spec under a
`ShardingRules`) and `param_shardings` (its DTensor placements on a
`DeviceMesh`); `distribute_params` lays a tree of tensors out by those
placements, leaf by leaf, as the reference's ``jax.device_put(params,
shardings)`` does.

Parameters are nested dicts of tensors with the reference's keys, so a
leaf's name — its dict keys joined by ``/``, e.g. ``blocks/L0/attn/wq``
with the leading layer axis kept — is its pytree path in the JAX
package. `flatten_names` gives those names in JAX's flattening order
(dict keys sorted, a `NamedTuple`'s fields in order as ``.field``), and
`unflatten_names` inverts it for dicts. The checkpoint and the
cross-package carry (`repro_torch.interop`) are this one name map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import distribute_tensor


@dataclasses.dataclass(frozen=True)
class PDef:
    """Abstract parameter: shape + logical axes + init recipe."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PDef: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def flatten_names(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict / NamedTuple tree by their JAX pytree
    names, in JAX's flattening order."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_names(sub, f"{prefix}/{key}" if prefix else key))
    return out


def unflatten_names(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` → ``{"a": {"b": x}}`` (dicts only)."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict / `NamedTuple` tree."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype without its data: the port's
    counterpart of ``jax.ShapeDtypeStruct`` in the cache specs."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


def init_params(defs, generator: torch.Generator, device=None):
    """Materialize float32 weights from a tree of `PDef`s.

    The reference's recipe as written, including its fan-in:
    ``fan_in = shape[0]`` for every leaf of rank > 1, which for a
    layer-stacked ``(L, d, ...)`` weight is the layer count L, not d
    (`src/repro/models/params.py:44`). Leaves draw from one generator in
    the flattening order; the values differ from JAX's threefry draws.
    """
    names = flatten_names(defs)
    leaves = {}
    for name, d in names.items():
        if d.init == "zeros":
            leaves[name] = torch.zeros(d.shape, device=device)
        elif d.init == "ones":
            leaves[name] = torch.ones(d.shape, device=device)
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            scale = d.scale if d.scale is not None \
                else 1.0 / math.sqrt(max(fan_in, 1))
            leaves[name] = torch.randn(d.shape, generator=generator,
                                       device=device) * scale
    return unflatten_names(leaves)


def param_structs(defs, dtype: torch.dtype = torch.bfloat16):
    """The tree of `TensorSpec`s of ``defs`` in ``dtype``."""
    return map_tree(lambda d: TensorSpec(tuple(d.shape), dtype), defs)


def param_specs(defs, rules):
    """Each leaf's spec (a tuple, one entry a dimension) under
    ``rules``."""
    return map_tree(lambda d: rules.spec_for(d.axes), defs)


def param_shardings(defs, mesh, rules):
    """Each leaf's `NamedSharding` (placements) on ``mesh``."""
    from repro_torch.distributed.sharding import named_sharding

    return map_tree(lambda d: named_sharding(mesh, rules, d.axes), defs)


def distribute_params(params, shardings):
    """``distribute_tensor`` of every leaf of ``params`` by the matching
    `NamedSharding` of ``shardings`` (a tree of the same keys). Every
    rank holds the whole tree (drawn from one seed, or loaded) and cuts
    its own shard: no collective, as ``jax.device_put`` of host arrays
    runs none."""
    flat_s = flatten_names(shardings)
    return unflatten_names({
        k: distribute_tensor(v, flat_s[k].mesh, list(flat_s[k].placements),
                             src_data_rank=None)
        for k, v in flatten_names(params).items()})


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for d in flatten_names(defs).values()))
