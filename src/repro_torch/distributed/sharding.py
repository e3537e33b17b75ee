"""A named grid of devices, and values split by rows over its shards.

The port's counterpart of the mesh half of `repro.distributed.sharding`
(`jax.sharding.Mesh`, `jax.make_mesh` and the stream-axis
`PartitionSpec`). The serving placements keep one controller: one
process owns every shard and launches each shard's work on its device,
so the grid is a plain array of `torch.device`s with axis names, not a
`torch.distributed` device mesh (which needs a process per device).

- ``DeviceGrid(devices, axis_names)`` / ``make_grid(shape, axis_names,
  devices=None)``: an n-dimensional array of devices. A device may
  repeat: four shards on ``cuda:0`` are four logical shards on one
  card, and CPU grids (``devices="cpu"``) run the same code.
- ``Sharded``: a stacked value (a state, a delta, a score vector) split
  along its leading stream axis into equal row blocks, block i on the
  grid's i-th shard device. Shards are ordered by the mixed-radix
  number over the sharded axes (``shard_index``), the order in which
  the reference's ``P(axes)`` partitions the stream axis, so block i
  holds global rows ``[i·rows, (i+1)·rows)``.
- ``each(fn, x)`` applies ``fn`` to every block of a `Sharded` (or to
  ``x`` itself), ``split_rows`` / ``concat_rows`` move between the two
  forms.

The model-sharding half of the reference module is here too, on a
`torch.distributed` `DeviceMesh` (one process a rank):

- ``ShardingRules``: logical axis name → mesh axis (or axes, or None),
  with the reference's fields and ``spec_for`` logic. A spec is a tuple
  with one entry per tensor dimension, each ``None``, a mesh-axis name
  or a tuple of names, entry for entry the reference's
  ``PartitionSpec``.
- ``NO_SHARDING``, ``single_pod_rules``, ``multi_pod_rules`` and the
  padding helpers ``pad_to_multiple``, ``padded_vocab``,
  ``effective_heads``, ``kv_heads_shardable``, as the reference writes
  them.
- ``named_sharding(mesh, rules, axes)``: a spec as DTensor placements.
  A tensor dimension split over several mesh axes gets ``Shard(d)`` on
  each, in mesh order, so its row blocks follow the mixed-radix order
  of ``P(("pod", "data"))``.
- ``constrain(x, rules, axes)``: ``redistribute`` of a DTensor to those
  placements (the reference's ``with_sharding_constraint``); a no-op on
  a plain tensor and where the reference's is.

Parallelism encoded by the rules (the reference's):

  DP   : "batch"  → ("pod", "data")      activation batch axis
  FSDP : "embed"  → "data"               params sharded at rest
  TP   : "heads"/"ff"/"vocab" → "model"  Megatron column/row splits
  EP   : "experts" → "model"             expert parallelism for MoE
  SP   : "seq_kv" → "model"              sequence-sharded KV cache

The reference's ``shard_map`` helper has no counterpart: distributed
FINGER runs one process a rank (`finger_dist`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.dispatch import Device, resolve_device

Axes = Union[str, Sequence[str]]


def shard_index(coords: Sequence[int], sizes: Sequence[int]) -> int:
    """The linear shard number of grid coordinates ``coords`` over axes
    of ``sizes``: the mixed-radix number, leading axis most
    significant."""
    out = 0
    for c, s in zip(coords, sizes):
        out = out * int(s) + int(c)
    return out


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class DeviceGrid:
    """An n-dimensional array of devices with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"DeviceGrid: {arr.ndim}-d device array but "
                f"{len(names)} axis name(s) {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"DeviceGrid: repeated axis name in {names}")
        if arr.size == 0:
            raise ValueError("DeviceGrid: no devices")
        flat = [resolve_device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = names

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(f"grid axes {self.axis_names} carry no "
                           f"{axis!r} axis")
        return int(self.devices.shape[self.axis_names.index(axis)])

    def shard_devices(self, axes: Axes) -> List[torch.device]:
        """The devices of the shards over ``axes``, in mixed-radix order;
        an axis not named sits at its index 0 (the reference replicates
        over it; one controller needs one copy)."""
        axes = _axes(axes)
        for ax in axes:
            self.axis_size(ax)
        arr = self.devices
        for ax in reversed(self.axis_names):
            if ax not in axes:
                arr = np.take(arr, 0, axis=self.axis_names.index(ax))
        kept = [ax for ax in self.axis_names if ax in axes]
        arr = np.transpose(arr, [kept.index(ax) for ax in axes])
        return list(arr.reshape(-1))

    @property
    def key(self) -> tuple:
        """A hashable identity: shape, names and devices."""
        return (self.devices.shape, self.axis_names,
                tuple(str(d) for d in self.devices.reshape(-1)))

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceGrid) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        return f"DeviceGrid(shape={self.shape}, devices=" \
            f"{[str(d) for d in self.devices.reshape(-1)]})"


def make_grid(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> DeviceGrid:
    """A `DeviceGrid` of ``shape``. ``devices``: ``None`` takes every
    visible CUDA device (their count must equal the grid's size); one
    device (``"cuda:0"``, ``"cpu"``) fills every position with it, as
    logical shards; a sequence of prod(shape) devices fills the grid in
    C order."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"make_grid: shape {shape} needs {n} device(s), "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceGrid(arr.reshape(shape), axis_names)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A stacked value split by rows: ``parts[i]`` holds global rows
    ``[i·rows, (i+1)·rows)`` on shard i's device."""

    parts: Tuple[Any, ...]
    rows: int

    @property
    def num_shards(self) -> int:
        return len(self.parts)

    def map(self, fn: Callable[[Any], Any]) -> "Sharded":
        return Sharded(tuple(fn(p) for p in self.parts), self.rows)

    def locate(self, row: int) -> Tuple[int, int]:
        """Global row → (shard, row within the shard)."""
        return divmod(int(row), self.rows)


def each(fn: Callable[[Any], Any], x):
    """``fn`` on every block of a `Sharded`, or on ``x`` itself."""
    return x.map(fn) if isinstance(x, Sharded) else fn(x)


def _lead(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.shape[0])
    return int(next(iter(x.tensors().values())).shape[0])


def split_rows(x, devices: Sequence[torch.device]) -> Sharded:
    """Split a stacked tensor, state or delta along its leading axis
    into ``len(devices)`` equal blocks, each copied to its device (a
    block owns its storage, also where the device repeats or is the
    source's own)."""
    p = len(devices)
    b = _lead(x)
    if b % p:
        raise ValueError(f"split_rows: {b} rows do not split into {p} "
                         "equal blocks")
    rows = b // p

    def block(i: int):
        lo, dev = i * rows, devices[i]

        def cut(t: torch.Tensor) -> torch.Tensor:
            return t[lo:lo + rows].to(dev, copy=True)

        return cut(x) if isinstance(x, torch.Tensor) else x.map_tensors(cut)

    return Sharded(tuple(block(i) for i in range(p)), rows)


def concat_rows(x, device: Device = "cpu"):
    """The blocks of a `Sharded` joined along the leading axis on
    ``device`` (a tensor, or a state or delta with the first block's
    static fields); any other value is moved there whole."""
    dev = torch.device(device)
    if not isinstance(x, Sharded):
        return x.to(dev)
    first = x.parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(dev) for t in x.parts])
    return dataclasses.replace(first, **{
        k: torch.cat([p.tensors()[k].to(dev) for p in x.parts])
        for k in first.tensors()})


def device_context(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (a launch goes to
    the current device), a no-op context on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# --------------------------------------------------------------------------
# Model-sharding rules (the reference's logical axes on a DeviceMesh)
# --------------------------------------------------------------------------

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis name → physical mesh axis (or axes tuple, or None)."""

    batch: Tuple[str, ...] = ("data",)
    fsdp: object = "data"  # str, tuple of axes (HSDP across pods), or None
    tensor: Optional[str] = "model"
    tp_size: int = 1  # size of the tensor axis (for divisibility checks)
    # batch=1 long-context decode: the idle data axis joins the model
    # axis in sharding the KV sequence
    seq_kv_over_data: bool = False

    def spec_for(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        out = []
        for ax in logical_axes:
            if ax is None:
                out.append(None)
            elif ax == "batch":
                if not self.batch:
                    out.append(None)  # replicated batch (batch=1 cells)
                else:
                    out.append(self.batch if len(self.batch) > 1
                               else self.batch[0])
            elif ax in ("embed", "ff_data"):
                out.append(self.fsdp)
            elif ax == "seq_kv":
                if self.seq_kv_over_data and self.fsdp:
                    fs = self.fsdp if isinstance(self.fsdp, tuple) \
                        else (self.fsdp,)
                    out.append(fs + (self.tensor,))
                else:
                    out.append(self.tensor)
            elif ax in ("heads", "kv_heads", "ff", "vocab", "experts",
                        "d_inner"):
                out.append(self.tensor)
            elif ax in ("replicated", "layers"):
                out.append(None)
            else:
                raise ValueError(f"unknown logical axis {ax!r}")
        return tuple(out)


# Rules used when no mesh is active (single-device runs).
NO_SHARDING = ShardingRules(batch=("data",), fsdp=None, tensor=None,
                            tp_size=1)


def single_pod_rules(tp: int = 16) -> ShardingRules:
    return ShardingRules(batch=("data",), fsdp="data", tensor="model",
                         tp_size=tp)


def multi_pod_rules(tp: int = 16) -> ShardingRules:
    # params and optimizer state shard across both pods and the data
    # axis (HSDP)
    return ShardingRules(batch=("pod", "data"), fsdp=("pod", "data"),
                         tensor="model", tp_size=tp)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec laid onto a mesh: one DTensor placement per mesh axis."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    spec: Spec
    placements: Tuple[Any, ...]


def spec_placements(mesh_axes: Sequence[str], spec: Spec) -> tuple:
    """DTensor placements of ``spec`` over a mesh with axes
    ``mesh_axes``: ``Shard(d)`` on every mesh axis that tensor dimension
    d names (several in mesh order), ``Replicate()`` elsewhere."""
    mesh_axes = tuple(mesh_axes)
    out: List[Any] = [Replicate() for _ in mesh_axes]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = _axes(entry)
        for ax in names:
            if ax not in mesh_axes:
                raise ValueError(f"spec {spec} names mesh axis {ax!r}; "
                                 f"the mesh has {mesh_axes}")
        idx = [mesh_axes.index(ax) for ax in names]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec}: axes {names} of dimension {d} "
                             f"are not in the mesh's order {mesh_axes}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis "
                                 f"{mesh_axes[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def named_sharding(mesh, rules: ShardingRules,
                   logical_axes: Sequence[Optional[str]]) -> NamedSharding:
    spec = rules.spec_for(logical_axes)
    return NamedSharding(mesh, spec,
                         spec_placements(mesh.mesh_dim_names, spec))


def fold_pods(mesh, rules: ShardingRules):
    """(mesh, rules) with the "pod" and "data" axes folded into one
    ("data", pod-major), where the rules only ever name them together
    (`multi_pod_rules`); (mesh, rules) as they are otherwise.

    The folded mesh lays out every tensor as the pair does: a dimension
    split over ("pod", "data") splits over the folded axis in the same
    mixed-radix order. DTensor moves such a dimension with one
    collective over the folded group, as XLA does over the pair, where
    it would otherwise issue one a mesh axis, and its sharding search
    over a three-axis mesh takes minutes an op on the CPU.
    """
    names = tuple(mesh.mesh_dim_names)
    pair = ("pod", "data")
    groups = [rules.batch, rules.fsdp]
    if names[:2] != pair or any(g not in (pair, None, ()) for g in groups):
        return mesh, rules
    folded = DeviceMesh(mesh.device_type, mesh.mesh.reshape(
        -1, *mesh.mesh.shape[2:]), mesh_dim_names=("data",) + names[2:])
    return folded, dataclasses.replace(
        rules, batch=("data",) if rules.batch else (),
        fsdp="data" if rules.fsdp else None)


def _inactive(rules: Optional[ShardingRules]) -> bool:
    return rules is None or rules.tp_size == 1 and rules.fsdp is None


def constrain(x, rules: Optional[ShardingRules],
              logical_axes: Sequence[Optional[str]]):
    """``x`` redistributed to the rules' placements of ``logical_axes``
    when it is a DTensor and the rules shard anything; ``x`` itself
    otherwise."""
    if _inactive(rules) or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = spec_placements(mesh.mesh_dim_names,
                                 rules.spec_for(logical_axes))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def pad_to_multiple(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


def _tp(rules: Optional[ShardingRules]) -> int:
    return rules.tp_size if rules and rules.tensor else 1


def padded_vocab(vocab: int, rules: Optional[ShardingRules]) -> int:
    """The vocabulary padded to lcm(128, TP degree); padded logit rows
    are -1e30 before the softmax and the loss."""
    tp = _tp(rules)
    return pad_to_multiple(vocab, 128 * tp // math.gcd(128, tp))


def effective_heads(n_heads: int, rules: Optional[ShardingRules]) -> int:
    """Q heads padded up to the TP degree so the head axis always
    shards; padded heads are no-ops (their W_o rows are zero)."""
    tp = _tp(rules)
    if tp <= 1 or n_heads % tp == 0:
        return n_heads
    return pad_to_multiple(n_heads, tp)


def kv_heads_shardable(n_kv: int, rules: Optional[ShardingRules]) -> bool:
    tp = _tp(rules)
    return tp > 1 and n_kv % tp == 0
