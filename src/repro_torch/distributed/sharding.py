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

The model-sharding rules of the reference module (``ShardingRules``,
the FSDP/TP/EP specs) are not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

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
