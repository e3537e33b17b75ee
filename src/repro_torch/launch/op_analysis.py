"""Per-device FLOPs, memory traffic, collective bytes and live memory of
an eager PyTorch program, counted op by op.

The port's counterpart of `repro.launch.hlo_analysis` (its ``analyze``),
named as `analysis.tick_audit` is after the reference's ``hlo_audit``:
the reference parses the optimized HLO text of a compiled program; here
a `TorchDispatchMode` sees every aten op the program runs. On DTensors
the mode steps aside for DTensor's own dispatch (it returns
``NotImplemented`` for an op with a DTensor argument) and so sees the
ops DTensor runs on each rank's local shards, and the collectives it
issues: the counts are per device, after the partitioning, as the
reference's are. The global-shape runs DTensor's sharding propagation
makes on fake tensors are not counted.

The reference's rules, op by op:

- **FLOPs**: every matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``),
  2 · prod(output) · contraction size.
- **Bytes**: operands plus outputs of every op; slices, selects and
  gathers at twice their output; an in-place update (``copy_``,
  ``index_put_``, ``index_add_``) at twice its update; views and
  metadata ops (``view``, ``expand``, ``permute``, ``detach``, ...) at
  nothing, as the reference skips bitcasts and tuples.
- **Collective bytes**: the output bytes of each collective, by the
  reference's five names.

Eager code has no loops to multiply: a Python loop over layers is
counted once per trip (`launch.dryrun` counts one and two periods and
extrapolates). ``n_ops`` (the ops counted) takes the place of the
reference's ``n_computations``.

`analyze` also tracks the bytes of every storage the program allocates
while it runs, released when the storage is freed: ``peak_bytes`` is
the most that were live at once (the dry run's temporaries).

The reference's HLO-text helpers (``parse_input_output_aliases``,
``host_transfer_ops``, ``ops_with_dtypes``) served its ``hlo_audit``,
which `analysis.tick_audit` replaced; they have no counterpart here.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "allreduce_": "all-reduce", "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
}
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "alias", "detach", "as_strided",
    "split", "split_with_sizes", "chunk", "unbind", "unflatten",
    "flatten", "view_as", "expand_as", "lift_fresh", "empty",
    "empty_strided", "empty_like", "_to_copy_meta", "wait_tensor",
    "_wrap_tensor_autograd", "movedim", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_reshape_alias",
    "clone_meta", "set_", "resize_", "_local_scalar_dense",
}
_SLICES = {"slice", "select", "index", "gather", "index_select",
           "embedding", "narrow", "take_along_dim"}
_UPDATES = {"copy_": 1, "index_put_": 2, "index_add_": 3, "index_add": 3,
            "index_put": 2, "scatter_add_": 3, "scatter_add": 3}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _matmul_flops(name: str, args, out) -> float:
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """The counting mode; `analyze` is the way to use it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def _track(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(x, DTensor) for x in ins):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(x, FakeTensor) for x in ins + outs):
            return out  # DTensor's sharding propagation
        self._count(func, args, ins, out, outs)
        return out

    def _count(self, func, args, ins, out, outs) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        self.n_ops += 1
        out_b = sum(_nbytes(t) for t in outs)
        if ns in ("_c10d_functional", "c10d", "c10d_functional") \
                and name in _COLLECTIVE_OPS:
            self.collectives[_COLLECTIVE_OPS[name]] += out_b
        if name in _MATMULS:
            self.flops += _matmul_flops(name, args, outs[0])
        if name in _FREE or ns == "_c10d_functional" and name in (
                "wait_tensor", "_wrap_tensor_autograd"):
            pass
        elif name in _SLICES:
            self.bytes += 2 * out_b
        elif name in _UPDATES:
            idx = _UPDATES[name]
            upd = args[idx] if len(args) > idx else None
            self.bytes += 2 * (_nbytes(upd) if isinstance(
                upd, torch.Tensor) else out_b)
        else:
            self.bytes += out_b + sum(_nbytes(t) for t in ins)
        if outs and not (name in _FREE and name not in (
                "empty", "empty_strided", "empty_like")):
            self._track([t for t in outs if t._base is None
                         and not _aliases(t, ins)])


def _aliases(t: torch.Tensor, ins) -> bool:
    """``t`` shares storage with an input (a view or an in-place op)."""
    try:
        key = t.untyped_storage()._cdata
        return any(x.untyped_storage()._cdata == key for x in ins)
    except (NotImplementedError, RuntimeError):
        return False


def analyze(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` under the counter → the reference's
    keys (``flops``, ``bytes``, ``collective_bytes``, ``collectives``)
    plus ``n_ops``, ``peak_bytes`` (the most bytes allocated during the
    run and live at once) and ``result`` (what ``fn`` returned)."""
    with OpCounter() as c:
        result = fn(*args, **kwargs)
    return {
        "flops": c.flops,
        "bytes": c.bytes,
        "collective_bytes": sum(c.collectives.values()),
        "collectives": dict(c.collectives),
        "n_ops": c.n_ops,
        "peak_bytes": c.peak,
        "result": result,
    }


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``: a DTensor counts its
    local shard on this rank."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += _nbytes(t)
    return total
