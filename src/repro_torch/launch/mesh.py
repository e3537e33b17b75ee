"""Production mesh construction on `torch.distributed`.

The port's copy of `repro.launch.mesh`. The meshes are `DeviceMesh`es
over the default process group, one process a rank, built by
functions (never module constants), so importing this module touches no
process group:

- `make_production_mesh(multi_pod=False)`: (16, 16) over ("data",
  "model"), or (2, 16, 16) over ("pod", "data", "model"). The group's
  world size must be 256 or 512: on H100s that is 32 or 64 nodes of 8
  cards; the dry run (`launch.dryrun`) builds it over a fake group of
  that size in one process.
- `make_host_mesh()`: (1, 1) over a world-1 group, NCCL on the card and
  gloo on the CPU; it starts that group itself when none exists.
- `mesh_axis_sizes(mesh)`: axis name → size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class MeshSizeError(RuntimeError):
    """The default process group's world size does not fit the mesh."""


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 ranks a pod; 2 pods = 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        raise MeshSizeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a default "
            f"process group of world size {need}, found "
            f"{'none' if world is None else world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh():
    """A 1×1 ("data", "model") mesh over a world-1 group: NCCL when a
    card is present, gloo otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise MeshSizeError(f"make_host_mesh needs a world-1 process "
                            f"group, found world size "
                            f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
