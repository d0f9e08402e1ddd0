"""Device meshes of the port (own copy of ``repro.launch.mesh`` on
``torch.distributed``).

A function, not a module-level constant, so importing this module never
touches a process group.  ``make_production_mesh`` builds the production
shapes from a process group that already spans them; ``make_mesh`` builds
any shape on the card (NCCL) or, with ``device="cpu"``, on the CPU (gloo),
initialising the default group itself from a ``TCPStore`` on 127.0.0.1 (one
process) or a ``FileStore`` (several), since nothing here may reach a
network.  NCCL takes one rank per device: on one card the mesh has one
rank."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device


def _init_default_group(backend: str, rank: int, world_size: int,
                        init_file: Optional[str]) -> None:
    if init_file is not None:
        store = dist.FileStore(init_file, world_size)
    elif world_size == 1:
        store = dist.TCPStore("127.0.0.1", 0, world_size, is_master=True)
    else:
        raise ValueError(f"a world of {world_size} processes needs a shared "
                         "init_file (a FileStore path) to meet")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def make_mesh(shape: tuple, names: tuple, device=None, *, rank: int = 0,
              init_file: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the default
    process group, on the card unless ``device="cpu"`` (with no card and no
    such request this raises).  Where no default group exists yet, this
    process joins one of ``prod(shape)`` ranks as ``rank``: a
    ``TCPStore`` on 127.0.0.1 for one rank, the ``FileStore`` at
    ``init_file`` for more.  A group of another size raises."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         "length")
    world = math.prod(shape)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if world == 1
                              else rank % torch.cuda.device_count())
    if not dist.is_initialized():
        _init_default_group("nccl" if dev.type == "cuda" else "gloo", rank,
                            world, init_file)
    if dist.get_world_size() != world:
        raise ValueError(f"a {shape} mesh needs {world} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 devices per pod ``("data", "model")``; 2 pods via a leading
    ``"pod"`` axis.  The process group must already span them (256 or 512
    ranks): this never builds a smaller mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} needs a process group of "
            f"{math.prod(shape)} ranks; this one has {world}"
            + ("" if dist.is_initialized() else " (none initialised)"))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def data_axes_of(mesh) -> tuple:
    """The data axes of a ``DeviceMesh``, or of a mapping of axis name to
    size (a mesh no process group backs)."""
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") \
        else tuple(mesh)
    return tuple(a for a in names if a in ("pod", "data"))
