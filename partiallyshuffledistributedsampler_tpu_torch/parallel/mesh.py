"""Process-group and device-mesh helpers: one process per GPU.

The JAX package's mesh is a set of devices that one program spans; here a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over processes, one
device each, NCCL on the card and gloo on the CPU.  Identity (world and
rank) is read off the mesh; agreement on the epoch seed is a collective
over its group (``parallel/sharded.py``).
"""

from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.cuda_kernel import device_kind

#: the environment variables ``init_process_group``'s ``env://`` reads
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def ensure_distributed() -> None:
    """Initialise the default process group from the standard environment
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    as ``torchrun`` sets them), with torch's default backend per device:
    NCCL for CUDA tensors, gloo for CPU ones.  Idempotent; a no-op when a
    group exists or when the variables are not all set."""
    if dist.is_initialized() or not all(k in os.environ for k in _ENV):
        return
    dist.init_process_group(init_method="env://")


def data_mesh(axis_name: str = "data", device: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over every rank of the default group,
    on ``device`` ("cuda" unless the caller asks for "cpu"; "cuda" without
    a usable GPU raises ``CudaUnavailableError``).  The default group must
    exist (``ensure_distributed`` or ``init_process_group``).  A caller who
    wants a subset of the ranks builds its own ``DeviceMesh`` and passes it
    as ``mesh=`` to the functions of ``parallel/sharded.py``."""
    device_type = device_kind(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call ensure_distributed() "
            "or init_process_group() before building the mesh"
        )
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def local_ranks_from_mesh(mesh: DeviceMesh,
                          axis_name: str = "data") -> list[int]:
    """The ``axis_name`` coordinates of this process: one, since a process
    drives one device of the mesh."""
    return [int(mesh.get_local_rank(axis_name))]


def identity_from_mesh(mesh: DeviceMesh,
                       axis_name: str = "data") -> tuple[int, int]:
    """``(world, rank)`` of this process along ``axis_name``."""
    return (int(mesh.size(mesh.mesh_dim_names.index(axis_name))),
            local_ranks_from_mesh(mesh, axis_name)[0])
