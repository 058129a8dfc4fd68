"""Meshes: ``torch.distributed`` DeviceMeshes with the JAX package's axis
names (``repro.launch.mesh``).

Importing this module touches no device and no process group; a mesh is
built only inside the functions.  A DeviceMesh spans the ranks of the
default process group, one rank per device: the caller starts the ranks and
calls ``torch.distributed.init_process_group`` (for a dry run of the
production meshes in one process, the fake backend of
``torch.testing._internal.distributed.fake_pg`` with 256 or 512 ranks).
"""
from __future__ import annotations

import math

from repro_torch import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The target topology: 16x16 = 256 devices a pod; 2 pods multi-pod.

    Axes: ``data`` (FSDP + batch), ``model`` (TP/EP), and ``pod`` (pure DP
    across pods) in the multi-pod case.  Needs a process group of exactly
    that many ranks; ``device`` is the mesh's device type (None: the card).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} ranks: "
            "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_local_mesh(device=None):
    """Every rank of the process group as a ``(n, 1)`` ``("data", "model")``
    mesh: NCCL on the cards (one rank per visible card), gloo when the caller
    asks for ``device="cpu"``.  With no process group yet, this process
    becomes a one-rank group (an in-process store, no socket)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    n = dist.get_world_size()
    if device.type == "cuda" and n != torch.cuda.device_count():
        raise ValueError(f"{n} ranks for {torch.cuda.device_count()} visible cards: "
                         "the local mesh takes one rank per card")
    return init_device_mesh(device.type, (n, 1), mesh_dim_names=("data", "model"))
