"""Mesh construction for the launchers (the JAX package's
``launch/mesh.py``): functions, never module-level meshes, so importing
this module touches no device state.

Two kinds of mesh live here.  ``make_host_mesh`` is the sort tier's
single-controller ``core.mesh.Mesh`` (one process, an entry a card).
``make_host_device_mesh`` and ``make_production_mesh`` are
``torch.distributed`` ``DeviceMesh``es for the sharding policy
(``sharding.partitioning``): one process a rank.  The production meshes
stand on a ``fake`` process group, whose collectives carry no data: the
dry run traces rank 0's local program on them and never a real tensor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.mesh import Mesh, make_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_host_mesh() -> Mesh:
    """Every card of this machine as a 1-D ``data`` mesh (one entry a
    card); raises on a machine without a card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_host_mesh needs a CUDA card; build a CPU "
                           "mesh with core.mesh.make_mesh(..., devices='cpu')")
    return make_mesh((n,), ("data",))


def make_host_device_mesh(shape: Optional[Sequence[int]] = None,
                          axis_names: Tuple[str, ...] = ("data", "model"),
                          device="cuda"):
    """A ``DeviceMesh`` over the ranks of the initialised default process
    group (``torch.distributed.init_process_group``: ``nccl`` for
    ``"cuda"``, ``gloo`` for ``"cpu"``), on ``device`` (default
    ``"cuda"``; each rank's card is ``cuda:<local rank>``).  ``shape``
    defaults to ``(1, world)``: every rank on the ``model`` axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_device_mesh needs an initialised "
                           "process group")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (1,) * (
        len(axis_names) - 1) + (world,)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_device_mesh: device 'cuda' needs "
                               "a card; pass device='cpu'")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16 x 16 single-pod or 2 x 16 x 16 two-pod mesh (axes ``pod``,
    ``data``, ``model``) over a ``fake`` process group in this process,
    as its rank 0: for the dry run only.  An initialised default group of
    another world size or backend is replaced; ``release_fake_world``
    destroys it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return init_device_mesh("cpu", shape, mesh_dim_names=axes)
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def release_fake_world() -> None:
    """Destroy the default process group if it is a ``fake`` one."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data")) \
        if hasattr(mesh, "mesh_dim_names") else \
        tuple(a for a in mesh.axis_names if a in ("pod", "data"))
