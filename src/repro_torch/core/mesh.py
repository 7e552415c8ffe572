"""The sort tier's meshes: one process over many entries, or one rank each.

The JAX package's meshes are ``jax.sharding.Mesh`` values, and its
distributed programs are ``shard_map`` bodies over them: one program a
device, exchanging data through collectives.  The port runs the same
programs in two forms, which give the same bits:

* **One process** (:class:`Mesh`): an ``ndarray`` of ``torch.device``
  with an axis name per dimension.  A per-entry program is a host loop
  over the entries in row-major order, each entry's work on its own
  device; an exchange is a copy into a fresh buffer on the destination's
  device (``engine.collectives``).  Entries may repeat one device:
  ``make_mesh((8,), ("data",), "cuda:0")`` holds eight entries on one
  card, and every exchange between them is still a real copy inside that
  card's memory; with distinct devices (``devices=None``) the copies
  cross NVLink.  This is how the CPU tests and one card run D entries,
  and it is the oracle the rank form is held to.
* **One program a rank** (``torch.distributed.device_mesh.DeviceMesh``,
  built with ``launch.mesh.make_host_device_mesh`` after
  ``init_process_group``): each rank holds its own shard and exchanges go
  through ``torch.distributed`` collectives of the sort axes' process
  group (NCCL on cards, gloo on the CPU), as ``torchrun`` jobs and the
  sharding policy run.  :func:`rank_index` and :func:`rank_group` give a
  rank its place and its group.

The helpers below (:func:`axis_names`, :func:`axis_size`,
:func:`mesh_key`) read either form.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "is_device_mesh", "check_mesh", "axis_names",
           "axis_size", "mesh_key", "rank_index", "rank_group"]


class Mesh:
    """Named axes over an ``ndarray`` of ``torch.device``.

    ``shape`` maps each axis name to its size (in axis order, as
    ``jax.sharding.Mesh.shape`` does); ``devices`` is the object array;
    ``axis_names`` the names.  Two meshes are equal when their axis
    layout and device list are (:meth:`key`), the identity the plan and
    cache keys use."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        for i, d in enumerate(flat):
            arr.reshape(-1)[i] = torch.device(d)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh of {arr.ndim} dimensions needs as many "
                             f"axis names, got {names}")
        if len(set(names)) != len(names) or not all(
                isinstance(a, str) and a for a in names):
            raise ValueError(f"axis names must be distinct non-empty "
                             f"strings, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one entry")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def key(self) -> Tuple:
        """Axis layout plus the device list: the mesh's identity."""
        return (tuple(zip(self.axis_names, self.devices.shape)),
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Union[None, str, torch.device, Sequence] = None
              ) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.

    ``devices``: None takes one distinct card an entry (``cuda:0`` ...,
    raising when the machine has fewer); one device (``"cuda:0"``,
    ``"cpu"``) repeats it in every entry; a sequence gives one device an
    entry in row-major order.  Every device is checked with
    ``sortspec.resolve_device``: an entry on ``cuda`` without a card
    raises."""
    from repro_torch.core.sortspec import resolve_device
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes need sizes >= 1, got {shape}")
    n = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} distinct cards needs {n} CUDA devices, this "
                f"machine has {have}; pass devices='cuda:0' to put every "
                f"entry on one card, or devices='cpu'")
        devs = [f"cuda:{i}" for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devs = [devices] * n
    else:
        devs = list(devices)
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                             f"got {len(devs)}")
    resolved = [resolve_device(d) for d in devs]
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(resolved):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


# ---------------------------------------------------------------------------
# either form: a one-process Mesh or a torch.distributed DeviceMesh
# ---------------------------------------------------------------------------

def is_device_mesh(mesh) -> bool:
    """True for a ``torch.distributed`` ``DeviceMesh`` (the rank form)."""
    try:
        from torch.distributed.device_mesh import DeviceMesh
    except ImportError:                      # a build without distributed
        return False
    return isinstance(mesh, DeviceMesh)


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is one of the sort tier's two
    mesh forms."""
    if not (isinstance(mesh, Mesh) or is_device_mesh(mesh)):
        raise TypeError(
            f"mesh must be a repro_torch.core.mesh.Mesh (one process) or a "
            f"torch.distributed DeviceMesh (one program a rank), got "
            f"{type(mesh).__name__}")


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, outermost first."""
    if is_device_mesh(mesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh of the sort tier needs named "
                             "dimensions (init_device_mesh(..., "
                             "mesh_dim_names=...))")
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``."""
    names = axis_names(mesh)
    if name not in names:
        raise ValueError(f"axis {name!r} not in mesh axes {names}")
    if is_device_mesh(mesh):
        return int(mesh.shape[names.index(name)])
    return int(mesh.shape[name])


def mesh_key(mesh) -> Tuple:
    """A mesh's identity for plan and cache keys: its axis layout plus
    its device list (:meth:`Mesh.key`) or, for a ``DeviceMesh``, its
    device type and rank layout."""
    if is_device_mesh(mesh):
        names = axis_names(mesh)
        return (("device_mesh", mesh.device_type),
                tuple(zip(names, (int(s) for s in mesh.shape))),
                tuple(int(r) for r in mesh.mesh.flatten().tolist()))
    return mesh.key()


def _rank_layout(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The global ranks of a ``DeviceMesh`` cut into the groups that an
    exchange over ``axes`` connects, each in row-major order over
    ``axes`` (outer first), the groups in row-major order over the rest
    (``engine.collectives.axis_groups``' rule)."""
    names = list(axis_names(mesh))
    others = [a for a in names if a not in axes]
    ranks = np.asarray(mesh.mesh.cpu()).reshape(
        tuple(int(s) for s in mesh.shape))
    t = ranks.transpose([names.index(a) for a in others + list(axes)])
    g = int(np.prod([axis_size(mesh, a) for a in axes]))
    return [list(map(int, row)) for row in t.reshape(-1, g)]


def rank_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major linear index over ``axes`` of a
    ``DeviceMesh``: its shard's place in the global array (the
    reference's ``_lin_index``)."""
    import torch.distributed as dist
    me = dist.get_rank()
    for row in _rank_layout(mesh, tuple(axes)):
        if me in row:
            return row.index(me)
    raise ValueError(f"rank {me} is not part of {mesh}")


_GROUPS: Dict[Tuple, Tuple] = {}


def rank_group(mesh, axes: Sequence[str]):
    """``(process group, members)`` of this rank over ``axes`` of a
    ``DeviceMesh``: ``members`` are the group's global ranks in linear
    order over ``axes``.  One axis is the mesh's own dimension group
    (``DeviceMesh.get_group``); a tuple of axes is a group made once with
    ``new_subgroups_by_enumeration`` (a collective call: every rank of
    the default group makes the call together) and cached by the mesh's
    layout."""
    import torch.distributed as dist
    axes = tuple(axes)
    me = dist.get_rank()
    layout = _rank_layout(mesh, axes)
    members = next((row for row in layout if me in row), None)
    if members is None:
        raise ValueError(f"rank {me} is not part of {mesh}")
    if len(axes) == 1:
        return mesh.get_group(axes[0]), members
    key = (mesh_key(mesh), axes, id(dist.group.WORLD))
    hit = _GROUPS.get(key)
    if hit is None:
        mine, _ = dist.new_subgroups_by_enumeration(layout)
        hit = _GROUPS[key] = (mine, members)
    return hit
