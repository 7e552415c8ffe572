"""A device mesh in one process: a grid of torch devices with named axes.

The JAX package's meshes are ``jax.sharding.Mesh`` values over this
process's devices, and its distributed programs are ``shard_map`` bodies
over them: a global array in, a global array out.  PyTorch has no such
value, so the port keeps its own: :class:`Mesh` is an ``ndarray`` of
``torch.device`` with an axis name per dimension.  A per-entry program is
a host loop over the entries in row-major order, each entry's work on its
own device; an exchange between entries is a copy into a fresh buffer on
the destination's device (``engine.collectives``).

Entries may repeat one device: ``make_mesh((8,), ("data",), "cuda:0")``
holds eight entries on one card, and every exchange between them is still
a real copy inside that card's memory.  On a node with several cards the
same code takes distinct devices (``devices=None``) and the copies cross
NVLink.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


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
