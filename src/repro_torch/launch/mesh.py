"""Mesh construction for the launchers (the JAX package's
``launch/mesh.py``): functions, never module-level meshes, so importing
this module touches no device state."""
from __future__ import annotations

import torch

from repro_torch.core.mesh import Mesh, make_mesh


def make_host_mesh() -> Mesh:
    """Every card of this machine as a 1-D ``data`` mesh (one entry a
    card); raises on a machine without a card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_host_mesh needs a CUDA card; build a CPU "
                           "mesh with core.mesh.make_mesh(..., devices='cpu')")
    return make_mesh((n,), ("data",))


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
