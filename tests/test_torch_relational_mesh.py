"""The relational ops over a mesh (``unique``, ``group_by``, ``join`` with
``mesh=``) equal the port's single-device results, which
``tests/test_torch_relational.py`` holds to the JAX package.  The
reference's own mesh unique / group_by fail under jax 0.9.0
(``ShardingTypeError`` on a gather), so the single-device port is the
oracle here; the reference has no mesh join (the port's stable mesh sort
gives join's order)."""
import numpy as np
import pytest
import torch

import repro_torch.relational as trel
from repro_torch.core.mesh import make_mesh
from repro_torch.relational.relspec import RelSpec

from _torch_parity import keys, to_torch

MESHES = {"flat8": lambda: make_mesh((8,), ("data",), "cpu"),
          "2x4": lambda: make_mesh((2, 4), ("host", "dev"), "cpu")}


def _eq(a, b):
    for u, v in zip(a, b):
        if isinstance(u, tuple):
            _eq(u, v)
        elif u is None:
            assert v is None
        else:
            assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dtype,dist", [("int32", "uniform"),
                                        ("uint16", "dup_heavy"),
                                        ("int8", "mixed"),
                                        ("uint32", "all_equal")])
def test_unique_and_group_by_over_a_mesh(mesh, dtype, dist):
    m = MESHES[mesh]()
    x = to_torch(keys(dtype, (1203,), dist, 3))
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(1203)
                         .astype(np.float32))
    _eq(trel.unique(x, return_inverse=True, return_counts=True,
                    device="cpu"),
        trel.unique(x, return_inverse=True, return_counts=True, mesh=m))
    agg = ("sum", "min", "max", "count", "mean")
    a = trel.group_by(x, v, agg=agg, device="cpu")
    b = trel.group_by(x, v, agg=agg, mesh=m, axis_name=None)
    _eq(a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_join_over_a_mesh(mesh):
    rng = np.random.default_rng(7)
    lk = torch.from_numpy(rng.integers(0, 60, 900).astype(np.int32))
    rk = torch.from_numpy(rng.integers(0, 60, 300).astype(np.int32))
    _eq(trel.join(lk, rk, size=6000, device="cpu"),
        trel.join(lk, rk, size=6000, mesh=MESHES[mesh]()))


def test_mesh_relspec_validation():
    m = MESHES["flat8"]()
    x = torch.zeros(8, dtype=torch.int32)
    spec = RelSpec(op="unique", mesh=m).canonical(x)
    assert spec.axis_name == ("data",)
    with pytest.raises(ValueError, match="distributed relational variants"):
        RelSpec(op="rle", mesh=m).canonical(x)
    with pytest.raises(ValueError, match="'distributed' sort"):
        RelSpec(op="unique", mesh=m, method="radix").canonical(x)
    with pytest.raises(ValueError, match="keycodec"):
        RelSpec(op="unique", mesh=m).canonical(x.to(torch.int64))
    with pytest.raises(ValueError, match="not in mesh axes"):
        RelSpec(op="unique", mesh=m, axis_name="rows").canonical(x)
    assert RelSpec(op="unique", mesh=m).static_key((8,), torch.int32) != \
        RelSpec(op="unique").static_key((8,), torch.int32)
