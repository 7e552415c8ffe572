"""The port's mesh sorts through every entry point: ``distributed_sort``
(odd-even, sample, auto), ``distributed_topk``, the ``distributed``
backend, the front door (``repro_torch.sort`` with ``mesh=``) and
``SortSpec(mesh=...)``.

At D = 1 and on the host-level pieces the JAX package is the oracle, in
process.  At D = 8 one module-scoped subprocess runs the reference with
``--xla_force_host_platform_device_count=8`` on fixed seeds and writes
its outputs to an ``.npz``; the port is held to it where the reference
runs under the installed jax (0.9.0): the flat sample sort of an evenly
divisible array (keys; both directions; a key-value sort's keys), the
two-level and the flat sort on a 2 x 4 mesh, ``sample_topk`` /
``distributed_topk`` on both meshes and odd-even transposition.  Held to
numpy instead, because the reference fails there under jax 0.9.0
(``ShardingTypeError`` on a gather of its padded array): the sample sort
of an uneven length, and the mesh relational ops
(``tests/test_torch_relational_mesh.py``).  The reference's key-value
sample sort is not stable, so payloads are compared where keys are
unique, and the permutation is held to numpy's stable order.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.sort as tsort
from repro.core import distributed_sort as jds
from repro_torch.core import distributed_sort as ds
from repro_torch.core import keycodec
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.core.sortspec import SortSpec, get_backend

from _torch_parity import assert_same, keys, to_numpy, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.engine import samplesort as ss
from repro.core import distributed_sort as ds
mesh = jax.make_mesh((8,), ("data",))
m2 = jax.make_mesh((2, 4), ("host", "dev"))
rng = np.random.default_rng(0)
x = rng.standard_normal(8 * 512).astype(np.float32)
xi = rng.integers(-50, 50, 8 * 384).astype(np.int32)
v = np.arange(x.size, dtype=np.int32)
out = {"x": x, "xi": xi}
X, XI = jnp.asarray(x), jnp.asarray(xi)
out["sort"] = np.asarray(ss.sample_sort(X, mesh, "data"))
out["sort_desc"] = np.asarray(ss.sample_sort(X, mesh, "data",
                                             descending=True))
out["sort_int_hist"] = np.asarray(ss.sample_sort(XI, mesh, "data",
                                                 use_histogram=True))
k, pv = ss.sample_sort(X, mesh, "data", values=jnp.asarray(v))
out["kv_keys"], out["kv_vals"] = np.asarray(k), np.asarray(pv)
out["hier"] = np.asarray(ss.sample_sort(X, m2, None))
out["flat2x4"] = np.asarray(ss.sample_sort(X, m2, None, hierarchical=False))
out["oddeven"] = np.asarray(ds.distributed_sort(X, mesh, "data",
                                                strategy="oddeven"))
for k_ in (1, 64, 500):
    tv, ti = ss.sample_topk(XI, k_, mesh, "data")
    out[f"topk{k_}_v"], out[f"topk{k_}_i"] = np.asarray(tv), np.asarray(ti)
tv, ti = ds.distributed_topk(X, 50, m2, None)
out["topk2x4_v"], out["topk2x4_i"] = np.asarray(tv), np.asarray(ti)
np.savez(sys.argv[1], **out)
print("REF8_OK")
"""


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref8") / "ref8.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert "REF8_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


def _m8():
    return make_mesh((8,), ("data",), "cpu")


def _m24():
    return make_mesh((2, 4), ("host", "dev"), "cpu")


def test_d8_sample_sort_matches_reference(ref8):
    x, xi = torch.from_numpy(ref8["x"]), torch.from_numpy(ref8["xi"])
    m = _m8()
    assert_same(ref8["sort"], tsort.sort(x, mesh=m))
    assert_same(ref8["sort_desc"], tsort.sort(x, mesh=m, descending=True))
    from repro_torch.engine import samplesort as ss
    assert_same(ref8["sort_int_hist"],
                ss.sample_sort(xi, m, use_histogram=True))
    v = torch.arange(x.shape[0], dtype=torch.int32)
    k, pv = tsort.sort_kv(x, v, mesh=m)
    assert_same(ref8["kv_keys"], k)
    uniq = np.unique(ref8["x"]).size == ref8["x"].size
    if uniq:
        np.testing.assert_array_equal(ref8["kv_vals"], pv.numpy())


def test_d8_two_level_and_flat_2x4_match_reference(ref8):
    x = torch.from_numpy(ref8["x"])
    assert_same(ref8["hier"], tsort.sort(x, mesh=_m24()))
    from repro_torch.engine import samplesort as ss
    assert_same(ref8["flat2x4"],
                ss.sample_sort(x, _m24(), None, hierarchical=False))


def test_d8_oddeven_matches_reference(ref8):
    x = torch.from_numpy(ref8["x"])
    assert_same(ref8["oddeven"],
                ds.distributed_sort(x, _m8(), "data", strategy="oddeven"))


@pytest.mark.parametrize("k", [1, 64, 500])
def test_d8_topk_matches_reference(ref8, k):
    xi = torch.from_numpy(ref8["xi"])
    v, i = tsort.topk(xi, k, mesh=_m8())
    assert_same(ref8[f"topk{k}_v"], v)
    assert_same(ref8[f"topk{k}_i"], i)
    x = torch.from_numpy(ref8["x"])
    v, i = ds.distributed_topk(x, 50, _m24())
    assert_same(ref8["topk2x4_v"], v)
    assert_same(ref8["topk2x4_i"], i)


# ---------------------------------------------------------------------------
# host-level pieces and D = 1, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", range(1, 10))
def test_round_permutation_matches_reference(n_dev):
    for even in (True, False):
        assert ds._round_permutation(n_dev, even) == \
            jds._round_permutation(n_dev, even)


@pytest.mark.parametrize("m", [1, 4, 64])
def test_bitonic_merge_halves_matches_reference(m):
    rng = np.random.default_rng(m)
    a = np.sort(rng.integers(-9, 9, (3, m)).astype(np.int32), -1)
    b = np.sort(rng.integers(-9, 9, (3, m)).astype(np.int32), -1)
    jl, jh = jds.bitonic_merge_halves(jnp.asarray(a), jnp.asarray(b))
    tl, th = ds.bitonic_merge_halves(torch.from_numpy(a), torch.from_numpy(b))
    assert_same(jl, tl)
    assert_same(jh, th)


def test_collective_bytes_matches_reference():
    assert ds.collective_bytes_per_device(8, 512, 4) == \
        jds.collective_bytes_per_device(8, 512, 4)


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_one_entry_mesh_matches_reference(dtype):
    x = keys(dtype, (640,), "mixed", 3)
    jm = jax.make_mesh((1,), ("data",))
    tm = make_mesh((1,), ("data",), "cpu")
    assert_same(jds.distributed_sort(jnp.asarray(x), jm, "data",
                                     strategy="sample"),
                ds.distributed_sort(to_torch(x), tm, "data",
                                    strategy="sample"))
    jv, ji = jds.distributed_topk(jnp.asarray(x), 37, jm, "data")
    tv, ti = ds.distributed_topk(to_torch(x), 37, tm, "data")
    assert_same(jv, tv)
    assert_same(ji, ti)


# ---------------------------------------------------------------------------
# D = 8 against numpy
# ---------------------------------------------------------------------------

def _order(x, descending):
    enc = keycodec.encode(x, descending=descending).numpy()
    return np.argsort(enc.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[
        enc.itemsize]), kind="stable")


@pytest.mark.parametrize("strategy", ["sample", "oddeven", "auto"])
def test_strategies_agree(strategy):
    x = to_torch(keys("float32", (4096,), "mixed", 31))
    want = to_numpy(x)[_order(x, False)]
    got = ds.distributed_sort(x, _m8(), "data", strategy=strategy)
    np.testing.assert_array_equal(to_numpy(got).view(np.uint32),
                                  want.view(np.uint32))


def test_oddeven_refuses_what_it_cannot_express():
    x = torch.arange(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="evenly divisible"):
        ds.distributed_sort(x[:99], _m8(), strategy="oddeven")
    with pytest.raises(ValueError, match="ONE mesh axis"):
        ds.distributed_sort(x[:96], _m24(), None, strategy="oddeven")
    with pytest.raises(ValueError, match="two-axis"):
        ds.distributed_sort(x, _m8(), strategy="hier")
    with pytest.raises(ValueError, match="strategy must be"):
        ds.distributed_sort(x, _m8(), strategy="bogo")
    # auto routes what odd-even cannot express to the sample sort
    assert ds.distributed_sort(x[:99], _m8(), descending=True).tolist() \
        == list(range(98, -1, -1))


@pytest.mark.parametrize("k", [1, 7, 300, 1001])
def test_topk_lax_rule_on_ties_and_zeros(k):
    """Duplicate-heavy int8 and ±0.0 floats over an uneven length: values
    descending, +0.0 above -0.0, the lowest index first."""
    rng = np.random.default_rng(k)
    xi = rng.integers(-3, 3, 1001).astype(np.int8)
    v, i = ds.distributed_topk(torch.from_numpy(xi), k, _m8())
    order = np.lexsort((np.arange(1001), -xi.astype(np.int64)))[:k]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(v.numpy(), xi[order])
    xf = np.where(rng.random(1001) < 0.5, -0.0, 0.0).astype(np.float32)
    v, i = ds.distributed_topk(torch.from_numpy(xf), k, _m24())
    jv, ji = jax.lax.top_k(jnp.asarray(xf), k)
    assert_same(jv, v)
    assert_same(ji, i)


# ---------------------------------------------------------------------------
# the front door and the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_fn", [_m8, _m24])
@pytest.mark.parametrize("descending", [False, True])
def test_front_door_sort_argsort_sort_kv_topk(mesh_fn, descending):
    mesh = mesh_fn()
    x = to_torch(keys("bfloat16", (1999,), "mixed", 13))
    order = _order(x, descending)
    xb = x.view(torch.int16).numpy()
    got = tsort.sort(x, mesh=mesh, descending=descending)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), xb[order])
    perm = tsort.argsort(x, mesh=mesh, descending=descending, stable=True)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), order)
    pay = torch.from_numpy(np.random.default_rng(1).standard_normal(1999)
                           .astype(np.float32))
    sk, sv = tsort.sort_kv(x, pay, mesh=mesh, descending=descending)
    np.testing.assert_array_equal(sv.numpy(), pay.numpy()[order])
    v, i = tsort.topk(x, 33, mesh=mesh)
    jv, ji = jax.lax.top_k(jnp.asarray(to_numpy(x)), 33)
    assert_same(jv, v)
    assert_same(ji, i)


def test_sortspec_mesh_validation_and_static_key():
    mesh = _m8()
    x = torch.zeros(16)
    spec = SortSpec(mesh=mesh).canonical(x)
    assert spec.method == "distributed" and spec.axis_name == ("data",)
    with pytest.raises(ValueError, match="flat 1-D"):
        SortSpec(mesh=mesh).canonical(torch.zeros(2, 8))
    with pytest.raises(ValueError, match="segments"):
        SortSpec(mesh=mesh, valid_lengths=torch.zeros(1)).canonical(x)
    with pytest.raises(ValueError, match="'distributed' backend"):
        SortSpec(mesh=mesh, method="radix").canonical(x)
    with pytest.raises(ValueError, match="requires a mesh"):
        SortSpec(axis_name="data").canonical(x)
    with pytest.raises(ValueError, match="not in mesh axes"):
        SortSpec(mesh=mesh, axis_name="model").canonical(x)
    with pytest.raises(TypeError, match="Mesh"):
        SortSpec(mesh=object()).canonical(x)
    other = Mesh(np.array([torch.device("cpu")] * 8, dtype=object),
                 ("data",))
    assert SortSpec(mesh=mesh).static_key((16,), torch.float32) == \
        SortSpec(mesh=other).static_key((16,), torch.float32)
    moved = make_mesh((8,), ("rows",), "cpu")
    assert SortSpec(mesh=mesh).static_key((16,), torch.float32) != \
        SortSpec(mesh=moved).static_key((16,), torch.float32)
    assert hash(mesh) == hash(other) and mesh == other


def test_make_mesh_checks_its_devices():
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((8,), ("data",), ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh((2,), ("data",), "cuda:0")
        with pytest.raises(RuntimeError, match="distinct cards"):
            make_mesh((2,), ("data",))
    m = make_mesh((2, 4), ("host", "dev"), "cpu")
    assert m.shape == {"host": 2, "dev": 4} and m.size == 8
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")], dtype=object), ("a", "b"))


def test_distributed_backend_rows_form():
    be = get_backend("distributed")
    assert not be.capabilities.auto_dispatch and be.capabilities.stable
    rows = torch.tensor([[3, 1, 2, 1], [0, -5, 7, 7]], dtype=torch.int32)
    out = tsort.sort(rows, method="distributed", device="cpu")
    assert out.tolist() == [[1, 1, 2, 3], [-5, 0, 7, 7]]
    order = tsort.argsort(rows, method="distributed", descending=True,
                          device="cpu")
    assert order.tolist() == [[0, 2, 1, 3], [2, 3, 0, 1]]
    v, i = tsort.topk(rows, 2, method="distributed", device="cpu")
    assert v.tolist() == [[3, 2], [7, 7]] and i.tolist() == [[0, 2], [2, 3]]
