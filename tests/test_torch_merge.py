"""K2 in both directions: the port's merges against the JAX package's
``repro.engine.merge.merge_pairs`` / ``merge_runs`` on the CPU, bit for bit.

The port's CPU tensors run K2's plain versions (the rank merge, and for a
descending merge the reference's flip construction); on a card the kernel
merges descending runs with a descending comparator, held against these
plain versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The
reference's ``pallas`` backend runs its Pallas merge in interpret mode;
signed zeros go through its ``xla`` backend, since the Pallas merge
rewrites -0.0 as +0.0 (``test_torch_kernels.py``'s divergence test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, keys, to_torch
from repro.engine import merge as jmerge
from repro.kernels import merge_path as jmp
from repro_torch.engine import merge as tmerge
from repro_torch.kernels import _build
from repro_torch.kernels import merge_path as tmp


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """CPU tensors must never reach a CUDA build or launch."""
    def _refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(_build, "load", _refuse)


def _sorted(x, descending):
    """Sort along the last axis (bf16 through float64: numpy has no bf16
    order), reversed for descending runs."""
    y = np.sort(x.astype(np.float64) if x.dtype == jnp.bfloat16 else x,
                axis=-1, kind="stable").astype(x.dtype)
    return np.ascontiguousarray(y[..., ::-1] if descending else y)


def _runs(name, rows, l, seed, descending, negative_zeros=False):
    """Two runs a row, sorted in the merge's direction, sharing many equal
    keys.  Without ``negative_zeros`` every -0.0 is +0.0 (the Pallas
    merge's limit)."""
    x = keys(name, (rows, 2, l), "mixed", seed)
    if not negative_zeros and name.startswith(("float", "bfloat")):
        x = np.where(x == 0, np.zeros((), x.dtype), x)
    x = _sorted(x, descending)
    return np.ascontiguousarray(x[:, 0, :]), np.ascontiguousarray(x[:, 1, :])


def _payloads(a):
    va = np.arange(a.size, dtype=np.int32).reshape(a.shape)
    return va, va + a.size


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["float32", "int32", "bfloat16"])
def test_k2_merges_match_the_reference_pallas_merge(name, descending):
    """Key-only: the kernel module's entry and the engine's ``cuda``
    backend against the reference engine's ``pallas`` merge."""
    a, b = _runs(name, 3, 512, seed=41, descending=descending)
    ref = jmerge.merge_pairs(jnp.asarray(a), jnp.asarray(b),
                             descending=descending, backend="pallas",
                             interpret=True)
    ta, tb = to_torch(a), to_torch(b)
    assert_same(ref, tmp.merge_pairs_blocks(ta, tb, descending=descending),
                f"K2 {name} desc={descending}")
    assert_same(ref, tmerge.merge_pairs(ta, tb, descending=descending,
                                        backend="cuda"),
                f"engine cuda {name} desc={descending}")


@pytest.mark.parametrize("descending", [False, True])
def test_k2_kv_merges_match_the_reference_pallas_merge(descending):
    """Key-value, int16 keys: payloads follow their keys, ``a`` first on
    equal keys in either direction."""
    a, b = _runs("int16", 2, 256, seed=42, descending=descending)
    va, vb = _payloads(a)
    rk, rv = jmerge.merge_pairs(
        jnp.asarray(a), jnp.asarray(b), descending=descending,
        backend="pallas", values=(jnp.asarray(va), jnp.asarray(vb)),
        interpret=True)
    ta, tb, tva, tvb = (to_torch(t) for t in (a, b, va, vb))
    gk, gv = tmp.merge_pairs_kv_blocks(ta, tb, tva, tvb,
                                       descending=descending)
    assert_same(rk, gk, "K2 kv keys")
    assert_same(rv, gv, "K2 kv payload")
    ek, ev = tmerge.merge_pairs(ta, tb, descending=descending,
                                backend="cuda", values=(tva, tvb))
    assert_same(rk, ek, "engine kv keys")
    assert_same(rv, ev, "engine kv payload")


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_k2_signed_zeros_keep_their_bits_both_ways(name, descending):
    """-0.0 ties +0.0 and keeps its bits: against the reference's ``xla``
    merge (its rank merge), with payloads showing which run each zero came
    from."""
    a, b = _runs(name, 4, 300, seed=43, descending=descending,
                 negative_zeros=True)
    assert np.signbit(a[a == 0]).any() and np.signbit(b[b == 0]).any()
    va, vb = _payloads(a)
    rk, rv = jmerge.merge_pairs(
        jnp.asarray(a), jnp.asarray(b), descending=descending, backend="xla",
        values=(jnp.asarray(va), jnp.asarray(vb)))
    gk, gv = tmp.merge_pairs_kv_blocks(
        *(to_torch(t) for t in (a, b, va, vb)), descending=descending)
    assert_same(rk, gk, "signed-zero keys")
    assert_same(rv, gv, "signed-zero payload")
    assert_same(jmerge.merge_pairs(jnp.asarray(a), jnp.asarray(b),
                                   descending=descending, backend="xla"),
                tmp.merge_pairs_blocks(to_torch(a), to_torch(b),
                                       descending=descending))


def _tie_across_the_cut(name, rows, l, seed, descending):
    """Runs whose middle is one long run of a key equal in both runs, so
    that the kernel's first tile boundary (output KERNEL_TILE) falls inside
    it."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(name)
    x = rng.integers(-50, 50, size=(rows, 2, l)).astype(dt)
    x[:, :, l // 4: 3 * l // 4] = 7
    x = _sorted(x, descending)
    return np.ascontiguousarray(x[:, 0, :]), np.ascontiguousarray(x[:, 1, :])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["int32", "float32"])
def test_k2_tie_run_across_a_tile_cut(name, descending):
    """A run of equal keys in both runs spans the kernel's first tile
    boundary: the merge (key and payload) matches the reference, and the
    partition's cuts count, at every boundary, the a-elements the
    reference's merge put before it."""
    l = tmp.KERNEL_TILE
    a, b = _tie_across_the_cut(name, 2, l, seed=44, descending=descending)
    va, vb = _payloads(a)
    rk, rv = jmerge.merge_pairs(
        jnp.asarray(a), jnp.asarray(b), descending=descending, backend="xla",
        values=(jnp.asarray(va), jnp.asarray(vb)))
    ta, tb = to_torch(a), to_torch(b)
    gk, gv = tmp.merge_pairs_kv_blocks(ta, tb, to_torch(va), to_torch(vb),
                                       descending=descending)
    assert_same(rk, gk, "tie-run keys")
    assert_same(rv, gv, "tie-run payload")
    cuts = tmp.merge_path_partition(ta, tb, descending=descending)
    assert cuts.shape == (2, tmp.tiles_per_row(l) + 1) == (2, 3)
    from_a = np.asarray(rv) < a.size
    for t in range(cuts.shape[1]):
        d = min(t * tmp.KERNEL_TILE, 2 * l)
        np.testing.assert_array_equal(cuts[:, t].numpy(),
                                      from_a[:, :d].sum(-1))
    # the boundary sits inside the tie run, and both runs give to either
    # side of it
    cut = tmp.KERNEL_TILE
    assert (np.asarray(rk)[:, cut - 100: cut + 100] == 7).all()
    assert ((0 < cuts[:, 1]) & (cuts[:, 1] < l)).all()


def test_k2_partition_matches_the_reference_diagonal_search():
    """Ascending cuts against the reference's own ``_diag_search`` at the
    kernel's tile boundaries, on rows longer than a tile."""
    a, b = _runs("float32", 3, 5000, seed=45, descending=False)
    l = a.shape[-1]
    diag = np.minimum(np.arange(tmp.tiles_per_row(l) + 1) * tmp.KERNEL_TILE,
                      2 * l).astype(np.int32)
    ref = jmp._diag_search(jnp.asarray(a), jnp.asarray(b), jnp.asarray(diag))
    assert_same(ref, tmp.partition_plain(to_torch(a), to_torch(b)))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["int32", "uint32", "int8"])
def test_k2_merge_runs_match_the_reference_tree(name, descending):
    """The whole merge tree (8 runs of 128) through the engine's ``cuda``
    backend against the reference's ``xla`` tree, key and key-value."""
    x = _sorted(keys(name, (2, 8, 128), "mixed", seed=46), descending)
    v = np.arange(x.size, dtype=np.int32).reshape(x.shape)
    ref = jmerge.merge_runs(jnp.asarray(x), descending=descending)
    got = tmerge.merge_runs(to_torch(x), descending=descending,
                            backend="cuda")
    assert_same(ref, got, f"merge_runs {name}")
    rk, rv = jmerge.merge_runs(jnp.asarray(x), jnp.asarray(v),
                               descending=descending)
    gk, gv = tmerge.merge_runs(to_torch(x), to_torch(v),
                               descending=descending, backend="cuda")
    assert_same(rk, gk, "merge_runs kv keys")
    assert_same(rv, gv, "merge_runs kv payload")


def test_k2_descending_merge_on_the_cpu_is_the_flip_construction():
    """The plain descending merge equals flip-in / swap / ascending merge /
    flip-out spelled out, and the bitonic backend still runs it."""
    a, b = (to_torch(t) for t in _runs("int32", 2, 64, 47, True))
    want = tmp.rank_merge(b.flip(-1), a.flip(-1))[0].flip(-1)
    assert torch.equal(tmp.rank_merge(a, b, descending=True)[0], want)
    assert torch.equal(tmerge.merge_pairs(a, b, descending=True,
                                          backend="bitonic"), want)
