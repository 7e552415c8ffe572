"""Parity of the port's radix select (K4's plain version, which CPU tensors
run) with the JAX package's ``kernels/radix_select.py``: its Pallas kernel
path in interpret mode, its host path and ``jax.lax.top_k``, on the same
seeded numpy inputs, bit for bit.

A selection has one result — exactly k survive, ties keep ascending index
and +0.0 ranks above -0.0 — so every engine of the reference gives the
port's bits.  Interpret-mode shapes are kept few and small: each costs a
second or more to trace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sort as jsort
import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, to_torch
from repro.core import keycodec as jkc
from repro.kernels import radix_select as jsel
from repro_torch.core import keycodec as tkc
from repro_torch.core import sortspec as tspec
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import radix_select as tsel

DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32", "int16",
          "uint16", "int8", "uint8"]


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """CPU tensors must never reach a CUDA build or launch."""
    def _refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(_build, "load", _refuse)


def _thresh_bits(enc, thresh):
    """The port's carrier threshold as the reference's unsigned dtype."""
    return np.asarray(thresh).view(np.asarray(enc).dtype)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("dist", ["mixed", "dup_heavy", "all_equal"])
def test_select_topk_matches_lax_top_k(name, dist):
    """Ties, ±0.0, ±inf and the dtype's extremes, k = 1 .. n, against the
    reference's host path and ``lax.top_k``."""
    x = keys(name, (3, 257), dist, seed=DTYPES.index(name))
    for k in (1, 2, 64, 256, 257):
        rv, ri = jsel.select_topk(jnp.asarray(x), k, use_kernel=False)
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tsel.select_topk(to_torch(x), k)
        assert_same(rv, gv, f"{name} {dist} k={k} values")
        assert_same(ri, gi, f"{name} {dist} k={k} indices")
        assert_same(lv, gv, f"{name} {dist} k={k} vs lax values")
        assert_same(li, gi, f"{name} {dist} k={k} vs lax indices")


@pytest.mark.parametrize("name,tile,digit_bits", [
    ("float32", 64, 8), ("bfloat16", 32, 4), ("int8", 100, 8),
    ("uint16", 64, 2), ("int32", 8, 8)])
def test_select_topk_matches_the_pallas_path(name, tile, digit_bits):
    """The reference's kernel path (per-tile Pallas histogram, interpret
    mode) at its own tile; the port at another tile gives the same bits:
    the counts do not depend on the tile."""
    x = keys(name, (2, 300), "mixed", seed=5)
    for k in (1, 50, 300):
        rv, ri = jsel.select_topk(jnp.asarray(x), k, use_kernel=True,
                                  interpret=True, tile=tile,
                                  digit_bits=digit_bits)
        for port_tile in (tile, 4096):
            gv, gi = tsel.select_topk(to_torch(x), k, tile=port_tile,
                                      digit_bits=digit_bits)
            assert_same(rv, gv, f"values k={k} tile={port_tile}")
            assert_same(ri, gi, f"indices k={k} tile={port_tile}")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["float32", "int16", "uint8"])
def test_kth_key_encoded_threshold_and_tie_budget(use_kernel, name):
    """The refinement pins the k-th smallest encoded key T and the tie
    budget r = k - #{enc < T}, as both reference engines do."""
    x = keys(name, (4, 50), "dup_heavy", seed=9)
    enc = jkc.encode(jnp.asarray(x), descending=True)
    tenc = tkc.encode(to_torch(x), descending=True)
    for k in (1, 10, 50):
        rt, rr = jsel.kth_key_encoded(enc, k, use_kernel=use_kernel,
                                      interpret=True, tile=16)
        gt, gr = tsel.kth_key_encoded(tenc, k, tile=16)
        np.testing.assert_array_equal(_thresh_bits(enc, gt.numpy()),
                                      np.asarray(rt))
        assert_same(rr, gr, f"tie budget k={k}")
        se = np.sort(np.asarray(enc), -1)
        np.testing.assert_array_equal(np.asarray(rt), se[:, k - 1])


@pytest.mark.parametrize("name", ["float32", "int8", "uint32"])
def test_digit_hist_matches_the_reference_masked_hist(name):
    """One pass of the plain histogram against the reference's
    ``_masked_hist`` (Pallas, interpret mode): the first, all-active pass
    and a later pass under a threshold prefix, with a ragged tail."""
    x = keys(name, (3, 203), "mixed", seed=21)
    enc = np.asarray(jkc.encode(jnp.asarray(x), descending=True))
    bits = enc.dtype.itemsize * 8
    db = 4
    tenc = tkc.encode(to_torch(x), descending=True)
    # the prefix of each row's median key: a realistic later pass
    prefix = np.sort(enc.astype(np.int64), -1)[:, 101]
    for shift in (bits - db, bits - 2 * db):
        hi = shift + db
        thresh = torch.from_numpy(prefix if hi < bits else prefix * 0)
        digits = (enc.astype(np.int64) >> shift) & ((1 << db) - 1)
        active = np.ones(enc.shape, bool) if hi >= bits else \
            (enc.astype(np.int64) >> hi) == (prefix[:, None] >> hi)
        ref = jsel._masked_hist(jnp.asarray(digits.astype(np.int32)),
                                jnp.asarray(active), 1 << db, 64, True)
        for tile in (8, 64, 1000):
            got = tsel.digit_hist(tenc, thresh, shift, db, tile, encode=False)
            assert_same(ref, got, f"encoded keys shift={shift} tile={tile}")
            got = tsel.digit_hist(to_torch(x), thresh, shift, db, tile,
                                  encode=True)
            assert_same(ref, got, f"source keys shift={shift} tile={tile}")


def test_select_topk_encoded_and_kv_match_reference():
    x = keys("int32", (2, 129), "dup_heavy", seed=4)
    pay = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    enc = jkc.encode(jnp.asarray(x), descending=True)
    re_, ri = jsel.select_topk_encoded(enc, 33, use_kernel=False)
    ge, gi = tsel.select_topk_encoded(tkc.encode(to_torch(x),
                                                 descending=True), 33)
    np.testing.assert_array_equal(np.asarray(re_),
                                  _thresh_bits(enc, ge.numpy()))
    assert_same(ri, gi)
    rk, rp, ri = jsel.select_topk_kv(jnp.asarray(x), jnp.asarray(pay), 33,
                                     use_kernel=False)
    gk, gp, gi = tsel.select_topk_kv(to_torch(x), to_torch(pay), 33)
    for r, g in ((rk, gk), (rp, gp), (ri, gi)):
        assert_same(r, g)


def test_select_through_the_front_door_with_batch_shapes():
    """(2, 3, 97) along either axis, through ``repro.sort.topk``."""
    x = keys("float32", (2, 3, 97), "mixed", seed=8)
    for axis, k in ((-1, 5), (1, 2)):
        rv, ri = jsort.topk(jnp.asarray(x), k, axis=axis, method="select")
        gv, gi = tsort.topk(to_torch(x), k, axis=axis, method="select",
                            device="cpu")
        assert_same(rv, gv, f"axis={axis}")
        assert_same(ri, gi, f"axis={axis}")


@pytest.mark.parametrize("k", [5, 300, 20000])
def test_card_ordering_route_matches_the_cpu_route(k):
    """The card orders the survivors with K1 (k <= 16384) or the merge
    path (K1 runs, K2 merges); through the plain versions on the CPU that
    route gives the CPU's stable ``torch.sort`` order bit for bit."""
    rng = np.random.default_rng(k)
    n = k + 4000
    idx = np.stack([np.sort(rng.choice(n, k, replace=False))
                    for _ in range(2)]).astype(np.int32)
    s = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(2, k))
                         .astype(np.int32))
    s[:, ::3] = torch.iinfo(torch.int32).max     # keys equal to the pad key
    i = torch.from_numpy(idx)
    ws, wi = tsel._order(s, i, n)
    gs, gi = tops.order_candidates(s, i, n, k, descending=False)
    assert torch.equal(ws, gs) and torch.equal(wi, gi)


def test_select_backend_front_door_and_spec_validation():
    """``method="select"`` runs top-k; plain sorts are a spec-layer error
    (a selection-only backend), as in the reference."""
    x = np.random.default_rng(11).standard_normal((2, 100)) \
        .astype(np.float32)
    v, i = tsort.topk(x, 7, method="select", device="cpu")
    lv, li = jax.lax.top_k(jnp.asarray(x), 7)
    assert_same(lv, v)
    assert_same(li, i)
    with pytest.raises(ValueError, match="selection-only"):
        tsort.sort(x, method="select", device="cpu")
    with pytest.raises(ValueError, match="selection-only"):
        tsort.argsort(x, method="select", device="cpu")
    with pytest.raises(ValueError, match="selection-only"):
        tsort.sort_kv(x, x, method="select", device="cpu")
    with pytest.raises(ValueError, match="1 <= k <= n"):
        tsort.topk(x, 0, method="select", device="cpu")
    caps = tspec.get_backend("select").capabilities
    assert caps.selection and not caps.supports_sort
    assert caps.substrate == "cuda" and not caps.supports_kv


def test_pass_tile_counts_match_the_reference_kernel_path():
    for n, name, tile, db in ((300, "float32", 64, 8), (5, "int8", 256, 4),
                              (1 << 20, "bfloat16", 4096, 8)):
        assert tsel.pass_tile_counts(n, getattr(torch, name), tile, db) == \
            jsel.pass_tile_counts(n, jnp.dtype(name), True, tile, db)
