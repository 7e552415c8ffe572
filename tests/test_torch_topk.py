"""Parity of the port's bitonic top-k (K5's plain version, which CPU
tensors run, and ``kernels/ops.bitonic_topk`` over it) with the JAX
package's ``kernels/bitonic_topk.py`` and ``kernels/ops.bitonic_topk`` in
interpret mode, on the same seeded numpy inputs, bit for bit.

The reference's top-k compares keys numerically (-0.0 == +0.0, taken in
index order), unlike ``lax.top_k`` and the ``select`` backend; the port's
``cuda`` backend follows it.  One fault of the reference is pinned here:
its hierarchical path pads the candidates with index -1, which wins ties
against genuine keys equal to the sentinel; the port pads with n and gives
``lax.top_k``'s indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sort as jsort
import repro_torch.sort as tsort
from _torch_parity import assert_same, keys, to_torch
from repro.kernels import bitonic_topk as jbt
from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_topk as tbt
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """CPU tensors must never reach a CUDA build or launch."""
    def _refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(_build, "load", _refuse)


@pytest.mark.parametrize("name,n,k", [
    ("float32", 64, 8), ("bfloat16", 128, 50), ("int32", 32, 32),
    ("uint32", 256, 1), ("int8", 16, 5), ("uint16", 64, 64),
    ("float16", 8, 3)])
def test_k5_topk_blocks_matches_pallas(name, n, k):
    x = keys(name, (5, n), "mixed", seed=n + k)
    rv, ri = jbt.topk_blocks(jnp.asarray(x), k, interpret=True)
    gv, gi = tbt.topk_blocks(to_torch(x), k)
    assert_same(rv, gv, f"K5 {name} values")
    assert_same(ri, gi, f"K5 {name} indices")


@pytest.mark.parametrize("name,dist", [("float32", "mixed"),
                                       ("int32", "dup_heavy"),
                                       ("bfloat16", "all_equal"),
                                       ("uint8", "mixed")])
@pytest.mark.parametrize("n,k,chunk", [
    (50, 7, 2048),          # one padded K5 row
    (300, 20, 64),          # per-chunk K5, then K1 over the candidates
    (300, 200, 64),         # k past the chunk (short of the sentinel
                            # keys, where the reference gives index -1)
    (1000, 1, 128)])
def test_bitonic_topk_matches_reference(name, dist, n, k, chunk):
    x = keys(name, (2, n), dist, seed=n + k)
    rv, ri = jops.bitonic_topk(jnp.asarray(x), k, chunk, True)
    gv, gi = tops.bitonic_topk(to_torch(x), k, chunk)
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


def test_bitonic_topk_candidates_past_k1_cap_match_reference():
    """625 chunks x 32 candidates = 20000 > 16384, K1's cap: the port
    orders them with the merge path (K1 runs + K2 merges, plain versions
    here), the reference with one whole-row network; same bits."""
    x = keys("float32", (1, 40000), "mixed", seed=3)
    rv, ri = jops.bitonic_topk(jnp.asarray(x), 32, 64, True)
    gv, gi = tops.bitonic_topk(to_torch(x), 32, 64)
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


def test_signed_zeros_tie_in_index_order():
    """The reference's top-k compares numerically: -0.0 and +0.0 tie and
    come out in index order, where ``lax.top_k`` ranks +0.0 first."""
    x = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0, -2.0, -3.0, -4.0]],
                 np.float32)
    rv, ri = jops.bitonic_topk(jnp.asarray(x), 3, 2048, True)
    gv, gi = tops.bitonic_topk(to_torch(x), 3)
    assert np.asarray(ri).tolist() == [[0, 1, 2]]
    assert jax.lax.top_k(jnp.asarray(x), 3)[1].tolist() == [[1, 3, 0]]
    assert_same(rv, gv)
    assert_same(ri, gi)


@pytest.mark.parametrize("name", ["float32", "int32"])
def test_reference_pads_candidates_with_minus_one_on_sentinel_rows(name):
    """A (1, 6144) row at the sentinel (-inf, INT32_MIN) but for lanes 100
    and 5000: the reference's hierarchical top-k returns index -1 in the
    last two places (its candidate pads tie the genuine keys and win on
    index -1); the port pads with n and returns ``lax.top_k``'s indices."""
    sent = -np.inf if name == "float32" else np.iinfo(np.int32).min
    x = np.full((1, 6144), sent, dtype=name)
    x[0, 100], x[0, 5000] = 1, 2
    ri = np.asarray(jops.bitonic_topk(jnp.asarray(x), 4, 2048, True)[1])
    assert ri.tolist() == [[5000, 100, -1, -1]]
    lv, li = jax.lax.top_k(jnp.asarray(x), 4)
    gv, gi = tops.bitonic_topk(to_torch(x), 4)
    assert gi.tolist() == [[5000, 100, 0, 1]]
    assert_same(lv, gv)
    assert_same(li, gi)
    # the select backend gives the same on the same row
    sv, si = tsort.topk(to_torch(x), 4, method="select", device="cpu")
    assert_same(li, si)


@pytest.mark.parametrize("n,chunk", [(40, 2048), (300, 64)])
def test_topk_gradient_matches_jax_grad(n, chunk):
    """The values' cotangent is scattered back to the selected indices,
    as the reference's custom VJP does."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((3, 9)).astype(np.float32)

    def jloss(a):
        return jnp.sum(jops.bitonic_topk(a, 9, chunk, True)[0] * w)

    ref = jax.grad(jloss)(jnp.asarray(x))
    xt = to_torch(x).requires_grad_(True)
    (tops.bitonic_topk(xt, 9, chunk)[0] * to_torch(w)).sum().backward()
    assert_same(ref, xt.grad)


@pytest.mark.parametrize("name,dist", [("float32", "mixed"),
                                       ("int16", "dup_heavy"),
                                       ("uint32", "mixed")])
def test_cuda_topk_through_the_front_door_matches_pallas(name, dist):
    """``repro_torch.sort.topk(method="cuda")`` against the reference's
    ``method="pallas"``, along an inner axis with leading dims."""
    x = keys(name, (2, 700, 3), dist, seed=17)
    rv, ri = jsort.topk(jnp.asarray(x), 40, axis=1, method="pallas")
    gv, gi = tsort.topk(to_torch(x), 40, axis=1, method="cuda",
                        device="cpu")
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


def test_topk_blocks_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="power-of-two"):
        tbt.topk_blocks(torch.zeros(2, 6), 2)
    with pytest.raises(ValueError, match="1 <= k <= n"):
        tbt.topk_blocks(torch.zeros(2, 8), 9)
    with pytest.raises(ValueError, match="1 <= k <= n"):
        tops.bitonic_topk(torch.zeros(2, 8), 0)


# ---------------------------------------------------------------------------
# K5's one-pass row top-k (k <= 256): the plain version of the kernels'
# decomposition against the reference's Pallas top-k in interpret mode, bit
# for bit (tolerance 0)
# ---------------------------------------------------------------------------

ALL_DTYPES = ["float32", "bfloat16", "float16", "int8", "uint8", "int16",
              "uint16", "int32", "uint32"]


def _rows_vs_reference(x, k, plan=None, chunk=2048):
    """``topk_rows_plain`` (cut as ``plan``) and the reference's
    ``ops.bitonic_topk`` on the same keys, bit for bit."""
    rv, ri = jops.bitonic_topk(jnp.asarray(x), k, chunk, True)
    gv, gi = tbt.topk_rows_plain(to_torch(x), k, plan)
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


@pytest.mark.parametrize("dist", ["mixed", "dup_heavy", "all_equal"])
@pytest.mark.parametrize("name", ALL_DTYPES)
def test_k5_rows_plain_matches_pallas(name, dist):
    """Every key dtype and distribution, rows of 50 (short kernel, k = 8)
    and 700 (a warp a row, k = 50; not a power of two)."""
    for n, k in ((50, 8), (700, 50)):
        _rows_vs_reference(keys(name, (3, n), dist, seed=n + k), k)


@pytest.mark.parametrize("name,n,k", [
    ("float32", 64, 8), ("bfloat16", 256, 50), ("int32", 32, 32),
    ("int8", 1024, 256), ("float16", 16, 1), ("int16", 512, 16)])
def test_k5_rows_plain_matches_pallas_topk_blocks(name, n, k):
    """Against the reference's kernel itself (``topk_blocks``, power-of-two
    rows), through the default cut."""
    x = keys(name, (4, n), "mixed", seed=n * k)
    rv, ri = jbt.topk_blocks(jnp.asarray(x), k, interpret=True)
    gv, gi = tbt.topk_rows_plain(to_torch(x), k)
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")


@pytest.mark.parametrize("k", [1, 8, 50, 256, 257])
def test_k5_rows_signed_zeros_sentinels_and_order(k):
    """Rows of 300 float32 keys: +-0.0 ties, a row at the sentinel (-inf),
    a -inf-masked row with fewer finite lanes than k, an ascending and a
    descending row.  k = 257 takes the network route (``topk_blocks`` and
    the candidates' ordering); k <= 256 the one-pass route, cut by the
    default plan and by CTAs of short stripes."""
    rng = np.random.default_rng(k)
    x = np.round(rng.standard_normal((6, 300)) * 2).astype(np.float32)
    x[0, ::2] = -0.0
    x[0, 1::2] = 0.0
    x[1] = -np.inf
    x[2, 7:] = -np.inf
    x[3] = np.arange(300, dtype=np.float32)
    x[4] = -np.arange(300, dtype=np.float32)
    rv, ri = jops.bitonic_topk(jnp.asarray(x), k, 2048, True)
    gv, gi = tops.bitonic_topk(to_torch(x), k)
    assert_same(rv, gv, "values")
    assert_same(ri, gi, "indices")
    if k <= tbt.MAX_K:
        _rows_vs_reference(x, k, tbt.RowPlan("stream", warps_per_row=8,
                                              ctas=3, stripe=13))


@pytest.mark.parametrize("name", ["float32", "int32", "int8", "bfloat16"])
@pytest.mark.parametrize("plan", [
    tbt.RowPlan("short", lanes=32),          # 16 keys a lane, 32 lanes
    tbt.RowPlan("stream"),                   # a warp a row
    tbt.RowPlan("stream", warps_per_row=8, ctas=1, stripe=40),
    tbt.RowPlan("stream", warps_per_row=8, ctas=6, stripe=7),
    tbt.RowPlan("stream", warps_per_row=8, ctas=40, stripe=1)])
def test_k5_rows_cut_anywhere_matches_pallas(name, plan):
    """Ties straddle every stripe, CTA and lane boundary: 4 distinct keys
    over rows of 300, k = 16, cut into lanes, stripes of 40, 7 and 1 keys
    (40 CTAs: more runs than the merge kernel's 32 warps)."""
    x = keys(name, (3, 300), "dup_heavy", seed=len(name))
    _rows_vs_reference(x, 16, plan)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 5), (17, 3), (31, 16),
                                 (33, 33), (256, 256), (1000, 1),
                                 (5000, 64)])
def test_k5_rows_short_long_and_full_rows(n, k):
    """n < 32, n = k, n not a power of two, and rows past the reference's
    chunk (k short of the sentinel keys, where the reference gives index
    -1)."""
    x = keys("float32", (2, n), "mixed", seed=n)
    _rows_vs_reference(x, k)


def test_k5_plan_cuts_the_main_path_shapes():
    """Router rows take the short kernel; vocabulary and sampling rows,
    and one long row, CTAs of 8 warps in one wave of the card and a merge
    launch; many rows of a few thousand keys a warp each."""
    assert tbt.plan(16384, 64, 8) == tbt.RowPlan("short", lanes=4)
    for rows, n, k in ((64, 128256, 50), (8, 256000, 50), (1, 1 << 24, 64)):
        p = tbt.plan(rows, n, k)
        assert p.route == "stream" and p.warps_per_row == tbt.WARPS
        assert 1 < p.ctas and rows * p.ctas * tbt.WARPS <= tbt.TARGET_WARPS
        assert p.stripe % tbt.STEP == 0
        assert p.stripe * tbt.WARPS * p.ctas >= n
        assert (p.stripe * tbt.WARPS * (p.ctas - 1)) < n
    assert tbt.plan(4096, 2048, 50) == tbt.RowPlan("stream")


def test_k5_composites_order_pairs_and_round_trip():
    """``pack`` orders (key descending, index ascending) with -0.0 == +0.0
    and gives the keys' bits back through ``unpack``."""
    x = torch.tensor([[-0.0, 0.0, 1.5, -np.inf, 1.5, -0.0]])
    c = tbt.pack(x)
    order = torch.sort(c, descending=True).indices[0].tolist()
    assert order == [2, 4, 0, 1, 5, 3]
    v, i = tbt.unpack(c, torch.float32)
    assert i.tolist() == [[0, 1, 2, 3, 4, 5]]
    assert_same(x.numpy(), v)


def test_topk_rows_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="1 <= k <= min"):
        tbt.topk_rows(torch.zeros(2, 300), 257)
    with pytest.raises(ValueError, match="1 <= k <= min"):
        tbt.topk_rows(torch.zeros(2, 8), 9)
    with pytest.raises(ValueError, match=r"\(rows, n\)"):
        tbt.topk_rows(torch.zeros(2, 3, 8), 2)
    with pytest.raises(ValueError, match="cover"):
        tbt.topk_rows(torch.zeros(2, 300), 8, tbt.RowPlan(
            "stream", warps_per_row=8, ctas=5, stripe=7))
    with pytest.raises(ValueError, match="short"):
        tbt.topk_rows(torch.zeros(2, 300), 32, tbt.RowPlan("short",
                                                           lanes=32))


# ---------------------------------------------------------------------------
# NaN pins: the probe of 40 float32 values with 6 NaNs (seed 0, k = 8)
# ---------------------------------------------------------------------------

def _nan_probe(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(40).astype(np.float32)
    x[rng.choice(40, 6, replace=False)] = np.nan
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cuda_topk_ranks_nan_first_like_select_and_lax(seed):
    """The port's ``cuda`` top-k (K5's plain version on the CPU) ranks NaN
    above every number, in index order, as the reference's ``select`` and
    ``jax.lax.top_k`` do: a serve on ``cuda`` picks a NaN logit exactly
    where ``lax.top_k`` would."""
    x = _nan_probe(seed)
    lv, li = jax.lax.top_k(jnp.asarray(x), 8)
    sv, si = jsort.topk(jnp.asarray(x), 8, method="select", interpret=True)
    tv, ti = tsort.topk(torch.from_numpy(x), 8, method="cuda", device="cpu")
    np.testing.assert_array_equal(np.asarray(li), np.asarray(si))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(li))
    assert_same(lv, tv)
    if seed == 0:
        assert ti.tolist() == [9, 12, 20, 23, 28, 39, 21, 6]


def test_reference_pallas_topk_does_not_skip_nan():
    """Pinned fault of the reference: its ``pallas`` top-k neither ranks
    NaN first nor skips it.  On the seed-0 probe it returns a set that is
    not the top 8 of the non-NaN values (it drops the 2nd and 3rd
    largest); the port does not follow it there."""
    x = _nan_probe(0)
    _, pi = jsort.topk(jnp.asarray(x), 8, method="pallas", interpret=True)
    pi = np.asarray(pi).tolist()
    assert pi == [21, 7, 24, 38, 19, 5, 35, 0]
    finite = np.flatnonzero(~np.isnan(x))
    top8 = finite[np.argsort(-x[finite], kind="stable")[:8]].tolist()
    assert top8 == [21, 6, 19, 7, 24, 38, 2, 33]
    assert set(pi) != set(top8)


@pytest.mark.parametrize("share", [0.15, 0.0005])
def test_cuda_topk_ranks_nan_first_on_long_rows(share):
    """The stream route's plain version (rows of the vocabulary, cut into
    CTAs and warps) ranks NaN first too, where NaNs are many and where
    they are rare: ``lax.top_k``'s indices."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 128256)).astype(np.float32)
    x[rng.random(x.shape) < share] = np.nan
    _, li = jax.lax.top_k(jnp.asarray(x), 50)
    tv, ti = tsort.topk(torch.from_numpy(x), 50, method="cuda", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(li))
