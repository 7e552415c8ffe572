"""``repro_torch.relational`` against the JAX package's ``repro.relational``.

One counterpart for each test of ``tests/test_relational.py`` (the mesh
variants excepted: the port raises for them).  The same seeded numpy
columns go through both packages on the CPU and the results are compared
bit for bit (values, counts, indices, pair order, padded tails and dtypes)
by ``_torch_parity.assert_same``, over every keycodec dtype and the
``mixed`` / ``dup_heavy`` / ``all_equal`` distributions (NaN-free floats,
as the sort contract asks; ``mixed`` holds ±0.0 and ±inf).

One tolerance, stated where it is used: a float ``sum``/``mean`` over a
group holding both +inf and -inf is NaN in both packages, and the NaN's
sign bit differs for bfloat16 (torch's bfloat16 rounding makes every NaN
+NaN, XLA keeps the host's default -NaN); such slots compare as "both NaN".
``test_bf16_nan_sum_sign_differs`` pins that divergence.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.relational as jrel
import repro_torch.relational as trel
from repro.engine import planner as jplanner
from repro.relational.relspec import RelSpec as JRelSpec
from repro_torch import BACKEND_NAMES
from repro_torch.engine import planner as tplanner
from repro_torch.relational.relspec import RelSpec as TRelSpec

from _torch_parity import assert_same, keys, to_numpy, to_torch

DTYPES = ("int8", "int16", "int32", "uint8", "uint16", "uint32",
          "float16", "bfloat16", "float32")
INT_DTYPES = DTYPES[:6]
FLOAT_DTYPES = DTYPES[6:]
DISTS = ("mixed", "dup_heavy", "all_equal")
N = 1000          # column length of the parametrised parity cases


def _t(x):
    return None if x is None else to_torch(x)


def _same(j, t, what: str, nan_equal: bool = False) -> None:
    """Every field of two result NamedTuples (or two arrays) bit for bit;
    ``nan_equal``: float slots that are NaN in both compare equal (see the
    module docstring)."""
    if isinstance(j, tuple):
        assert type(j).__name__ == type(t).__name__
        for f, jf, tf in zip(j._fields, j, t):
            if isinstance(jf, tuple):
                for i, (ja, ta) in enumerate(zip(jf, tf)):
                    _same(ja, ta, f"{what} {f}[{i}]", nan_equal)
            elif jf is None or tf is None:
                assert jf is None and tf is None, (what, f)
            else:
                _same(jf, tf, f"{what} {f}", nan_equal)
        return
    if nan_equal and isinstance(t, torch.Tensor) and t.dtype.is_floating_point:
        jn = np.isnan(np.asarray(j).astype(np.float32))
        tn = torch.isnan(t).numpy()
        np.testing.assert_array_equal(jn, tn, err_msg=f"{what} NaN slots")
        j = np.where(jn, np.zeros((), np.asarray(j).dtype), np.asarray(j))
        t = torch.where(torch.from_numpy(tn), torch.zeros((), dtype=t.dtype),
                        t)
    assert_same(j, t, what)


def _col(name, dist, seed, n=N):
    return keys(name, (n,), dist, seed)


# ---------------------------------------------------------------------------
# unique
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unique_matches_reference(dtype, dist):
    x = _col(dtype, dist, 1)
    j = jrel.unique(x, return_inverse=True, return_counts=True)
    t = trel.unique(_t(x), return_inverse=True, return_counts=True,
                    device="cpu")
    _same(j, t, f"unique {dtype} {dist}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_unique_fill_value_pads_tail(dtype):
    x = np.asarray([3, 1, 3, 1], np.int32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    j = jrel.unique(x, fill_value=7)
    t = trel.unique(_t(x), fill_value=7, device="cpu")
    _same(j, t, "fill")
    assert to_numpy(t.values).astype(np.float32).tolist() == [1, 3, 7, 7]


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
@pytest.mark.parametrize("method", ["auto", "radix", "merge"])
def test_unique_signed_zero_merges(dtype, method):
    """±0.0 are one value; which zero represents them is the backend's
    sort order (input order for stable comparison sorts, -0.0 first for
    the radix codec), the same in both packages."""
    z = np.asarray([0.0, -0.0, 1.0, -0.0] * 8, np.float32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    jm = {"auto": None, "radix": "radix", "merge": "merge"}[method]
    j = jrel.unique(z, return_inverse=True, return_counts=True, method=jm)
    t = trel.unique(_t(z), return_inverse=True, return_counts=True,
                    method=None if method == "auto" else method,
                    device="cpu")
    _same(j, t, f"signed zero {method}")
    assert int(t.n_unique) == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_unique_empty(dtype):
    x = np.zeros(0, jnp.bfloat16 if dtype == "bfloat16" else dtype)
    j = jrel.unique(x, return_inverse=True, return_counts=True)
    t = trel.unique(_t(x), return_inverse=True, return_counts=True,
                    device="cpu")
    _same(j, t, "empty")


@pytest.mark.parametrize("dtype", DTYPES)
def test_unique_all_equal(dtype):
    x = np.full(33, 7, np.int32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    j = jrel.unique(x, return_counts=True)
    t = trel.unique(_t(x), return_counts=True, device="cpu")
    _same(j, t, "all equal")
    assert int(t.n_unique) == 1 and int(t.counts[0]) == 33


def test_unique_repeated_calls_reuse_the_plan():
    """Counterpart of the reference's ``unique`` under ``jax.jit``: the
    port has no tracing, so a repeated call is the same eager call with
    its plan from the cache, and gives the same bits."""
    from repro_torch import obs
    x = _t(_col("int32", "mixed", 2))
    tplanner.clear_plan_cache()
    obs.clear()
    a = trel.unique(x, return_inverse=True, device="cpu")
    with obs.tracing():
        b = trel.unique(x, return_inverse=True, device="cpu")
        decisions = obs.events("relational_plan_decision")
        hits = obs.snapshot()["planner.plan_cache_hits"]["value"]
    obs.clear()
    # the relational plan and the plan of the sort under it, both cached
    assert decisions == [] and hits == 2
    _same(a, b, "repeat")
    _same(jrel.unique(np.asarray(x), return_inverse=True), b, "reference")


def test_unique_uint32_inverse():
    """uint32 keys across the whole range (torch has no uint32 compare or
    searchsorted on the CPU: the post-pass runs in the signed form)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    x[::3] = x[1::3][: len(x[::3])]
    x[:4] = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)
    j = jrel.unique(x, return_inverse=True, return_counts=True)
    t = trel.unique(_t(x), return_inverse=True, return_counts=True,
                    device="cpu")
    _same(j, t, "uint32 unique")
    assert t.values.dtype == torch.uint32 and t.inverse.dtype == torch.int32


# ---------------------------------------------------------------------------
# group_by
# ---------------------------------------------------------------------------

AGG_ALL = ("sum", "min", "max", "count", "mean")


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_by_matches_reference(dtype, dist):
    """Keys of ``dtype`` in ``dist``, values of ``dtype`` in ``mixed``
    (extremes, ±0.0, ±inf: wrapping integer sums, signed-zero min/max)."""
    k = _col(dtype, dist, 3)
    v = _col(dtype, "mixed", 4)
    j = jrel.group_by(k, v, agg=AGG_ALL)
    t = trel.group_by(_t(k), _t(v), agg=AGG_ALL, device="cpu")
    _same(j, t, f"group_by {dtype} {dist}", nan_equal=True)


@pytest.mark.parametrize("vdtype", DTYPES)
def test_group_by_single_agg_and_empty(vdtype):
    k = np.asarray([2, 2, 2], np.int32)
    v = np.asarray([1, 10, 100], np.int32).astype(
        jnp.bfloat16 if vdtype == "bfloat16" else vdtype)
    for agg in AGG_ALL:
        _same(jrel.group_by(k, v, agg=agg),
              trel.group_by(_t(k), _t(v), agg=agg, device="cpu"), agg)
    ek, ev = np.zeros(0, np.int32), v[:0]
    _same(jrel.group_by(ek, ev, agg=AGG_ALL),
          trel.group_by(_t(ek), _t(ev), agg=AGG_ALL, device="cpu"), "empty")


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
def test_group_by_signed_zero_min_max(dtype):
    """XLA's rule: a group holding 0.0 and -0.0 has min -0.0 and max
    +0.0, in either order (torch's segment and scatter reductions keep the
    first operand instead)."""
    dt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    k = np.asarray([0, 0, 1, 1, 2, 2, 3], np.int32)
    v = np.asarray([0.0, -0.0, -0.0, 0.0, -0.0, -0.0, 0.0],
                   np.float32).astype(dt)
    j = jrel.group_by(k, v, agg=("min", "max"))
    t = trel.group_by(_t(k), _t(v), agg=("min", "max"), device="cpu")
    _same(j, t, "signed zero min/max")
    mn = np.signbit(to_numpy(t.aggregates[0]).astype(np.float32))[:4]
    mx = np.signbit(to_numpy(t.aggregates[1]).astype(np.float32))[:4]
    assert mn.tolist() == [True, True, True, False]
    assert mx.tolist() == [False, False, True, False]


@pytest.mark.parametrize("vdtype", ["int8", "uint8", "int16", "uint32"])
def test_group_by_narrow_sum_wraps(vdtype):
    """An integer sum wraps in the column's dtype, as XLA's does."""
    info = np.iinfo(vdtype)
    k = np.repeat(np.arange(4, dtype=np.int32), 50)
    v = np.full(200, info.max, vdtype)
    v[::7] = info.min
    j = jrel.group_by(k, v, agg=("sum", "mean"))
    t = trel.group_by(_t(k), _t(v), agg=("sum", "mean"), device="cpu")
    _same(j, t, f"{vdtype} sums")
    assert t.aggregates[0].dtype == getattr(torch, vdtype)


def test_bf16_nan_sum_sign_differs():
    """A bfloat16 group holding +inf and -inf sums to NaN in both
    packages; the JAX package's NaN has its sign bit set (the host's
    default NaN), torch rounds every NaN to +NaN (0x7FC0).  Both are NaN;
    the parity tests compare such slots as NaN."""
    k = np.zeros(2, np.int32)
    v = np.asarray([np.inf, -np.inf], np.float32).astype(jnp.bfloat16)
    j = jrel.group_by(k, v, agg="sum").aggregates[0][:1]
    t = trel.group_by(_t(k), _t(v), agg="sum", device="cpu").aggregates[0][:1]
    assert np.asarray(j).view(np.uint16).tolist() == [0xFFC0]
    assert t.view(torch.int16).tolist() == [0x7FC0]


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_join_matches_reference_order(dtype, dist):
    lk = _col(dtype, dist, 5, n=97)
    rk = _col(dtype, dist, 6, n=61)
    j = jrel.join(lk, rk)
    t = trel.join(_t(lk), _t(rk), device="cpu")
    _same(j, t, f"join {dtype} {dist}")


@pytest.mark.parametrize("fill", [None, -1, 9])
def test_join_size_fill_and_overflow(fill):
    lk = np.asarray([1, 1], np.int32)
    rk = np.asarray([1, 1, 1], np.int32)
    _same(jrel.join(lk, rk, size=8, fill_value=fill),
          trel.join(_t(lk), _t(rk), size=8, fill_value=fill, device="cpu"),
          "join fill")
    with pytest.raises(ValueError, match="pass size >= 6"):
        trel.join(_t(lk), _t(rk), size=4, device="cpu")


def test_join_empty_sides_and_no_matches():
    for lk, rk, size in ((np.zeros(0, np.int32), np.asarray([1], np.int32),
                          2),
                         (np.asarray([1, 2], np.int32),
                          np.asarray([3, 4], np.int32), None)):
        _same(jrel.join(lk, rk, size=size),
              trel.join(_t(lk), _t(rk), size=size, device="cpu"), "join")


# ---------------------------------------------------------------------------
# rle / delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rle_round_trip_and_counts(dtype, dist):
    x = _col(dtype, dist, 7)
    j = jrel.run_length_encode(x)
    t = trel.run_length_encode(_t(x), device="cpu")
    _same(j, t, f"rle {dtype} {dist}")
    _same(jrel.rle_decode(j.values, j.run_lengths, N),
          trel.rle_decode(t.values, t.run_lengths, N), "rle decode")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rle_assume_sorted_skips_the_sort(dtype):
    s = np.asarray([1, 1, 2, 5, 5, 5], np.int32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    j = jrel.run_length_encode(s, assume_sorted=True, fill_value=0)
    t = trel.run_length_encode(_t(s), assume_sorted=True, fill_value=0,
                               device="cpu")
    _same(j, t, "rle sorted")
    assert t.run_lengths[:3].tolist() == [2, 1, 3]


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_delta_round_trip_including_wraparound(dtype, dist):
    x = _col(dtype, dist, 8)
    j = jrel.delta_encode(x)
    t = trel.delta_encode(_t(x), device="cpu")
    _same(j, t, f"delta {dtype} {dist}")
    _same(jrel.delta_decode(j.deltas), trel.delta_decode(t.deltas),
          "delta decode")
    np.testing.assert_array_equal(to_numpy(trel.delta_decode(t.deltas)),
                                  np.sort(x))


def test_delta_uint32_wraparound():
    """Deltas across the whole uint32 range wrap modulo 2^32 (torch has no
    uint32 subtraction on the CPU: int64, cut back)."""
    x = np.asarray([0xFFFFFFFF, 0, 1, 0x80000000, 0x7FFFFFFF, 5],
                   np.uint32)
    j = jrel.delta_encode(x)
    t = trel.delta_encode(_t(x), device="cpu")
    _same(j, t, "uint32 delta")
    assert t.deltas.dtype == torch.uint32
    _same(np.sort(x), trel.delta_decode(t.deltas), "uint32 decode")
    # not sorted first: every delta of this order wraps
    w = np.asarray([0xFFFFFFFF, 0, 0xFFFFFFFF, 1], np.uint32)
    _same(jrel.delta_encode(w, assume_sorted=True).deltas,
          trel.delta_encode(_t(w), assume_sorted=True, device="cpu").deltas,
          "wrapping deltas")


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_histogram_matches_reference_on_same_edges(dtype, dist):
    x = _col(dtype, dist, 9)
    _same(jrel.histogram(x, 16), trel.histogram(_t(x), 16, device="cpu"),
          f"histogram {dtype} {dist}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_histogram_pinned_range_excludes_outliers(dtype):
    x = _col(dtype, "mixed", 10)
    for bins, lo, hi in ((2, 0.0, 2.0), (7, -3.5, 3.5), (3, 5.0, 5.0)):
        _same(jrel.histogram(x, bins, lo=lo, hi=hi),
              trel.histogram(_t(x), bins, lo=lo, hi=hi, device="cpu"),
              f"histogram [{lo}, {hi}]")


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantiles_are_lower_order_statistics(dtype, dist):
    x = _col(dtype, dist, 11)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)
    _same(jrel.quantiles(x, qs), trel.quantiles(_t(x), qs, device="cpu"),
          f"quantiles {dtype} {dist}")


# ---------------------------------------------------------------------------
# group_ranks (the MoE dispatch primitive)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_group_ranks_one_hot_path(dtype, dist):
    """``mixed`` holds keys outside [0, 7): an all-zero one-hot row (rank
    0), counted in no group."""
    x = _col(dtype, dist, 12)
    _same(jrel.group_ranks(x, 7), trel.group_ranks(_t(x), 7, device="cpu"),
          f"one-hot {dtype} {dist}")


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", ["int16", "int32", "uint16", "uint32"])
def test_group_ranks_sort_path_matches_one_hot(dtype, dist):
    """A domain above ONE_HOT_MAX_GROUPS rides the stable sort.  (The
    reference cannot build 600 in an 8-bit key dtype, so 8-bit keys take
    the one-hot path only.)"""
    x = _col(dtype, dist, 13)
    j = jrel.group_ranks(x, 600)
    t = trel.group_ranks(_t(x), 600, device="cpu")
    _same(j, t, f"sort path {dtype} {dist}")
    if dist != "mixed":     # every key in [0, 600): the one-hot agrees
        oh = trel.group_ranks(_t(x).reshape(1, -1), 600, device="cpu")
        assert torch.equal(oh.ranks[0], t.ranks)


def test_reference_group_ranks_clips_narrow_keys_in_their_dtype():
    """The reference clips 8-bit keys to ``num_groups - 1`` in the keys'
    own dtype: for int8 and 600 groups that raises, for uint8 the bound
    wraps to 599 % 256 = 87 and keys above it are counted there.  The port
    widens the keys: the same ranks, each key counted at itself."""
    with pytest.raises(OverflowError):
        jrel.group_ranks(_col("int8", "dup_heavy", 21), 600)
    x = _col("uint8", "mixed", 21)          # holds 255
    j = jrel.group_ranks(x, 600)
    t = trel.group_ranks(_t(x), 600, device="cpu")
    _same(j.ranks, t.ranks, "uint8 ranks")
    assert np.asarray(j.counts).tolist() == np.bincount(
        np.minimum(x, 599 % 256), minlength=600).tolist()
    assert t.counts.tolist() == np.bincount(x, minlength=600).tolist()
    oh = trel.group_ranks(_t(x).reshape(1, -1), 600, device="cpu")
    assert torch.equal(t.ranks, oh.ranks[0])


def test_group_ranks_batched_and_constrained():
    x = _col("int32", "dup_heavy", 14, n=64).reshape(4, 16)
    called = []
    t = trel.group_ranks(_t(x), 5, device="cpu",
                         constrain=lambda oh: (called.append(oh.shape),
                                               oh)[1])
    assert called == [(4, 16, 5)]
    _same(jrel.group_ranks(x, 5), t, "batched")


# ---------------------------------------------------------------------------
# RelSpec front door: every invalid combination raises in canonical, with
# the reference's message
# ---------------------------------------------------------------------------

_F32, _I32, _I16 = np.float32, np.int32, np.int16


@pytest.mark.parametrize("kw,x,values,match", [
    (dict(op="nope"), np.zeros(3, _I32), None, "op must be"),
    (dict(op="unique"), np.zeros((2, 3), _I32), None, "1-D"),
    (dict(op="unique", method="warp"), np.zeros(3, _I32), None,
     "method must be"),
    (dict(op="histogram", num_bins=4, method="radix"), np.zeros(3, _F32),
     None, "must be 'auto'"),
    (dict(op="group_by", agg=("sum", "median")), np.zeros(3, _I32),
     np.zeros(3, _I32), "unknown aggregates"),
    (dict(op="group_by"), np.zeros(3, _I32), None, "needs a values column"),
    (dict(op="group_by"), np.zeros(3, _I32), np.zeros(4, _I32), "must match"),
    (dict(op="join"), np.zeros(3, _I32), np.zeros(3, _I16),
     "dtypes must match"),
    (dict(op="join", size=0), np.zeros(3, _I32), np.zeros(3, _I32),
     "size must be"),
    (dict(op="unique", size=4), np.zeros(3, _I32), None, "join-only"),
    (dict(op="delta"), np.zeros(3, _F32), None, "integer"),
    (dict(op="unique", assume_sorted=True), np.zeros(3, _I32), None,
     "rle/delta"),
    (dict(op="unique", num_bins=3), np.zeros(3, _I32), None,
     "histogram-only"),
    (dict(op="group_by", return_counts=True), np.zeros(3, _I32),
     np.zeros(3, _I32), "unique-only"),
    (dict(op="quantile"), np.zeros(3, _F32), None, "needs qs"),
    (dict(op="quantile", qs=(1.5,)), np.zeros(3, _F32), None, r"\[0, 1\]"),
    (dict(op="quantile", qs=(0.5,)), np.zeros(0, _F32), None, "empty"),
    (dict(op="unique", qs=(0.5,)), np.zeros(3, _I32), None,
     "quantile-only"),
    (dict(op="group_ranks"), np.zeros(3, _I32), None, "num_groups"),
    (dict(op="group_ranks", num_groups=4), np.zeros(3, _F32), None,
     "integers"),
    (dict(op="unique", axis_name="data"), np.zeros(3, _I32), None,
     "requires a mesh"),
])
def test_relspec_validation_errors(kw, x, values, match):
    """The same error, with the same message, in both packages."""
    with pytest.raises(ValueError, match=match):
        JRelSpec(**kw).canonical(
            jnp.asarray(x), None if values is None else jnp.asarray(values))
    with pytest.raises(ValueError, match=match) as got:
        TRelSpec(**kw).canonical(_t(x), _t(values))
    with pytest.raises(ValueError) as want:
        JRelSpec(**kw).canonical(
            jnp.asarray(x), None if values is None else jnp.asarray(values))
    assert str(got.value) == str(want.value).replace("'xla'", "'torch'") \
        or "method must be" in match


@pytest.mark.parametrize("op", ["unique", "group_by", "join"])
def test_relspec_mesh_waits_for_the_distributed_tier(op):
    """The reference rejects a mesh for join and runs unique/group_by over
    it; the port raises for every op until the distributed tier is
    ported."""
    x = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 11"):
        TRelSpec(op=op, mesh=object()).canonical(x, x)
    with pytest.raises(NotImplementedError, match="item 11"):
        trel.unique(x, mesh=object(), axis_name="data", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        trel.unique(x, method="spill", device="cpu")


def test_relspec_canonical_is_idempotent_and_static_key_hashable():
    spec = TRelSpec(op="group_by", agg="sum").canonical(
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    assert spec.agg == ("sum",) and spec.method == "auto"
    again = spec.canonical(torch.zeros(4, dtype=torch.int32),
                           torch.zeros(4, dtype=torch.int32))
    assert again.agg == spec.agg and again.method == spec.method
    spec2 = dataclasses.replace(spec)
    assert hash(spec.static_key((4,), torch.int32)) == \
        hash(spec2.static_key((4,), torch.int32))
    assert spec.static_key((4,), torch.int32)[-1] == "int32"


# ---------------------------------------------------------------------------
# planner: relational pricing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("op", ["group_by", "join"])
def test_choose_relational_prices_stable_ops_at_merge_fallback(op, device):
    """Non-stable candidates of an order-sensitive op cost what the stable
    merge fallback costs (planning needs no card)."""
    from repro_torch.core import cost_model
    plan = tplanner.choose_relational(op, 1 << 20, dtype=torch.int32,
                                      device=device)
    for name in ("bitonic", "cuda"):
        assert plan.costs[name] == pytest.approx(plan.costs["merge"])
    raw = cost_model.relational_cost_ns(op, "cuda", 1 << 20,
                                        run_len=plan.run_len,
                                        plain=device == "cpu")
    assert raw != pytest.approx(plan.costs["cuda"])
    assert plan.stable_run_method == ("radix" if device == "cuda"
                                      else "torch")


@pytest.mark.parametrize("op", ["unique", "group_by", "join", "rle",
                                "delta"])
@pytest.mark.parametrize("n", [64, 4096, 8192])
def test_auto_plan_matches_reference_on_cpu(op, n):
    """Off the card both planners pick the library sort at these sizes
    (``xla`` there, ``torch`` here)."""
    want = jplanner.choose_relational(op, n, dtype=jnp.int32).method
    got = tplanner.choose_relational(op, n, dtype=torch.int32,
                                     device="cpu").method
    assert got == BACKEND_NAMES[want]


def test_choose_relational_on_the_card_at_scale():
    """On the card the seed constants put a 60M-row sort-backed op on the
    radix kernels (K3), the sketches outside the sort planner."""
    for op in ("unique", "group_by", "join", "rle", "delta"):
        plan = tplanner.choose_relational(op, 60_000_000, dtype=torch.int32,
                                          device="cuda")
        assert plan.method == "radix", (op, plan.costs)
        assert plan.run_method == plan.merge_backend == "cuda"


def test_choose_relational_respects_requested_method():
    plan = tplanner.choose_relational("unique", 256, dtype=torch.int32,
                                      requested="radix", device="cpu")
    assert plan.method == "radix"


def test_choose_relational_rejects_sketch_ops():
    for op in ("histogram", "quantile", "group_ranks"):
        with pytest.raises(ValueError, match="sort-backed"):
            tplanner.choose_relational(op, 64, device="cpu")


def test_choose_relational_cached_hits():
    p1 = tplanner.choose_relational_cached("unique", 512, dtype=torch.int32,
                                           device="cpu")
    p2 = tplanner.choose_relational_cached("unique", 512, dtype=torch.int32,
                                           device="cpu")
    p3 = tplanner.choose_relational_cached("unique", 512, dtype=torch.int32,
                                           device="cuda")
    assert p1 is p2 and p3 is not p1


@pytest.mark.parametrize("method", ["torch", "merge", "radix", "bitonic",
                                    "cuda"])
def test_method_pin_runs_that_backend(method):
    """Each pinned backend against the reference's same backend."""
    x = _col("float32", "mixed", 15, n=40)
    jm = {v: k for k, v in BACKEND_NAMES.items()}[method]
    for op in ("unique", "rle"):
        j = jrel.run(JRelSpec(op=op, method=jm), x)
        t = trel.run(TRelSpec(op=op, method=method), _t(x), device="cpu")
        _same(j, t, f"{op} {method}")
    k, v = _col("int16", "dup_heavy", 16, n=40), _col("float32", "mixed", 17,
                                                        n=40)
    _same(jrel.group_by(k, v, agg=AGG_ALL, method=jm),
          trel.group_by(_t(k), _t(v), agg=AGG_ALL, method=method,
                        device="cpu"), f"group_by {method}", nan_equal=True)
    _same(jrel.join(k, k[::-1].copy(), method=jm),
          trel.join(_t(k), _t(k[::-1].copy()), method=method, device="cpu"),
          f"join {method}")


# ---------------------------------------------------------------------------
# devices and obs
# ---------------------------------------------------------------------------

def test_wrappers_run_on_the_card_by_default():
    """``device="cuda"`` (the default) runs on the card, or raises without
    one: never a silent CPU run."""
    x = np.arange(8, dtype=np.int32)
    calls = (lambda: trel.unique(x), lambda: trel.group_by(x, x),
             lambda: trel.join(x, x), lambda: trel.run_length_encode(x),
             lambda: trel.delta_encode(x), lambda: trel.histogram(x, 4),
             lambda: trel.quantiles(x, (0.5,)),
             lambda: trel.group_ranks(x, 8))
    for call in calls:
        if torch.cuda.is_available():
            assert all(f.is_cuda for f in call() if isinstance(
                f, torch.Tensor))
        else:
            with pytest.raises(RuntimeError, match="is_available"):
                call()


def test_relational_ops_emit_spans_and_counters():
    from repro_torch import obs
    obs.clear()
    with obs.tracing():
        trel.unique(_t(_col("int32", "mixed", 18, n=32)), device="cpu")
        trel.group_by(_t(_col("int32", "dup_heavy", 19, n=32)),
                      _t(_col("int32", "mixed", 20, n=32)), device="cpu")
        snap = obs.snapshot()
        names = [s["name"] for s in obs.spans()]
        decisions = obs.events("relational_plan_decision")
    obs.clear()
    assert snap["relational.unique"]["value"] == 1
    assert snap["relational.group_by"]["value"] == 1
    assert "relational.unique" in names and "relational.group_by" in names
    # the sort under each op is a child span of the relational span
    assert "engine.sort" in names and "engine.sort_kv" in names
    assert all(d["device"] == "cpu" for d in decisions)


# ---------------------------------------------------------------------------
# the reference's consumers, fed through the port
# ---------------------------------------------------------------------------

def test_pipeline_dedup_fingerprints_through_the_port():
    """The data pipeline's dedup keys are uint32 row fingerprints: the
    port's ``unique(return_inverse=True)`` on them gives the reference's
    inverse, hence its keep mask."""
    from repro.data import pipeline
    rows = np.asarray([[1, 2, 3], [4, 5, 6], [1, 2, 3], [7, 8, 9],
                       [4, 5, 6]], np.int32)
    h = pipeline.row_fingerprints(rows)
    assert h.dtype == np.uint32
    t = trel.unique(_t(h), return_inverse=True, device="cpu")
    _same(jrel.unique(h, return_inverse=True), t, "fingerprints")
    inv = t.inverse.numpy()
    order = np.argsort(inv, kind="stable")
    keep = pipeline._first_occurrence_mask(rows, inv[order], order)
    assert keep.tolist() == pipeline.dedup_rows(rows).tolist() == \
        [True, True, False, True, False]


def test_pipeline_batch_dedup_through_the_port():
    from repro.data import pipeline
    cfg = pipeline.DataConfig(vocab_size=16, seq_len=8, global_batch=64,
                              seed=3, motif_len=4, n_motifs=2)
    tokens = pipeline.SyntheticLM(cfg).shard_at(0, 0, 1)["tokens"]
    h = pipeline.row_fingerprints(tokens)
    t = trel.unique(_t(h), return_inverse=True, return_counts=True,
                    device="cpu")
    _same(jrel.unique(h, return_inverse=True, return_counts=True), t,
          "batch fingerprints")
    inv = t.inverse.numpy()
    order = np.argsort(inv, kind="stable")
    keep = pipeline._first_occurrence_mask(tokens, inv[order], order)
    assert keep.tolist() == pipeline.dedup_rows(tokens).tolist()


def test_serve_batch_accounting_groups_by_prompt_length():
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    spec = [(4, 10), (9, 20), (4, 30)]
    acct = tserve.batch_accounting(
        [tserve.Request(rid=i, prompt=np.zeros(p, np.int32),
                        out=np.zeros(o, np.int32))
         for i, (p, o) in enumerate(spec)], device="cpu")
    want = jserve.batch_accounting(
        [jserve.Request(rid=i, prompt=np.zeros(p, np.int32),
                        out=np.zeros(o, np.int32))
         for i, (p, o) in enumerate(spec)])
    assert acct == want == [(4, 2, 20.0), (9, 1, 20.0)]
    assert tserve.batch_accounting([], device="cpu") == []


def test_moe_routing_ids_group_ranks():
    """The MoE layer's call: (B, S*k) expert ids of its router, one-hot
    ranks per batch row, the one-hot handed to ``constrain``."""
    import jax
    from repro.configs.base import MoEConfig
    from repro.models import moe
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0, d_ff_expert=8)
    params, _ = moe.init(jax.random.PRNGKey(0), 16, cfg, "gelu", jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 6, 16), jnp.float32)
    import repro.sort as jsort
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, params["router"]),
                           axis=-1)
    _, gate_i = jsort.topk(probs, cfg.top_k, method=cfg.router_method)
    ids = np.asarray(gate_i).reshape(2, 6 * cfg.top_k).astype(np.int32)
    seen = []
    t = trel.group_ranks(_t(ids), 4, device="cpu",
                         constrain=lambda oh: (seen.append(oh.shape), oh)[1])
    _same(jrel.group_ranks(ids, 4), t, "moe ranks")
    assert seen == [(2, 12, 4)]
