"""Parity of the port's kernel modules (their plain versions, which CPU
tensors run) with the JAX package's Pallas kernels in interpret mode.

K1 bitonic sort, K2 merge path, K3 LSD radix sort: same seeded numpy
inputs to both, bit-exact results.  Interpret-mode shapes are kept few:
each costs a second or more to trace.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, keys, to_torch
from repro.core import keycodec as jkc
from repro.kernels import bitonic_sort as jbs
from repro.kernels import merge_path as jmp
from repro.kernels import ops as jops
from repro.kernels import radix_sort as jrs
from repro_torch.core import keycodec as tkc
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import merge_path as tmp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import radix_sort as trs


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """CPU tensors must never reach a CUDA build or launch."""
    def _refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(_build, "load", _refuse)


# ---------------------------------------------------------------------------
# K1 — bitonic sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,descending", [
    ("float32", False), ("float32", True), ("bfloat16", True),
    ("int32", False), ("uint32", True), ("int8", False)])
def test_k1_sort_blocks_matches_pallas(name, descending):
    x = keys(name, (4, 256), "mixed", seed=11)
    ref = jbs.sort_blocks(jnp.asarray(x), descending=descending,
                          interpret=True)
    got = tbs.sort_blocks(to_torch(x), descending=descending)
    assert_same(ref, got, f"K1 {name} desc={descending}")


@pytest.mark.parametrize("name,descending", [
    ("float32", False), ("float32", True), ("int32", True),
    ("uint16", False)])
def test_k1_sort_kv_blocks_matches_pallas(name, descending):
    x = keys(name, (4, 128), "mixed", seed=12)
    # payloads with ties too: the composite comparator decides them
    v = np.random.default_rng(3).integers(-3, 4, size=x.shape) \
        .astype(np.int32)
    rk, rv = jbs.sort_kv_blocks(jnp.asarray(x), jnp.asarray(v),
                                descending=descending, interpret=True)
    gk, gv = tbs.sort_kv_blocks(to_torch(x), to_torch(v),
                                descending=descending)
    assert_same(rk, gk, "K1 kv keys")
    assert_same(rv, gv, "K1 kv payload")


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("n", [1 << p for p in range(1, 15)])
def test_k1_schedule_covers_the_network_in_order(n, kv):
    """K1's schedule (where the kernel runs each substage) covers exactly
    the network's substages in order; each step's substages sit where their
    partner distance belongs (thread < 16 <= warp < 512 <= shared; for
    key-value rows of 16384, 32 keys a thread: thread < 32 <= shared), a
    shared round holds at most log2(E) consecutive substages of one stage,
    and a row of 4096 keys takes 3 rounds, 16384 keys 6 (13 key-value)."""
    e = tbs.thread_keys(n, kv)
    span = tbs.shared_from(n, kv)
    assert (e, span) == ((32, 32) if kv and n == 16384 else (16, 512))
    steps = tbs.schedule(n, kv)
    assert tbs.network_order(n) == tbs._substages(n)
    assert [kj for _, kjs in steps for kj in kjs] == tbs._substages(n)
    for place, kjs in steps:
        lo, hi = {"thread": (1, e - 1), "warp": (e, span - 1),
                  "shared": (span, n)}[place]
        assert all(lo <= j <= hi for _, j in kjs), (place, kjs)
        assert len({k for k, _ in kjs}) == 1
        assert [j for _, j in kjs] == [kjs[0][1] >> i
                                       for i in range(len(kjs))]
        if place == "shared":
            assert len(kjs) <= e.bit_length() - 1
    rounds = sum(place == "shared" for place, _ in steps)
    assert rounds == {4096: 3, 16384: 13 if kv else 6}.get(n, rounds)


@pytest.mark.parametrize("n,descending", [(1024, False), (2048, True)])
def test_k1_network_in_the_kernel_order_matches_pallas(n, descending):
    """The plain network, run in the kernel's schedule, against the
    reference's Pallas K1 (interpret mode) at rows long enough for shared
    rounds: key-only and key-value (ties in keys and payloads)."""
    x = keys("float32", (2, n), "mixed", seed=n)
    ref = jbs.sort_blocks(jnp.asarray(x), descending=descending,
                          interpret=True)
    assert_same(ref, tbs.sort_blocks(to_torch(x), descending=descending),
                f"K1 n={n}")
    v = np.random.default_rng(n).integers(-3, 4, size=x.shape) \
        .astype(np.int32)
    rk, rv = jbs.sort_kv_blocks(jnp.asarray(x), jnp.asarray(v),
                                descending=descending, interpret=True)
    gk, gv = tbs.sort_kv_blocks(to_torch(x), to_torch(v),
                                descending=descending)
    assert_same(rk, gk, f"K1 kv keys n={n}")
    assert_same(rv, gv, f"K1 kv payload n={n}")


def test_k1_signed_zero_min_max_match_xla():
    """jnp.minimum(0.0, -0.0) is -0.0 but torch.minimum's is 0.0: the
    network's min/max must give XLA's bits in either operand order."""
    a = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -2.0], np.float32)
    b = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, 3.0], np.float32)
    for dt in (np.float32, jnp.bfloat16, np.float16):
        aa, bb = a.astype(dt), b.astype(dt)
        mn, mx = tbs._MinMax.apply(to_torch(aa), to_torch(bb))
        assert_same(jnp.minimum(aa, bb), mn, f"min {dt}")
        assert_same(jnp.maximum(aa, bb), mx, f"max {dt}")


def test_k1_signed_zeros_through_the_network():
    """A row of only ±0.0: the key-only network's arrangement of the two
    zeros (not a stable sort's) is the reference's, both directions."""
    x = np.where(np.random.default_rng(5).random((2, 64)) < 0.5, 0.0,
                 -0.0).astype(np.float32)
    for desc in (False, True):
        ref = jbs._apply_network(jnp.asarray(x), desc)
        assert_same(ref, tbs.sort_blocks(to_torch(x), descending=desc))


def test_k1_wrapper_rejects_non_power_of_two_rows():
    with pytest.raises(ValueError, match="power-of-two"):
        tbs.sort_blocks(torch.zeros(2, 6))


def test_k1_cuda_sort_autograd_matches_pallas_vjp():
    """The cuda backend's sort is a permutation: its backward scatter-adds
    the cotangent (the JAX package's custom_vjp)."""
    x = keys("float32", (3, 50), "uniform", seed=21)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    for desc in (False, True):
        gj = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jops.bitonic_sort(
            v, -1, desc, True)))(jnp.asarray(x))
        xt = to_torch(x).requires_grad_(True)
        (to_torch(w) * tops.bitonic_sort(xt, -1, desc)).sum().backward()
        assert_same(gj, xt.grad, f"grad desc={desc}")


def test_k1_plain_network_grad_matches_jax_autodiff_on_ties():
    """The plain network (``bitonic`` backend) differentiates like jnp's
    min/max: a tie splits the cotangent in halves."""
    from repro.core import sort_api
    x = np.array([[1.0, 1.0, 0.5, 2.0, 2.0, 2.0, -1.0, 0.0]], np.float32)
    w = np.arange(1, 9, dtype=np.float32)[None]
    for desc in (False, True):
        gj = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * sort_api.bitonic_sort(
            v, descending=desc)))(jnp.asarray(x))
        xt = to_torch(x).requires_grad_(True)
        (to_torch(w) * tbs.apply_network(xt, desc)).sum().backward()
        assert_same(gj, xt.grad, f"tie grad desc={desc}")


# ---------------------------------------------------------------------------
# K2 — merge path
# ---------------------------------------------------------------------------

def _runs(name, rows, l, seed, negative_zeros=False):
    """Two sorted runs per row sharing duplicates.  Without
    ``negative_zeros`` every -0.0 is +0.0: the reference kernel places
    elements by summing a one-hot row, and -0.0 + 0.0 is +0.0, so it
    turns each -0.0 it merges into +0.0 (see the divergence test)."""
    x = keys(name, (rows, 2, l), "mixed", seed)
    if not negative_zeros and name.startswith(("float", "bfloat")):
        x = np.where(x == 0, np.zeros((), x.dtype), x)
    x = np.sort(x.astype(np.float64) if name == "bfloat16" else x, axis=-1,
                kind="stable").astype(x.dtype)
    return x[:, 0, :], x[:, 1, :]


@pytest.mark.parametrize("name", ["float32", "int32", "bfloat16"])
def test_k2_merge_pairs_matches_pallas(name):
    a, b = _runs(name, 3, 512, seed=31)
    ref = jmp.merge_pairs_blocks(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)
    got = tmp.merge_pairs_blocks(to_torch(np.ascontiguousarray(a)),
                                 to_torch(np.ascontiguousarray(b)))
    assert_same(ref, got, f"K2 {name}")


@pytest.mark.parametrize("name", ["float32", "int16"])
def test_k2_merge_pairs_kv_matches_pallas(name):
    a, b = _runs(name, 2, 256, seed=32)
    va = np.arange(a.size, dtype=np.int32).reshape(a.shape)
    vb = va + a.size
    rk, rv = jmp.merge_pairs_kv_blocks(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        interpret=True)
    gk, gv = tmp.merge_pairs_kv_blocks(
        *(to_torch(np.ascontiguousarray(t)) for t in (a, b, va, vb)))
    assert_same(rk, gk, "K2 kv keys")
    assert_same(rv, gv, "K2 kv payload")


def test_k2_reference_kernel_turns_negative_zero_positive():
    """Divergence, on purpose: the Pallas merge returns +0.0 for every
    -0.0 it merges; the port's merge permutes its inputs and keeps the
    bits (as the JAX engine's own rank merge does).  Clearing the sign of
    the port's zeros gives the reference's bits exactly."""
    a, b = _runs("float32", 2, 256, seed=34, negative_zeros=True)
    ref = np.asarray(jmp.merge_pairs_blocks(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    got = tmp.merge_pairs_blocks(to_torch(np.ascontiguousarray(a)),
                                 to_torch(np.ascontiguousarray(b)))
    assert np.signbit(np.concatenate([a, b], -1)[np.concatenate(
        [a, b], -1) == 0]).any()
    assert not np.signbit(ref[ref == 0]).any()
    assert_same(ref, torch.where(got == 0, torch.zeros_like(got), got))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([a, b], -1).view(np.uint32), -1),
        np.sort(got.numpy().view(np.uint32), -1))
    from repro.engine import merge as jmerge
    assert_same(jmerge._rank_merge(jnp.asarray(a), jnp.asarray(b), None,
                                   None)[0], got)


def test_k2_strided_pair_views_merge_like_contiguous_runs():
    """The merge tree hands the kernel (rows, 2, L)[:, i, :] views."""
    a, b = _runs("float32", 4, 64, seed=33)
    pairs = to_torch(np.stack([a, b], axis=1))
    got = tmp.merge_pairs_blocks(pairs[:, 0, :], pairs[:, 1, :])
    want = tmp.merge_pairs_blocks(to_torch(np.ascontiguousarray(a)),
                                  to_torch(np.ascontiguousarray(b)))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K3 — LSD radix sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits_,digit_bits", [(32, 8), (16, 4), (8, 8)])
def test_k3_pass_kernels_match_pallas(bits_, digit_bits):
    """Per pass: histogram + stable rank (_digit_stats) and global
    positions (_global_pos) of the reference, against the plain versions,
    and the whole tiled pass (``digit_hist_plain``, ``tile_bases``,
    ``digit_scatter_plain``) against ``_pass_permutation``."""
    rng = np.random.default_rng(bits_)
    tile, tiles = 64, 6
    radix = 1 << digit_bits
    raw = rng.integers(0, 1 << bits_, size=(tiles, tile))
    raw[:, 1::3] = raw[:, ::3][:, :raw[:, 1::3].shape[1]]
    u = raw.astype(f"uint{bits_}")
    carrier = to_torch(u.view(f"int{bits_}"))
    for shift in range(0, bits_, digit_bits):
        d = ((u.astype(np.int64) >> shift) & (radix - 1)).astype(np.int32)
        hist_j, rank_j = jrs._digit_stats(jnp.asarray(d), radix, True)
        dt = trs._digits(carrier, shift, radix)
        assert_same(d, dt, "digits")
        hist_t, rank_t = trs.digit_stats(dt, radix)
        assert_same(hist_j, hist_t, f"hist shift={shift}")
        assert_same(rank_j, rank_t, f"rank shift={shift}")
        base = np.asarray(trs.tile_bases(hist_t, 1))
        pos_j = jrs._global_pos(jnp.asarray(d), jnp.asarray(base), rank_j,
                                radix, True)
        assert_same(pos_j, trs.global_pos(dt, torch.from_numpy(base),
                                          rank_t), f"pos shift={shift}")
        # the whole pass as rows of tiles: the per-tile histograms, then
        # every key and payload moved as the reference's permutation moves
        # them
        rows_u = u.reshape(2, tiles * tile // 2)
        rows_t = carrier.reshape(2, -1)
        vals = torch.arange(rows_u.size, dtype=torch.int32).reshape(2, -1)
        hist_r = trs.digit_hist_plain(rows_t, shift, digit_bits, tile)
        assert_same(hist_j, hist_r, f"tile hist shift={shift}")
        inv = jrs._pass_permutation(jnp.asarray(rows_u), shift, tile,
                                    digit_bits, True)
        kt, vt = trs.digit_scatter_plain(
            rows_t, vals, trs.tile_bases(hist_r, 2), shift, digit_bits, tile)
        assert_same(np.take_along_axis(rows_u, np.asarray(inv), axis=-1)
                    .view(f"int{bits_}"), kt, f"pass keys shift={shift}")
        assert_same(np.take_along_axis(vals.numpy(), np.asarray(inv),
                                       axis=-1), vt, f"pass vals shift={shift}")


@pytest.mark.parametrize("name", ["uint8", "uint16", "uint32"])
def test_k3_sort_blocks_match_pallas(name):
    bits_ = np.dtype(name).itemsize * 8
    rng = np.random.default_rng(41)
    u = rng.integers(0, 1 << bits_, size=(2, 700)).astype(name)
    u[:, 1::2] = u[:, ::2][:, :u[:, 1::2].shape[1]]
    u[:, -3:] = np.iinfo(name).max          # genuine keys equal to the pad
    v = np.arange(u.size, dtype=np.int32).reshape(u.shape)
    carrier = to_torch(u.view(f"int{bits_}"))
    ref = jrs.sort_blocks(jnp.asarray(u), tile=256, digit_bits=8,
                          interpret=True)
    assert_same(ref, trs.sort_blocks(carrier, digit_bits=8))
    rk, rv = jrs.sort_kv_blocks(jnp.asarray(u), jnp.asarray(v), tile=256,
                                digit_bits=8, interpret=True)
    gk, gv = trs.sort_kv_blocks(carrier, to_torch(v), digit_bits=8)
    assert_same(rk, gk, "K3 kv keys")
    assert_same(rv, gv, "K3 kv payload")


def test_k3_through_the_codec_matches_reference():
    """Encoded float keys, descending: radix output decodes to the
    reference's bits (-0.0 below +0.0 in the codec's total order)."""
    x = keys("float32", (1, 900), "mixed", seed=43)
    enc_j = jkc.encode(jnp.asarray(x), descending=True)
    ref = jkc.decode(jrs.sort_blocks(enc_j, interpret=True), x.dtype,
                     descending=True)
    enc_t = tkc.encode(to_torch(x), descending=True)
    got = tkc.decode(trs.sort_blocks(enc_t), torch.float32, descending=True)
    assert_same(ref, got)


def test_k3_pass_tile_counts_match():
    """The port's passes run the onesweep kernels' tiles: the reference's
    counts at that tile."""
    for n, name in ((5000, "float32"), (100, "int16"), (3, "uint8"),
                    (0, "int32")):
        assert trs.pass_tile_counts(n, getattr(torch, name), 8) == \
            jrs.pass_tile_counts(n, name, trs.ONESWEEP_TILE, 8)


def test_k3_wrappers_reject_rows_past_int32_positions():
    """Slots are int32 in the kernels (and in the reference): a row of 2^31
    keys is refused, not overflowed.  The expanded view holds no memory."""
    keys = torch.zeros(1, 1, dtype=torch.int8).expand(1, 1 << 31)
    with pytest.raises(ValueError, match="int32 positions"):
        trs.onesweep_hist(keys, 8)
    hist = torch.zeros(1, 1, 256, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 positions"):
        trs.onesweep_pass(keys, None, hist, 0, 8)
    many = torch.zeros(1, 1, dtype=torch.int8).expand(1 << 20, 1 << 23)
    with pytest.raises(ValueError, match="int32 tile ids"):
        trs.onesweep_hist(many, 8)


def test_k3_onesweep_wrappers_reject_what_the_kernels_do_not_take():
    keys = torch.zeros(2, 100, dtype=torch.int16)
    hist = trs.onesweep_hist(keys, 4)
    assert hist.shape == (2, 4, 16) and hist.dtype == torch.int32
    with pytest.raises(ValueError, match="digit_bits"):
        trs.onesweep_hist(keys, 3)
    with pytest.raises(ValueError, match="not a digit"):
        trs.onesweep_pass(keys, None, hist, 2, 4)
    with pytest.raises(ValueError, match="not a digit"):
        trs.onesweep_pass(keys, None, hist, 16, 4)
    with pytest.raises(ValueError, match="hist must be"):
        trs.onesweep_pass(keys, None, hist[:, :2], 0, 4)
    with pytest.raises(ValueError, match="payload"):
        trs.onesweep_pass(keys, keys.int()[:1], hist, 0, 4)
    with pytest.raises(ValueError, match="integer keys"):
        trs.onesweep_hist(keys.float(), 4)


def test_k3_pass_tile_counts_on_a_card_name_the_onesweep_tile():
    """Every device runs the kernels' (or their plain versions') 4096-key
    tiles, whatever the profile's ``radix_tile`` (K4's tile)."""
    from repro_torch.core import tuning
    before = tuning.active()
    tuning.set_active(dataclasses.replace(before, radix_tile=256,
                                          digit_bits=4))
    try:
        for n, name in ((5000, "float32"), (100, "int16"),
                        (1 << 20, "uint8")):
            dtype = getattr(torch, name)
            assert trs.pass_tile_counts(n, dtype) == \
                (-(-dtype.itemsize * 8 // 4), -(-n // trs.ONESWEEP_TILE))
    finally:
        tuning.set_active(before)


def test_radix_cost_prices_n_keys_and_selection_keeps_its_tile():
    """Under the card's profile (4096-key ``radix_tile``) a ``radix`` plan
    of n = 4097 is priced on 4097 keys, as K3 sorts them (no padding to
    8192); so is K4's ``selection_cost_ns``: its grid strides over the row
    and no longer follows the tile, which only the plain version reads."""
    from repro_torch.core import cost_model, tuning
    before = tuning.active()
    tuning.set_active(dataclasses.replace(
        before, run_len=tuning.CUDA_RUN_LEN,
        radix_tile=tuning.CUDA_RADIX_TILE))
    try:
        prof = tuning.active()
        c = prof.constants
        passes = -(-32 // prof.digit_bits)
        for n, batch in ((4097, 1), (4097, 3), (4096, 2), (1, 1)):
            assert cost_model.device_sort_cost_ns("radix", n, batch) == \
                c.radix * batch * n * passes
        assert cost_model.device_sort_cost_ns("radix", 4097) < \
            cost_model.device_sort_cost_ns("radix", 8192)
        assert prof.radix_tile == 4096
        for n, batch in ((4097, 1), (4097, 3), (4096, 2)):
            assert cost_model.selection_cost_ns(n, 8, batch=batch) == \
                c.select * batch * n * passes + c.torch * batch * 8 * 3.0
        assert cost_model.selection_cost_ns(4097, 8) < \
            cost_model.selection_cost_ns(8192, 8)
    finally:
        tuning.set_active(before)


def _onesweep_keys(bits_, rows, m, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << bits_, size=(rows, m))
    raw[:, 1::3] = raw[:, ::3][:, :raw[:, 1::3].shape[1]]
    raw[0, -5:] = (1 << bits_) - 1              # genuine keys at the pad key
    return raw.astype(f"uint{bits_}")


@pytest.mark.parametrize("bits_,digit_bits", [(8, 8), (8, 2), (16, 4),
                                              (16, 8), (32, 8), (32, 1)])
def test_k3_onesweep_hist_plain_matches_reference_digit_stats(bits_,
                                                              digit_bits):
    """The onesweep histogram of every pass is, row by row, the sum over
    the reference's tiles of its ``_digit_stats`` histogram (interpret
    mode), bit for bit."""
    rows, tile = 3, 256
    u = _onesweep_keys(bits_, rows, 6 * tile, bits_ * 10 + digit_bits)
    radix = 1 << digit_bits
    got = trs.onesweep_hist_plain(to_torch(u.view(f"int{bits_}")),
                                  digit_bits)
    assert got.shape == (rows, bits_ // digit_bits, radix)
    for p in range(bits_ // digit_bits):
        d = ((u.astype(np.int64) >> (p * digit_bits)) & (radix - 1)) \
            .astype(np.int32).reshape(rows * 6, tile)
        hist_j, _ = jrs._digit_stats(jnp.asarray(d), radix, True)
        want = np.asarray(hist_j).reshape(rows, 6, radix) \
            .sum(1, dtype=np.int32)
        assert_same(want, got[:, p], f"pass {p}")


def _reference_pass(u, vals, shift, digit_bits):
    """One digit pass of the reference (``_pass_permutation`` in interpret
    mode, then its gathers) over rows padded to its 256-key tile; the pads
    carry the maximum key, so a stable pass leaves them last."""
    rows, m = u.shape
    jk, jv, tile = jrs._padded(jnp.asarray(u), jnp.asarray(vals), 256)
    inv = jrs._pass_permutation(jk, shift, tile, digit_bits, True)
    return (np.asarray(jnp.take_along_axis(jk, inv, axis=-1))[:, :m],
            np.asarray(jnp.take_along_axis(jv, inv, axis=-1))[:, :m])


@pytest.mark.parametrize("bits_,digit_bits,m", [
    (8, 8, 5000), (16, 8, 4096), (16, 4, 700), (32, 8, 9000)])
def test_k3_onesweep_pass_plain_matches_reference(bits_, digit_bits, m):
    """Each onesweep pass (plain version, the kernels' 4096-key tiles, the
    last one of a row partial) against the reference's pass on the same
    keys, and the whole onesweep loop against the reference's
    ``sort_kv_blocks``; bit for bit, keys and payloads."""
    rows = 2
    u = _onesweep_keys(bits_, rows, m, m + bits_)
    vals = np.arange(rows * m, dtype=np.int32).reshape(rows, m)
    carrier = to_torch(u.view(f"int{bits_}"))
    hist = trs.onesweep_hist_plain(carrier, digit_bits)
    tk, tv = carrier, to_torch(vals)
    ju, jv = u, vals
    for shift in range(0, bits_, digit_bits):
        tk, tv = trs.onesweep_pass_plain(tk, tv, hist, shift, digit_bits)
        ju, jv = _reference_pass(ju, jv, shift, digit_bits)
        assert_same(ju.view(f"int{bits_}"), tk, f"keys shift={shift}")
        assert_same(jv, tv, f"payload shift={shift}")
    rk, rv = jrs.sort_kv_blocks(jnp.asarray(u), jnp.asarray(vals), tile=256,
                                digit_bits=digit_bits, interpret=True)
    gk, gv = trs.onesweep_sort_kv(carrier, to_torch(vals), digit_bits)
    assert_same(np.asarray(rk).view(f"int{bits_}"), gk, "sort keys")
    assert_same(rv, gv, "sort payload")
    assert_same(np.asarray(rk).view(f"int{bits_}"),
                trs.onesweep_sort_kv(carrier, None, digit_bits)[0],
                "key-only sort")
