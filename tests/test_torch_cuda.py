"""The port's CUDA kernels against their plain PyTorch versions, on the
card, bit for bit.  Skipped where there is no card (the CPU tier-1 run);
run on a machine with one::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as bs
from repro_torch.kernels import merge_path as mp
from repro_torch.kernels import radix_sort as rsk

# the condition is a string: evaluated when each test is set up, never
# while the module is imported
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card")]

DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32", "int16",
          "uint16", "int8", "uint8"]


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _same(x, y):
    assert x.dtype == y.dtype and x.shape == y.shape
    assert torch.equal(_bits(x), _bits(y))


def _keys(shape, name, seed):
    """Heavy ties, ±0.0 and ±inf (floats) or the dtype's extremes."""
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, name)
    if dtype.is_floating_point:
        raw = rng.integers(-8, 9, size=shape).astype(np.float32)
        raw.flat[0::17], raw.flat[1::17] = 0.0, -0.0
        raw.flat[2::97], raw.flat[3::97] = np.inf, -np.inf
        return torch.from_numpy(raw).to(dtype).cuda()
    info = torch.iinfo(dtype)
    raw = rng.integers(max(info.min, -8), min(info.max, 8) + 1, size=shape)
    raw.flat[0::31], raw.flat[1::31] = info.min, info.max
    return torch.from_numpy(raw.astype(name)).cuda()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("rows,n", [(300, 2), (40, 4096), (3, 16384)])
def test_k1_kernel_matches_plain(name, rows, n):
    x = _keys((rows, n), name, seed=n)
    idx = torch.arange(n, dtype=torch.int32, device="cuda") \
        .expand(rows, n).contiguous()
    for desc in (False, True):
        _same(bs.sort_blocks(x, descending=desc), bs.apply_network(x, desc))
        k1, v1 = bs.sort_kv_blocks(x, idx, descending=desc)
        k2, v2 = bs.apply_network_kv(x, idx, desc)
        _same(k1, k2)
        _same(v1, v2)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("rows,l", [(64, 3), (8, 4096), (1, 1 << 20)])
def test_k2_kernel_matches_plain(name, rows, l):
    raw = _keys((rows, 2, l), name, seed=l)
    pairs = keycodec.from_signed(
        torch.sort(keycodec.to_signed(raw), dim=-1).values, raw.dtype)
    a, b = pairs[:, 0, :], pairs[:, 1, :]           # strided, as the tree
    _same(mp.merge_pairs_blocks(a, b), mp.rank_merge(a, b)[0])
    va = torch.arange(l, dtype=torch.int32, device="cuda") \
        .expand(rows, l).contiguous()
    k1, v1 = mp.merge_pairs_kv_blocks(a, b, va, va + l)
    k2, v2 = mp.rank_merge(a, b, va, va + l)
    _same(k1, k2)
    _same(v1, v2)


@pytest.mark.parametrize("bits_", [8, 16, 32])
@pytest.mark.parametrize("rows,m,tile,digit_bits", [
    (3, 4096, 256, 8), (4, 3000, 1000, 4), (1, 1 << 20, 4096, 8)])
def test_k3_kernels_match_plain(bits_, rows, m, tile, digit_bits):
    rng = np.random.default_rng(bits_ + m)
    raw = rng.integers(0, 1 << bits_, size=(rows, m))
    raw[:, 1::2] = raw[:, 0::2][:, :raw[:, 1::2].shape[1]]
    keys = torch.from_numpy(raw.astype(f"uint{bits_}")
                            .view(f"int{bits_}")).cuda()
    vals = torch.arange(m, dtype=torch.int32, device="cuda") \
        .expand(rows, m).contiguous()
    pk, pv = keys, vals
    for shift in range(0, bits_, digit_bits):
        hist = rsk.digit_hist(keys, shift, digit_bits, tile)
        _same(hist, rsk.digit_hist_plain(keys, shift, digit_bits, tile))
        base = rsk.tile_bases(hist, rows)
        k1, v1 = rsk.digit_scatter(keys, vals, base, shift, digit_bits, tile)
        k2, v2 = rsk.digit_scatter_plain(keys, vals, base, shift,
                                         digit_bits, tile)
        _same(k1, k2)
        _same(v1, v2)
        pk, pv = rsk.digit_scatter_plain(
            pk, pv, rsk.tile_bases(rsk.digit_hist_plain(
                pk, shift, digit_bits, tile), rows), shift, digit_bits, tile)
    sk, sv = rsk.sort_kv_blocks(keys, vals, tile=tile, digit_bits=digit_bits)
    _same(sk, pk)
    _same(sv, pv)


def test_main_path_goes_through_the_kernels():
    import repro_torch.sort as rsort
    x = torch.randn(1 << 20, device="cuda")
    _build.reset_launches()
    out = rsort.sort(x, method="merge")
    assert _build.launches.get("bitonic_sort_blocks", 0) > 0
    assert _build.launches.get("merge_pairs_blocks", 0) > 0
    _same(out, torch.sort(x).values)
    order = rsort.argsort(x, method="radix", descending=True)
    assert torch.equal(order.long(),
                       torch.sort(x, descending=True, stable=True).indices)


@pytest.mark.parametrize("descending", [False, True])
def test_merge_runs_stay_on_the_kernels(descending):
    """A run length above K1's cap is cut to it, and a stable merge sort
    sorts its runs with K3: no run goes to ``torch.sort``."""
    import repro_torch.sort as rsort
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(0, 64, (1 << 18,), generator=g, device="cuda",
                      dtype=torch.int32)
    ref = torch.sort(x, stable=True, descending=descending)
    _build.reset_launches()
    out = rsort.sort(x, method="merge", run_len=1 << 15,
                     descending=descending)
    assert _build.launches.get("bitonic_sort_blocks", 0) > 0
    assert _build.launches.get("merge_pairs_blocks", 0) > 0
    _same(out, ref.values)
    for kw in ({"stable": True}, {"stable": True, "run_len": 1 << 15}):
        _build.reset_launches()
        order = rsort.argsort(x, method="merge", descending=descending, **kw)
        counts = dict(_build.launches)
        assert counts.get("radix_digit_scatter", 0) > 0, counts
        assert counts.get("merge_pairs_kv_blocks", 0) > 0, counts
        assert counts.get("bitonic_sort_kv_blocks", 0) == 0, counts
        assert torch.equal(order.long(), ref.indices)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        bs.sort_blocks(torch.zeros(8, 4, device="cuda").t())
    with pytest.raises(ValueError, match="int32"):
        bs.sort_kv_blocks(x, torch.zeros(4, 8, device="cuda"))
    with pytest.raises(ValueError, match="shared-memory"):
        bs.sort_blocks(torch.zeros(1, 1 << 15, device="cuda"))
    with pytest.raises(TypeError):
        bs.sort_blocks(torch.zeros(4, 8, dtype=torch.float64, device="cuda"))
