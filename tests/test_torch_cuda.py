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
from repro_torch.kernels import bitonic_topk as btk
from repro_torch.kernels import bitserial_cas as bsc
from repro_torch.kernels import merge_path as mp
from repro_torch.kernels import radix_select as sel
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


def _kth_encoded(enc, k):
    """Each row's k-th smallest descending-encoded key, as an int64 of its
    unsigned value: the threshold whose prefix every later pass uses."""
    u = enc.to(torch.int64) & ((1 << (8 * enc.element_size())) - 1)
    return torch.sort(u, dim=-1).values[:, k - 1].contiguous()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("digit_bits,tile", [(8, 4096), (4, 1000)])
def test_k4_kernel_matches_plain(name, digit_bits, tile):
    """Every pass of the refinement, the first (all active) and the later
    ones under a threshold prefix, on source keys (encoded in registers)
    and on encoded keys, with a ragged tail of the last tile."""
    x = _keys((3, 5001), name, seed=digit_bits)
    enc = keycodec.encode(x, descending=True)
    bits = 8 * x.element_size()
    for thresh in (torch.zeros(3, dtype=torch.int64, device="cuda"),
                   _kth_encoded(enc, 2500)):
        for shift in range(bits - digit_bits, -1, -digit_bits):
            for keys, encode in ((x, True), (enc, False)):
                _same(sel.digit_hist(keys, thresh, shift, digit_bits, tile,
                                     encode=encode),
                      sel.digit_hist_plain(keys, thresh, shift, digit_bits,
                                           tile, encode=encode))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n", [8, 64, 2048, 16384])
def test_k5_kernel_matches_plain(name, n):
    """Rows of ties, signed zeros and extremes, one row all at the
    sentinel (-inf, the integer minimum)."""
    x = _keys((37, n), name, seed=n)
    dtype = getattr(torch, name)
    x[1] = float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min
    for k in (1, 8, 50, n):
        if k <= n:
            v1, i1 = btk.topk_blocks(x, k)
            v2, i2 = btk.topk_plain(x, k)
            _same(v1, v2)
            _same(i1, i2)


_NOT_ON_THE_CARD = ("sort", "argsort", "topk", "kthvalue", "msort")


@pytest.mark.parametrize("method", ["select", "cuda"])
@pytest.mark.parametrize("rows,n,k", [(2, 1 << 20, 64), (3, 128256, 50),
                                      (4096, 64, 8), (1, 1 << 17, 20000)])
def test_topk_on_the_card_runs_kernels_only(method, rows, n, k,
                                            monkeypatch):
    """``select`` and ``cuda`` top-k launch K4 or K5, order their
    candidates with K1 (K1 runs and K2 merges past its cap) and call no
    PyTorch sort or top-k.  Rows with a -inf tail and signed zeros hold
    the reference's indices: the stable descending sort on the IEEE total
    order for ``select``, on the numeric order for ``cuda``."""
    import repro_torch.sort as rsort
    g = torch.Generator(device="cuda").manual_seed(n + k)
    x = torch.randn((rows, n), generator=g, device="cuda")
    x[:, n // 2:] = x[:, n // 2:].round()          # ties and signed zeros
    x[0, -(n // 3):] = float("-inf")
    key = keycodec.total_order_key(x) if method == "select" else x
    ref = torch.sort(key, dim=-1, stable=True, descending=True).indices[:, :k]
    for name in _NOT_ON_THE_CARD:
        monkeypatch.setattr(torch, name, _refuse_library_call(name))
    _build.reset_launches()
    v, i = rsort.topk(x, k, method=method)
    counts = dict(_build.launches)
    monkeypatch.undo()
    first = "select_digit_hist" if method == "select" \
        else "bitonic_topk_blocks"
    assert counts.get(first, 0) > 0, counts
    if method == "select" or n > 2048:
        key_value = ("bitonic_sort_kv_blocks",)
        if k > bs.MAX_N or (method == "cuda" and n // 2048 * min(k, 2048)
                            > bs.MAX_N):
            key_value += ("merge_pairs_kv_blocks",)
        assert all(counts.get(c, 0) > 0 for c in key_value), counts
    assert torch.equal(i.long(), ref)
    _same(v, x.gather(-1, ref))


def _refuse_library_call(name):
    def refuse(*a, **kw):
        raise AssertionError(f"torch.{name} called on the card's path")
    return refuse


def test_ragged_and_padded_sorts_on_the_card_match_the_cpu():
    import repro_torch.sort as rsort
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(1 << 18, generator=g, device="cuda")
    seg = torch.randint(0, 100, (1 << 18,), generator=g, device="cuda",
                        dtype=torch.int32)
    for got, want in zip(rsort.segment_sort(x, segment_ids=seg),
                         rsort.segment_sort(x.cpu(), segment_ids=seg.cpu(),
                                            device="cpu")):
        _same(got.cpu(), want)
    b = torch.randn((64, 4000), generator=g, device="cuda")
    lengths = torch.randint(0, 4001, (64,), generator=g, device="cuda")
    _same(rsort.sort(b, valid_lengths=lengths, fill_value=-1.0).cpu(),
          rsort.sort(b.cpu(), valid_lengths=lengths.cpu(), fill_value=-1.0,
                     device="cpu"))


@pytest.mark.parametrize("descending", [False, True])
def test_sort_kv_on_the_card_keeps_payloads_past_n(descending):
    """int32 payloads above n on keys equal to the runs' pad key survive
    the card's merge path (they ride as positions), ties in index order."""
    import repro_torch.sort as rsort
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1 << 16, generator=g, device="cuda")
    x[-100:] = float("-inf") if descending else float("inf")
    v = torch.randint(1 << 20, 1 << 30, (1 << 16,), generator=g,
                      device="cuda", dtype=torch.int32)
    sk, sv = rsort.sort_kv(x, v, method="merge", descending=descending)
    order = torch.sort(x, stable=True, descending=descending).indices
    _same(sk, x[order])
    _same(sv, v[order])


# ---------------------------------------------------------------------------
# K7 and the imc path
# ---------------------------------------------------------------------------

def _cas_words(n, width, seed):
    """int32 carriers of W-bit words: random, 0, 2^W - 1, the top bit
    (bit 31 at W = 32) and equal operand pairs."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << width, size=(2, n), dtype=np.uint64)
    w[0, 1::13], w[1, 2::13] = 0, (1 << width) - 1
    w[:, 3::13] |= 1 << (width - 1)
    w[1, ::5] = w[0, ::5]
    a, b = (torch.from_numpy(r.astype(np.uint32).view(np.int32)).cuda()
            for r in w)
    return a, b


@pytest.mark.parametrize("width", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 1 << 20])
def test_k7_kernel_matches_plain(width, n):
    """One K7 launch against the plain gate program on the same words,
    lengths that are not a multiple of the 128 lanes included."""
    from repro_torch.kernels import ops
    a, b = _cas_words(n, width, seed=width * 7 + n)
    _build.reset_launches()
    lo, hi = ops.bitserial_cas(a, b, width=width)
    assert dict(_build.launches) == {"bitserial_cas": 1}
    plo, phi = bsc.exec_program_plain(a, b, width)
    _same(lo, plo)
    _same(hi, phi)
    ua, ub = (t.to(torch.int64) & 0xFFFFFFFF for t in (a, b))
    assert torch.equal(lo.to(torch.int64) & 0xFFFFFFFF, torch.minimum(ua, ub))
    assert torch.equal(hi.to(torch.int64) & 0xFFFFFFFF, torch.maximum(ua, ub))


IMC_DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32"]


@pytest.mark.parametrize("name", IMC_DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_imc_on_the_card_matches_the_cpu(name, descending):
    """The card's imc sort and argsort (K7 per stage) give the CPU
    simulator's bits; 32-bit keys have no argsort composite."""
    import repro_torch.sort as rsort
    x = _keys((16, 256), name, seed=len(name))
    _same(rsort.sort(x, method="imc", descending=descending).cpu(),
          rsort.sort(x.cpu(), method="imc", descending=descending,
                     device="cpu"))
    if x.element_size() <= 2:
        _same(rsort.argsort(x, method="imc", descending=descending).cpu(),
              rsort.argsort(x.cpu(), method="imc", descending=descending,
                            device="cpu"))


def test_imc_launches_one_k7_per_stage(monkeypatch):
    """Every compare-and-swap stage of the network on the card is one K7
    launch, and no PyTorch sort runs: the paper's unit (N=8, W=4: 6
    stages, 192 cycles) and the front door at n=64 (21 stages)."""
    import repro_torch.sort as rsort
    from repro_torch.core import sorter
    g = torch.Generator(device="cuda").manual_seed(7)
    unit = torch.randint(0, 16, (4096, 8), generator=g, device="cuda",
                         dtype=torch.int32)
    x = torch.randint(-128, 128, (512, 64), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    for name in _NOT_ON_THE_CARD:
        monkeypatch.setattr(torch, name, _refuse_library_call(name))
    _build.reset_launches()
    res = sorter.sort_in_memory(unit, width=4)
    unit_counts = dict(_build.launches)
    _build.reset_launches()
    out = rsort.sort(x, method="imc")
    sort_counts = dict(_build.launches)
    _build.reset_launches()
    order = rsort.argsort(x, method="imc", descending=True)
    arg_counts = dict(_build.launches)
    monkeypatch.undo()
    assert unit_counts == {"bitserial_cas": 6}
    assert (res.cycles, res.compute_cycles, res.movement_cycles) == \
        (192, 168, 24)
    assert sort_counts == arg_counts == {"bitserial_cas": 21}
    _same(res.values, torch.sort(unit, dim=-1).values)
    _same(out, torch.sort(x, dim=-1).values)
    want = torch.sort(x, dim=-1, stable=True, descending=True).indices
    assert torch.equal(order.long(), want)
