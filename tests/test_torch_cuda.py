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

from _bucket_cases import CASES, bucket_case

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


def _offset_by_one(t):
    """``t`` copied to one element past a 16-byte boundary (through its
    bits: no dtype loses ``cat`` that way)."""
    tb = _bits(t)
    return torch.cat([tb.new_zeros(1), tb.reshape(-1)])[1:] \
        .view(t.dtype).view(t.shape)


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


@pytest.mark.parametrize("name", ["float32", "int32"])
@pytest.mark.parametrize("n", [1 << p for p in range(1, 15)])
def test_k1_every_row_length_matches_plain(name, n):
    """Every power of two K1 takes, key-only and key-value, both ways;
    a row count that leaves the last CTA part empty (a CTA owns at least
    2048 keys), ±0.0 and ±inf among the keys; then the same rows at an
    offset off the 16-byte vectors (the kernel's scalar path)."""
    rows = max(1, 2048 // n) + 3
    x = _keys((rows, n), name, seed=n + 1)
    idx = torch.arange(n, dtype=torch.int32, device="cuda") \
        .expand(rows, n).contiguous()
    for desc in (False, True):
        _same(bs.sort_blocks(x, descending=desc), bs.apply_network(x, desc))
        k1, v1 = bs.sort_kv_blocks(x, idx, descending=desc)
        k2, v2 = bs.apply_network_kv(x, idx, desc)
        _same(k1, k2)
        _same(v1, v2)
    flat = torch.cat([x.new_zeros(1), x.view(-1)])[1:].view(rows, n)
    assert flat.data_ptr() % 16
    _same(bs.sort_blocks(flat), bs.apply_network(flat, False))


def _sorted_pairs(raw, descending):
    """(rows, 2, L) -> each run sorted in the merge's direction."""
    s = torch.sort(keycodec.to_signed(raw), dim=-1,
                   descending=descending).values
    return keycodec.from_signed(s.contiguous(), raw.dtype)


def _k2_matches_plain(a, b, descending):
    """Both K2 entries, and the partition, against their plain versions."""
    rows, l = a.shape
    _same(mp.merge_path_partition(a, b, descending=descending),
          mp.partition_plain(a, b, descending=descending))
    _same(mp.merge_pairs_blocks(a, b, descending=descending),
          mp.rank_merge(a, b, descending=descending)[0])
    va = torch.arange(l, dtype=torch.int32, device="cuda") \
        .expand(rows, l).contiguous()
    k1, v1 = mp.merge_pairs_kv_blocks(a, b, va, va + l,
                                      descending=descending)
    k2, v2 = mp.rank_merge(a, b, va, va + l, descending=descending)
    _same(k1, k2)
    _same(v1, v2)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("rows,l", [(64, 3), (8, 4096), (3, 5001),
                                    (1, 1 << 20)])
def test_k2_kernel_matches_plain(name, rows, l, descending):
    """Heavy ties, ±0.0 and the extremes, the strided pair views the merge
    tree hands the kernel; then the same runs at an offset of one element
    (rows off the 16-byte chunks: the kernel's element head and tail)."""
    pairs = _sorted_pairs(_keys((rows, 2, l), name, seed=l), descending)
    _k2_matches_plain(pairs[:, 0, :], pairs[:, 1, :], descending)
    off = _offset_by_one(pairs)
    assert off.data_ptr() % 16
    _k2_matches_plain(off[:, 0, :], off[:, 1, :], descending)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["float32", "int32", "int8"])
def test_k2_tie_runs_across_tile_cuts(name, descending):
    """The middle half of both runs is one key, so several of the kernel's
    tile boundaries fall inside a run of equal keys that both runs feed."""
    rows, l = 3, 3 * mp.KERNEL_TILE + 5
    raw = _keys((rows, 2, l), name, seed=7)
    raw[:, :, l // 4: 3 * l // 4] = 3
    pairs = _sorted_pairs(raw, descending)
    a, b = pairs[:, 0, :], pairs[:, 1, :]
    _k2_matches_plain(a, b, descending)
    out = mp.merge_pairs_blocks(a, b, descending=descending)
    d = torch.arange(1, mp.tiles_per_row(l), device="cuda") * mp.KERNEL_TILE
    inside = (out[:, d - 1] == 3) & (out[:, d] == 3)
    assert (inside.sum(-1) >= 2).all()


@pytest.mark.parametrize("kv", [False, True])
def test_descending_merge_tree_flips_nothing_on_the_card(kv):
    """A descending merge tree on the ``cuda`` backend is K2 with its
    descending comparator: no ``aten::flip`` in a profile of the call, and
    the result is the plain (flip construction) tree's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import merge as emerge
    raw = _keys((2, 8, 1024), "int32", seed=3)
    runs = _sorted_pairs(raw.view(16, 1, 1024), True).view(2, 8, 1024)
    vals = torch.arange(runs.numel(), dtype=torch.int32,
                        device="cuda").view(runs.shape)

    def tree(backend):
        if kv:
            return emerge.merge_runs(runs, vals, descending=True,
                                     backend=backend)
        return (emerge.merge_runs(runs, descending=True, backend=backend),)

    tree("cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = tree("cuda")
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "flip" in n], names
    name = "merge_pairs_kv_blocks" if kv else "merge_pairs_blocks"
    assert _build.launches == {name: 3, "merge_path_partition": 3}
    for g, w in zip(got, tree("torch")):
        _same(g, w)


@pytest.mark.parametrize("bits_", [8, 16, 32])
@pytest.mark.parametrize("rows,m,digit_bits", [
    (3, 4096, 8), (4, 3000, 4), (1, 1 << 20, 8)])
def test_k3_kernels_match_plain(bits_, rows, m, digit_bits):
    """The onesweep histogram and every pass against their plain versions
    on the same inputs, then the whole sort (one look-back scratch for
    all its passes) against the plain pass loop; bit for bit."""
    rng = np.random.default_rng(bits_ + m)
    raw = rng.integers(0, 1 << bits_, size=(rows, m))
    raw[:, 1::2] = raw[:, 0::2][:, :raw[:, 1::2].shape[1]]
    keys = torch.from_numpy(raw.astype(f"uint{bits_}")
                            .view(f"int{bits_}")).cuda()
    vals = torch.arange(m, dtype=torch.int32, device="cuda") \
        .expand(rows, m).contiguous()
    hist = rsk.onesweep_hist(keys, digit_bits)
    _same(hist, rsk.onesweep_hist_plain(keys, digit_bits))
    k1, v1 = keys, vals
    for shift in range(0, bits_, digit_bits):
        k2, v2 = rsk.onesweep_pass_plain(k1, v1, hist, shift, digit_bits)
        k1, v1 = rsk.onesweep_pass(k1, v1, hist, shift, digit_bits)
        _same(k1, k2)
        _same(v1, v2)
    sk, sv = rsk.sort_kv_blocks(keys, vals, digit_bits=digit_bits)
    pk, pv = rsk.onesweep_sort_kv_plain(keys, vals, digit_bits)
    _same(sk, pk)
    _same(sv, pv)
    _same(rsk.sort_blocks(keys, digit_bits=digit_bits), pk)


def test_k3_pass_on_a_used_scratch_fails_loudly():
    """A look-back scratch serves one sort: a pass handed one whose tile
    counter has run traps, and the process sees a CUDA error instead of
    unwritten output.  Run in a child process (a trap ends its context)."""
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from repro_torch.kernels import radix_sort as rsk\n"
        "keys = torch.randint(0, 1 << 30, (2, 9000), device='cuda',\n"
        "                     dtype=torch.int32)\n"
        "hist = rsk.onesweep_hist(keys, 8)\n"
        "scratch = rsk._scratch(keys, 8)\n"
        "first = rsk._pass(keys, None, hist, 0, 8, scratch)[0]\n"
        "torch.cuda.synchronize()\n"
        "again = rsk._pass(keys, None, hist, 0, 8, scratch)[0]\n"
        "torch.cuda.synchronize()\n"
        "print('no error', torch.equal(first, again))\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout
    assert "no error" not in r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("name,digit_bits", [("int8", 8), ("int16", 4),
                                             ("int32", 8), ("int32", 1)])
def test_k3_sort_is_one_hist_and_a_pass_a_digit(name, digit_bits):
    """A card sort is 1 + P launches: the histogram of every pass, then P
    passes; none of the tiled kernels' names."""
    x = torch.randint(-100, 100, (5, 9000), device="cuda",
                      dtype=torch.int64).to(getattr(torch, name))
    _build.reset_launches()
    out = rsk.sort_blocks(x, digit_bits=digit_bits)
    passes = x.element_size() * 8 // digit_bits
    assert dict(_build.launches) == {"radix_onesweep_hist": 1,
                                     "radix_onesweep_pass": passes}
    u = x.to(torch.int64) & ((1 << 8 * x.element_size()) - 1)
    assert torch.equal(out.to(torch.int64) & ((1 << 8 * x.element_size())
                                              - 1),
                       torch.sort(u, dim=-1).values)


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
        assert counts.get("radix_onesweep_pass", 0) > 0, counts
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


def _k4_rows(name, rows, n, seed):
    """Heavy ties and extremes; row 0 all one key, row 1 a few distinct
    top digits (a normal row's first pass for floats, three extremes for
    integers), the rest mixed.  Written through the keys' bits, which
    every dtype takes on the card."""
    x = _keys((rows, n), name, seed=seed)
    xb = _bits(x)
    xb[0] = xb[0, 0]
    if rows > 1:
        g = torch.Generator(device="cuda").manual_seed(seed)
        if x.dtype.is_floating_point:
            xb[1] = _bits(torch.randn(n, generator=g, device="cuda")
                          .to(x.dtype))
        else:
            info = torch.iinfo(xb.dtype)
            pick = torch.randint(0, 3, (n,), generator=g, device="cuda")
            xb[1] = torch.tensor([info.min, 0, info.max], device="cuda",
                                 dtype=xb.dtype)[pick]
    return x


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("rows,n,digit_bits,tile", [
    (3, 5001, 8, 4096), (3, 5001, 4, 1000), (64, 128256, 8, 4096),
    (2, 1 << 20, 8, 4096)])
def test_k4_kernel_matches_plain(name, rows, n, digit_bits, tile):
    """Every pass of the refinement, the first (all active) and the later
    ones under a threshold prefix, on source keys (encoded in registers)
    and on encoded keys: an all-equal row, a skewed row, ragged rows
    (head and tail off the 16-byte vectors), the sampling rows' (64,
    128256); then the same rows at an offset of one element; and passes
    counted into one zeroed buffer."""
    x = _k4_rows(name, rows, n, seed=digit_bits + n)
    flat = _offset_by_one(x)
    assert flat.data_ptr() % 16
    bits = 8 * x.element_size()
    shifts = range(bits - digit_bits, -1, -digit_bits)
    for xs in (x, flat):
        enc = keycodec.encode(xs, descending=True)
        for thresh in (torch.zeros(rows, dtype=torch.int64, device="cuda"),
                       _kth_encoded(enc, n // 2)):
            for keys, encode in ((xs, True), (enc, False)):
                hists = torch.zeros((len(shifts), rows, 1 << digit_bits),
                                    dtype=torch.int32, device="cuda")
                for p, shift in enumerate(shifts):
                    want = sel.digit_hist_plain(keys, thresh, shift,
                                                digit_bits, tile,
                                                encode=encode)
                    _same(sel.digit_hist(keys, thresh, shift, digit_bits,
                                         tile, encode=encode), want)
                    sel.digit_hist(keys, thresh, shift, digit_bits, tile,
                                   encode=encode, out=hists[p])
                    _same(hists[p], want)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n", [8, 64, 2048, 16384])
def test_k5_kernel_matches_plain(name, n):
    """Rows of ties, signed zeros and extremes, one row all at the
    sentinel (-inf, the integer minimum): the one-pass kernels (k <= 256)
    and the network kernel (power-of-two rows, any k)."""
    x = _keys((37, n), name, seed=n)
    dtype = getattr(torch, name)
    x[1] = float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min
    for k in (1, 8, 50, 256, n):
        if k <= n:
            v1, i1 = btk.topk_blocks(x, k)
            v2, i2 = btk.topk_plain(x, k)
            _same(v1, v2)
            _same(i1, i2)
        if k <= min(n, btk.MAX_K):
            v1, i1 = btk.topk_rows(x, k)
            v2, i2 = btk.topk_rows_plain(x, k)
            _same(v1, v2)
            _same(i1, i2)


def _numeric_topk(x, k):
    """The stable descending sort of the numeric keys, first k: the
    function's definition (-0.0 == +0.0, the lower index first)."""
    order = torch.sort(x, dim=-1, stable=True, descending=True).indices
    order = order[:, :k]
    return x.gather(-1, order), order.to(torch.int32)


@pytest.mark.parametrize("case", ["router", "vocab", "vocab_masked",
                                  "vocab_ascending", "sampling", "long_row",
                                  "long_row_ascending", "rows_2048"])
def test_k5_rows_kernel_matches_plain_and_sort(case):
    """The one-pass kernels at the main path's shapes against their plain
    version and the stable descending numeric sort: router rows (16384,
    64) k = 8; vocabulary rows (64, 128256) k = 50, also -inf masked with
    row 0 down to 10 finite lanes, and ascending; the serve's sampling rows
    (8, 256000) k = 50; one row of 2^24 k = 64, also ascending."""
    g = torch.Generator(device="cuda").manual_seed(len(case))
    shape, k = {"router": ((16384, 64), 8), "vocab": ((64, 128256), 50),
                "vocab_masked": ((64, 128256), 50),
                "vocab_ascending": ((64, 128256), 50),
                "sampling": ((8, 256000), 50), "long_row": ((1, 1 << 24), 64),
                "long_row_ascending": ((1, 1 << 24), 64),
                "rows_2048": ((4096, 2048), 50)}[case]
    x = torch.randn(shape, generator=g, device="cuda")
    if case == "vocab_masked":
        x[:, -128:] = float("-inf")
        x[0, 10:] = float("-inf")
    if case.endswith("ascending"):
        x = torch.arange(shape[1], dtype=torch.float32, device="cuda") \
            .expand(shape).contiguous()
    v, i = btk.topk_rows(x, k)
    pv, pi = btk.topk_rows_plain(x, k)
    _same(v, pv)
    _same(i, pi)
    ov, oi = _numeric_topk(x, k)
    _same(v, ov)
    _same(i, oi)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("plan", [
    None, btk.RowPlan("short", lanes=32), btk.RowPlan("stream"),
    btk.RowPlan("stream", warps_per_row=8, ctas=1, stripe=40),
    btk.RowPlan("stream", warps_per_row=8, ctas=6, stripe=7),
    btk.RowPlan("stream", warps_per_row=8, ctas=40, stripe=1)])
def test_k5_rows_every_dtype_and_cut(name, plan):
    """Ties across every lane, stripe and CTA boundary (keys in [-8, 8],
    +-0.0, extremes), rows of 300 and a copy one element off a 16-byte
    boundary (scalar heads and tails), k = 16, against the plain version
    cut the same way."""
    x = _keys((5, 300), name, seed=7)
    for t in (x, _offset_by_one(x)):
        v, i = btk.topk_rows(t, 16, plan)
        pv, pi = btk.topk_rows_plain(t, 16, plan)
        _same(v, pv)
        _same(i, pi)


def test_k5_merge_scratch_is_overwritten_whole():
    """The stream kernel writes every slot of the partial runs the merge
    launch reads, so a scratch full of the largest composite -- a reused
    or stale buffer -- changes nothing; there is no counter to reset."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((3, 200000), generator=g, device="cuda")
    k = 40
    p = btk.plan(*x.shape, k)
    assert p.ctas > 1
    part = torch.full((3, p.ctas, btk.run_len(k)), -1, dtype=torch.int64,
                      device="cuda")
    v = torch.empty((3, k), device="cuda")
    i = torch.empty((3, k), dtype=torch.int32, device="cuda")
    for _ in range(2):
        lib, P = btk._lib(), _build.ptr
        st = _build.stream_of(x)
        assert lib.topk_rows_stream(0, P(x), P(v), P(i), P(part), 3,
                                    x.shape[1], k, p.stripe, p.warps_per_row,
                                    p.ctas, st) == 0
        assert lib.topk_rows_merge(0, P(part), P(v), P(i), 3, p.ctas,
                                   min(p.ctas, btk.MERGE_WARPS), k, st) == 0
        torch.cuda.synchronize()
        ov, oi = _numeric_topk(x, k)
        _same(v, ov)
        _same(i, oi)


_NOT_ON_THE_CARD = ("sort", "argsort", "topk", "kthvalue", "msort")


@pytest.mark.parametrize("method", ["select", "cuda"])
@pytest.mark.parametrize("rows,n,k", [(2, 1 << 20, 64), (3, 128256, 50),
                                      (4096, 64, 8), (1, 1 << 17, 20000)])
def test_topk_on_the_card_runs_kernels_only(method, rows, n, k,
                                            monkeypatch):
    """``select`` top-k launches K4 and orders its candidates with K1 (K1
    runs and K2 merges past its cap); ``cuda`` top-k at k <= 256 launches
    only K5's one-pass kernels, at most two, and above that K5's network
    per chunk and K1 (and K2) over the candidates; neither calls a PyTorch
    sort or top-k.  Rows with a -inf tail and signed zeros hold the
    reference's indices: the stable descending sort on the IEEE total
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
    if method == "cuda" and k <= btk.MAX_K:
        one_pass = {"topk_rows_short", "topk_rows_stream", "topk_rows_merge"}
        assert set(counts) <= one_pass and 1 <= sum(counts.values()) <= 2, \
            counts
    else:
        first = "select_digit_hist" if method == "select" \
            else "bitonic_topk_blocks"
        assert counts.get(first, 0) > 0, counts
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
    lengths that are not a multiple of 4 (the kernel's 16-byte vectors)
    included."""
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


@pytest.mark.parametrize("width", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("batch,n", [(300, 2), (64, 8), (16, 256),
                                     (2, 1 << 14)])
def test_k7_stage_kernel_matches_plain(width, batch, n):
    """Every stage of the network, one launch of the stage kernel each, in
    place, against ``stage_plain`` on the same words; the rows end sorted
    and the caller's words of ``sort_in_memory`` stay as they were."""
    from repro_torch.core import network, sorter
    a, b = _cas_words(batch * n // 2, width, seed=width + n)
    v = torch.cat([a, b]).view(batch, n).contiguous()
    words = v.clone()
    for k, j in network.stage_schedule(n):
        want = bsc.stage_plain(v, k, j, width)
        _build.reset_launches()
        assert bsc.cas_stages(v, [(k, j)], width) is v
        assert dict(_build.launches) == {"bitserial_cas_stage": 1}
        _same(v, want)
    u = words.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(v.to(torch.int64) & 0xFFFFFFFF,
                       torch.sort(u, dim=-1).values)
    res = sorter.sort_in_memory(words, width=width)
    _same(res.values, v)
    assert torch.equal(words, torch.cat([a, b]).view(batch, n))


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
    assert unit_counts == {"bitserial_cas_stage": 6}
    assert (res.cycles, res.compute_cycles, res.movement_cycles) == \
        (192, 168, 24)
    assert sort_counts == arg_counts == {"bitserial_cas_stage": 21}
    _same(res.values, torch.sort(unit, dim=-1).values)
    _same(out, torch.sort(x, dim=-1).values)
    want = torch.sort(x, dim=-1, stable=True, descending=True).indices
    assert torch.equal(order.long(), want)


# ---------------------------------------------------------------------------
# K6 and the serving path
# ---------------------------------------------------------------------------

# max |kernel - plain| by input dtype: float32 FMA in either order; bf16 /
# fp16 round P to the input type for the tensor-core product
K6_ATOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
# ... and the largest |kernel - plain|_2 / |plain|_2 over query rows, which
# holds small outputs (long rows) to their own size: rounding P and the
# output costs ~2^-8 in bf16 and ~2^-11 in fp16
K6_ROW_REL = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -6,
              "float16": 2.0 ** -9}


def _row_rel_err(got, want):
    want = want.float()
    return ((got.float() - want).norm(dim=-1)
            / want.norm(dim=-1).clamp(min=1e-30)).max().item()


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("g,s,t,q_offset,causal,window", [
    (1, 64, 64, 0, True, 0),
    (3, 100, 100, 0, True, 0),        # S not a multiple of the block
    (1, 200, 200, 0, True, 24),       # windowed
    (3, 130, 130, 0, False, 0),
    (3, 70, 200, 130, True, 0),       # absolute positions from q_offset
    (1, 96, 160, 64, True, 40),
    # where 64-key tiles (H = 192 / 256) differ from 128-key ones: lengths
    # one past a tile, a slot and short of the next (129: a slot's second
    # tile wholly past T, not walked)
    (1, 65, 65, 0, True, 0),
    (3, 129, 129, 0, True, 0),
    (1, 191, 191, 0, True, 0),
    (3, 100, 300, 40, True, 0),       # a q_offset off the 64-key tiles
    (1, 300, 300, 0, True, 100),      # a window edge inside a 64-key tile
    (12, 130, 130, 0, True, 0),       # nemotron-4-340b's grouping
    # queries that see no key: they average the visited slots, T past a
    # slot's first tile (200) and inside it (150: its second tile is not
    # walked)
    (1, 70, 200, 400, True, 100),
    (1, 70, 150, 400, True, 100),
])
def test_k6_kernel_matches_plain(name, h, g, s, t, q_offset, causal,
                                 window):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(s + t + h)
    dtype = getattr(torch, name)
    q = torch.randn((2 * 2 * g, s, h), generator=gen, device="cuda") \
        .to(dtype)
    k = torch.randn((2 * 2, t, h), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2 * 2, t, h), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    got = fa.flash_rows(q, k, v, q_offset, causal=causal, window=window)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_fwd": 1}
    want = fa.flash_rows_plain(q, k, v, q_offset, causal=causal,
                               window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K6_ATOL[name], err
    rel = _row_rel_err(got, want)
    assert rel <= K6_ROW_REL[name], rel


def test_k6_rows_that_see_no_key_match_plain():
    """The -1e30 arithmetic on the card: a window that holds no key of
    the tiles visited gives the plain version's average, not NaN."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((2, 64, 32), generator=gen, device="cuda")
    k = torch.randn((1, 100, 32), generator=gen, device="cuda")
    v = torch.randn((1, 100, 32), generator=gen, device="cuda")
    got = fa.flash_rows(q, k, v, 300, causal=True, window=8)
    want = fa.flash_rows_plain(q, k, v, 300, causal=True, window=8)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,r,h,s,t,q_offset,window", [
    (24, 8, 128, 1024, 1024, 0, 0),     # the serve's heads at S = 1024
    (24, 8, 128, 2048, 2048, 0, 0),     # ... and 2048
    (6, 2, 128, 1000, 1000, 0, 0),      # S = T off the 128-key tiles
    (6, 2, 64, 333, 333, 0, 0),
    (6, 2, 128, 200, 460, 260, 0),      # an offset across a tile edge
    (6, 2, 64, 300, 300, 0, 200),       # a window edge inside tiles
    (3, 1, 128, 257, 600, 300, 130),    # both, S one past two blocks
])
def test_k6_wgmma_kernel_matches_plain(name, n, r, h, s, t, q_offset,
                                       window):
    """The warp-specialised TMA + wgmma kernel (bf16 / fp16, H = 64 and
    128) against its plain version: one launch, within the limits."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(s + t + h + n)
    dtype = getattr(torch, name)
    q = torch.randn((n, s, h), generator=gen, device="cuda").to(dtype)
    k = torch.randn((r, t, h), generator=gen, device="cuda").to(dtype)
    v = torch.randn((r, t, h), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    got = fa.flash_rows(q, k, v, q_offset, causal=True, window=window)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_fwd": 1}
    want = fa.flash_rows_plain(q, k, v, q_offset, causal=True,
                               window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K6_ATOL[name], err
    rel = _row_rel_err(got, want)
    assert rel <= K6_ROW_REL[name], rel


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
@pytest.mark.parametrize("h", [16, 32])
@pytest.mark.parametrize("n,r,s,t,q_offset,window", [
    (8, 8, 1024, 1024, 0, 0),           # the kernel-table row's shape
    (6, 2, 257, 257, 0, 0),             # one past a 256-key tile
    (6, 2, 383, 383, 0, 0),             # a tile's upper slot not visited
    (6, 2, 511, 511, 0, 0),             # ... and visited, one short
    (6, 2, 200, 700, 500, 0),           # T > S from a q_offset
    (6, 2, 300, 300, 0, 200),           # a window across a tile edge
    (3, 1, 130, 900, 650, 100),         # a window and an offset
    (2, 1, 70, 300, 400, 100),          # no key seen: 3 slots, 2 tiles
    (2, 1, 150, 200, 300, 8),           # no key seen: 2 slots, 1 tile
])
def test_k6_narrow_heads_on_wgmma_match_plain(name, h, n, r, s, t, q_offset,
                                              window):
    """K6 at H = 16 and 32 on the TMA + wgmma kernel (32- / 64-byte
    swizzle, 256-key tiles whose upper slot past the visited ones takes
    no exp2): lengths off the tiles, T > S with an offset, windows across
    a tile edge and queries that see no key (they average exactly the
    reference's visited 128-key slots), one launch, within the limits."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(s + t + h + n)
    dtype = getattr(torch, name)
    q = torch.randn((n, s, h), generator=gen, device="cuda").to(dtype)
    k = torch.randn((r, t, h), generator=gen, device="cuda").to(dtype)
    v = torch.randn((r, t, h), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    got = fa.flash_rows(q, k, v, q_offset, causal=True, window=window)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_fwd": 1}
    want = fa.flash_rows_plain(q, k, v, q_offset, causal=True,
                               window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K6_ATOL[name], err
    rel = _row_rel_err(got, want)
    assert rel <= K6_ROW_REL[name], rel


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
@pytest.mark.parametrize("h", [16, 32, 64, 128])
def test_k6_wgmma_rows_that_see_no_key_match_plain(name, h):
    """The -1e30 arithmetic on the wgmma kernel: queries whose window holds
    no key average the values of the 128-key tiles they visit."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(h)
    dtype = getattr(torch, name)
    q = torch.randn((2, 150, h), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, 200, h), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, 200, h), generator=gen, device="cuda").to(dtype)
    got = fa.flash_rows(q, k, v, 300, causal=True, window=8)
    want = fa.flash_rows_plain(q, k, v, 300, causal=True, window=8)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= K6_ATOL[name]


def test_k6_wrapper_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros(2, 64, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_rows(x, x[:1], x[:1])
    x = torch.zeros(2, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_rows(x.transpose(0, 1), x[:1], x[:1])
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_rows(x.requires_grad_(), x.detach(), x.detach())


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_model_prefill_on_the_card_flash_on_vs_off(name):
    """Two layers of minitron-4b's widths (d=3072, 24/8 heads of 128):
    the prefill's logits and caches with K6 against the einsum path, and
    one K6 launch a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(get_config("minitron-4b"), n_layers=2,
                              vocab_size=4096, dtype=name)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 4096, (2, 300), generator=gen, device="cuda",
                           dtype=torch.int32)
    out = {}
    for flash in (False, True):
        m = model_zoo.build(dataclasses.replace(cfg, flash_prefill=flash))
        _build.reset_launches()
        out[flash] = m.prefill(params, {"tokens": tokens}, max_len=512)
        torch.cuda.synchronize()
        assert _build.launches.get("flash_attention_fwd", 0) == \
            (2 if flash else 0)
    (l0, s0), (l1, s1) = out[False], out[True]
    tol = 1e-3 if name == "float32" else 0.25
    assert (l0 - l1).abs().max().item() <= tol
    for a, b in ((s0["body"].k, s1["body"].k), (s0["body"].v, s1["body"].v)):
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("arch,layers", [("gemma-2b", 2),
                                         ("recurrentgemma-2b", 3),
                                         ("nemotron-4-340b", 1)])
def test_wide_head_prefill_on_the_card_flash_on_vs_off(arch, layers):
    """K6 at head dims 256 (gemma-2b's MQA, recurrentgemma's windowed
    layers) and 192 (nemotron-4-340b) inside a bf16 model of the full
    widths, cut in depth: one launch an attention layer, the logits within
    the serve phase's 0.2 of the einsum path's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              vocab_size=4096)
    params = model_zoo.build(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, 4096, (2, 2304), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), dtype=torch.int32)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(layers))
    out = {}
    for flash in (False, True):
        m = model_zoo.build(dataclasses.replace(cfg, flash_prefill=flash))
        _build.reset_launches()
        out[flash] = m.prefill(params, {"tokens": tokens}, max_len=2304)[0]
        torch.cuda.synchronize()
        assert _build.launches.get("flash_attention_fwd", 0) == \
            (n_attn if flash else 0)
    assert (out[False] - out[True]).abs().max().item() <= 0.2


# ---------------------------------------------------------------------------
# the relational ops on the card: auto against method="torch"
# ---------------------------------------------------------------------------

REL_N = 1 << 20
K3 = ("radix_onesweep_hist", "radix_onesweep_pass")


def _planned_kernels(op, n, dtype):
    """The kernels the card's plan for a sort-backed op must launch."""
    from repro_torch.engine import planner
    stable = op in ("group_by", "join")
    method = planner.choose_relational(op, n, dtype=dtype,
                                       device="cuda").method
    if method == "radix" or (stable and method != "torch"):
        # a stable merge sorts its runs on K3 too, and merges them on K2
        return K3 + (("merge_path_partition",) if method != "radix" else ())
    return {"torch": (), "cuda": ("bitonic_sort_kv_blocks",),
            "merge": ("bitonic_sort_blocks", "merge_path_partition"),
            "bitonic": ()}[method]


def _launched(fn):
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launches)


def _same_tree(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same_tree(x, y)
        elif x is not None:
            _same(x, y)


def _rel_cols(seed):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.integers(0, REL_N // 4, REL_N)
                         .astype(np.int32)).cuda()
    q = torch.from_numpy(rng.integers(1, 51, REL_N).astype(np.int32)).cuda()
    p = torch.from_numpy((rng.standard_normal(REL_N) * 1000)
                         .astype(np.float32)).cuda()
    return k, q, p


@pytest.mark.parametrize("op", ["unique", "group_by_int", "group_by_float",
                                "join", "rle", "delta"])
def test_relational_auto_matches_torch_route(op):
    """Each sort-backed op at 2^20 rows: the planner's kernels launched,
    and the bits of the same call on ``torch.sort`` (no kernel)."""
    import repro_torch.relational as rel
    k, q, p = _rel_cols(0)
    calls = {
        "unique": (lambda m: rel.unique(k, return_inverse=True,
                                        return_counts=True, method=m),
                   "unique"),
        "group_by_int": (lambda m: rel.group_by(
            k, q, agg=("sum", "count", "min", "max", "mean"), method=m),
            "group_by"),
        "group_by_float": (lambda m: rel.group_by(
            k, p, agg=("sum", "min", "max", "mean"), method=m), "group_by"),
        "join": (lambda m: rel.join(k, k[: REL_N // 4], size=REL_N * 2,
                                    method=m), "join"),
        "rle": (lambda m: rel.run_length_encode(k, method=m), "rle"),
        "delta": (lambda m: rel.delta_encode(k, method=m), "delta"),
    }
    fn, name = calls[op]
    got, counts = _launched(lambda: fn(None))
    for kernel in _planned_kernels(name, REL_N, torch.int32):
        assert counts.get(kernel, 0) > 0, (kernel, counts)
    want, counts = _launched(lambda: fn("torch"))
    assert not counts, counts
    _same_tree(got, want)
    again = fn(None)        # the float sums are deterministic on the card
    _same_tree(again, got)


def test_relational_sketches_against_sort_oracles():
    import repro_torch.relational as rel
    _, _, p = _rel_cols(1)
    qs = (0.01, 0.5, 0.99)
    got, counts = _launched(lambda: rel.quantiles(p, qs))
    assert counts.get("select_digit_hist", 0) == 4, counts
    s = torch.sort(p).values
    _same(got.values, s[[int(f * (REL_N - 1)) for f in qs]])
    h = rel.histogram(p, 64)
    idx = (torch.bucketize(p, h.edges, right=True) - 1).clamp(0, 63)
    want = torch.bincount(idx, minlength=64).to(torch.int32)
    _same(h.counts, want)
    assert int(h.counts.sum()) == REL_N


@pytest.mark.parametrize("shape,groups", [((8, 16384), 64),
                                          ((1 << 20,), 4096)])
def test_relational_group_ranks_on_the_card(shape, groups):
    import repro_torch.relational as rel
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, groups, shape).astype(np.int32)
                           ).cuda()
    got, counts = _launched(lambda: rel.group_ranks(ids, groups))
    runs = [got]
    if len(shape) == 1:
        # the sort path: the kernels the card's plan names on `auto`, and
        # K3 on `radix`
        from repro_torch import engine
        plan = engine.choose(shape[0], 1, torch.int32, device="cuda")
        if plan.method == "radix":
            want_kernels = K3
        elif plan.method == "torch":
            want_kernels = ()
        else:
            want_kernels = K3 + ("merge_path_partition",)
        for kernel in want_kernels:
            assert counts.get(kernel, 0) > 0, (plan.method, kernel, counts)
        if not want_kernels:
            assert not counts, (plan.method, counts)
        radix, counts = _launched(lambda: rel.group_ranks(ids, groups,
                                                          method="radix"))
        assert counts.get("radix_onesweep_hist", 0) > 0, counts
        runs.append(radix)
    order = torch.sort(ids, dim=-1, stable=True)
    start = torch.searchsorted(order.values, order.values, side="left")
    pos = torch.arange(shape[-1], device="cuda").expand_as(start)
    want = torch.empty_like(start).scatter_(-1, order.indices, pos - start)
    for r in runs:
        _same(r.ranks, want.to(torch.int32))
        _same(r.counts, torch.nn.functional.one_hot(
            ids.long(), groups).sum(-2).to(torch.int32))


def test_relational_float_sums_on_the_card_match_the_cpu():
    """A float group-by on the card adds each run in order, one run a
    thread, as the CPU does: the same bits as ``device="cpu"`` (the JAX
    package's bits, ``tests/test_torch_relational.py``)."""
    import repro_torch.relational as rel
    k, _, p = _rel_cols(3)
    for vals in (p, p.to(torch.bfloat16)):
        got = rel.group_by(k, vals, agg=("sum", "mean", "min", "max"))
        want = rel.group_by(k.cpu(), vals.cpu(),
                            agg=("sum", "mean", "min", "max"), device="cpu")
        _same_tree([a.cpu() for a in got.aggregates], want.aggregates)
        _same(got.keys.cpu(), want.keys)


# ---------------------------------------------------------------------------
# the spill tier and calibration on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float32", "bfloat16", "int32", "uint16",
                                  "int8"])
@pytest.mark.parametrize("descending", [False, True])
def test_spill_kway_merge_on_k2_matches_the_rank_merge(name, descending):
    """A spill block's k-way merge on K2 (partition + kv merge launches)
    against the same tournament on the plain rank merge, bit for bit;
    uneven runs, ties across them and genuine sentinel-valued keys."""
    from repro_torch.engine import merge as tmerge
    rng = np.random.default_rng(5)
    runs, vals = [], []
    for i, m in enumerate(rng.integers(1, 5000, 7)):
        r = _keys((int(m),), name, seed=int(m))
        r = torch.sort(keycodec.to_signed(r), descending=descending,
                       stable=True).values
        runs.append(keycodec.from_signed(r, getattr(torch, name)))
        vals.append(torch.arange(int(m), dtype=torch.int32,
                                 device="cuda") + 10000 * i)
    (mk, mv), counts = _launched(lambda: tmerge.kway_merge_kv(
        runs, vals, descending=descending, backend="cuda"))
    assert counts.get("merge_path_partition", 0) == \
        counts.get("merge_pairs_kv_blocks", 0) > 0, counts
    wk, wv = tmerge.kway_merge_kv(runs, vals, descending=descending,
                                  backend="torch")
    _same(mk, wk)
    _same(mv, wv)


def test_spill_nan_runs_merge_on_k2_by_order_key():
    """Runs that hold NaN merge on the reference comparator's integer key
    (NaN last, -0.0 with +0.0) on K2; the keys come back by position."""
    from repro_torch.engine import merge as tmerge
    a = torch.tensor([-1.0, -0.0, 2.0, float("inf"), float("nan")],
                     device="cuda")
    b = torch.tensor([0.0, 1.0, float("nan")], device="cuda")
    v = [torch.arange(5, dtype=torch.int32, device="cuda"),
         torch.arange(3, dtype=torch.int32, device="cuda") + 5]
    (mk, mv), counts = _launched(lambda: tmerge.kway_merge_kv(
        [a, b], v, backend="cuda"))
    assert counts.get("merge_pairs_kv_blocks", 0) > 0, counts
    assert mv.tolist() == [0, 1, 5, 6, 2, 3, 4, 7]
    _same(mk, torch.cat([a, b])[mv.long()])


@pytest.mark.parametrize("descending", [False, True])
def test_spill_on_the_card_matches_torch_sort(descending):
    """The spill tier on the card (host input, many chunks, K3 chunk sorts
    on ``method="radix"``, K2 block merges on the copy streams) against
    ``torch.sort(stable=True)``; overlap off gives the same bits."""
    from repro_torch.engine import spill
    rng = np.random.default_rng(8)
    k = torch.from_numpy(rng.integers(0, 1000, 1 << 20).astype(np.int32))
    (order, counts) = _launched(lambda: spill.spill_argsort(
        k, descending=descending, chunk_bytes=1 << 18, method="radix"))
    chunks = (1 << 20) // (1 << 16)
    assert counts.get("radix_onesweep_hist") == chunks, counts
    assert counts.get("radix_onesweep_pass") == 4 * chunks, counts
    assert counts.get("merge_path_partition") == \
        counts.get("merge_pairs_kv_blocks") > 0, counts
    assert order.device.type == "cpu"
    want = torch.sort(k.cuda(), descending=descending, stable=True)
    _same(order, want.indices.to(torch.int32).cpu())
    _same(order, spill.spill_argsort(k, descending=descending,
                                     chunk_bytes=1 << 18, method="radix",
                                     overlap=False))
    x = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32))
    x[::1001] = float("nan")
    got = spill.spill_sort(x, descending=descending, chunk_bytes=1 << 18)
    _same(got, torch.sort(x.cuda(), descending=descending,
                          stable=True).values.cpu())


def test_k3_and_k2_at_the_spill_chunk_sizes():
    """Trouble spot of the default 4 GiB chunk: K3 sorts a 2^30-key row
    (64-bit row offsets, int32 tile counts), K2 merges two 2^29-key runs
    (2L = 2^30 outputs, its int32 positions' largest power of two)."""
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import radix_sort as rsk
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-(1 << 31), 1 << 31, (1, 1 << 30), generator=gen,
                      device="cuda", dtype=torch.int64).to(torch.int32)
    got = rsk.sort_blocks(x)
    want = torch.sort(x.view(-1) ^ -(1 << 31)).values ^ -(1 << 31)
    assert torch.equal(got.view(-1), want)
    del got, want
    a = torch.sort(x.view(-1)[:1 << 29]).values.view(1, -1)
    b = torch.sort(x.view(-1)[1 << 29:]).values.view(1, -1)
    del x
    m = mp.merge_pairs_blocks(a, b)
    assert torch.equal(m.view(-1), torch.sort(torch.cat([a, b], -1)
                                              .view(-1)).values)
    with pytest.raises(ValueError, match="int32"):
        mp.merge_pairs_blocks(torch.cat([a, b], -1), torch.cat([a, b], -1))


def test_spill_plan_falls_back_to_merge_under_graph_capture():
    """While a CUDA graph is being captured a spill plan runs the merge
    pipeline on the card (the reference's outer-jit fallback)."""
    import dataclasses
    from repro_torch import engine
    from repro_torch.core import tuning
    prof = tuning.active()
    tuning.set_active(dataclasses.replace(prof, spill_threshold_bytes=1024))
    try:
        x = torch.randn(1 << 14, device="cuda")
        assert engine.choose(1 << 14, 1, torch.float32).method == "spill"
        engine.sort(x)                  # warm-up outside the capture
        engine.sort(x, method="merge")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph):
            out = engine.sort(x)
        graph.replay()
        torch.cuda.synchronize()
        assert out.is_cuda
        _same(out, torch.sort(x).values)
    finally:
        tuning.set_active(prof)


def test_calibrate_on_the_card_times_the_kernels(tmp_path, monkeypatch):
    from repro_torch.core import tuning
    from repro_torch.engine import planner
    monkeypatch.setenv(tuning.PROFILE_DIR_ENV, str(tmp_path))
    try:
        prof = planner.calibrate(tile_n=1024, batch=16, reps=1,
                                 persist=True)
        assert prof.fingerprint.startswith("cuda/")
        assert {"digit_bits", "run_len", "merge_fanin"} <= set(prof.sweeps)
        assert any(k.startswith("cuda.topk") for k in prof.probe_ns)
        assert any(k.startswith("radix.sort") for k in prof.probe_ns)
        assert all(v > 0 for v in prof.probe_ns.values())
        tuning.set_active(None)
        assert tuning.active().source == "persisted"
    finally:
        planner.reset_calibration()
        tuning.set_active(None)


# ---------------------------------------------------------------------------
# the MoE router and the training path on the card
# ---------------------------------------------------------------------------

def test_router_topk_on_k5_carries_torch_topks_gradient():
    """The router's top-k (rows of 64 experts, k=6) plans K5's short-row
    kernel and its values carry ``torch.topk``'s gradient."""
    from repro_torch import sort as tsort
    from repro_torch.engine import planner
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.softmax(torch.randn(4096, 64, device="cuda", generator=g), -1)
    w = torch.randn(4096, 6, device="cuda", generator=g)
    assert planner.choose(64, 4096, torch.float32, k=6,
                          device="cuda").method == "cuda"
    a = x.clone().requires_grad_(True)
    _build.reset_launches()
    v, i = tsort.topk(a, 6)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"topk_rows_short": 1}
    (ga,) = torch.autograd.grad((v * w).sum(), a)
    b = x.clone().requires_grad_(True)
    tv, ti = torch.topk(b, 6, dim=-1)
    (gb,) = torch.autograd.grad((tv * w).sum(), b)
    assert torch.equal(v.detach(), tv.detach())
    assert torch.equal(i.long(), ti)
    assert torch.equal(ga, gb)


def test_smoke_train_step_on_the_card_matches_the_cpu():
    """One AdamW step of moonshot's smoke model (float32): loss, grad norm
    within 1e-5 relative of the same step on the CPU, the parameters within
    1e-4 but for at most 0.1% of them, which stay within 2 lr (Adam turns a
    1-ulp gradient difference where |g| is near eps into up to ~2 lr, lr
    1e-2 here); the router's K5 runs twice a MoE layer: in the forward and
    in its remat recompute."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                              dtype="float32")
    out = {}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -100, np.int32)],
                            axis=1)
    init = model_zoo.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for dev in ("cpu", "cuda"):
        model = model_zoo.build(cfg, device=dev)
        params = tree.map(lambda p: p.to(dev, copy=True), init)
        fn, opt = steps.make_train_step(model, cfg,
                                        ShapeSpec("t", 32, 4, "train"),
                                        peak_lr=1e-2, total_steps=10)
        state = opt.init(params)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        _build.reset_launches()
        params, state, met = fn(params, state, 1, batch)
        out[dev] = (params, met, dict(_build.launches))
    (pc, mc, _), (pg, mg, lg) = out["cpu"], out["cuda"]
    assert lg.get("topk_rows_short") == 2 * (cfg.n_layers - 1)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-5)
    diff = torch.cat([(a - b.cpu()).abs().reshape(-1)
                      for a, b in zip(tree.leaves(pc), tree.leaves(pg))])
    assert float((diff > 1e-4).float().mean()) <= 1e-3
    assert float(diff.max()) <= 2e-2


# ---------------------------------------------------------------------------
# every family trains on the card
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["whisper-tiny", "deepseek-67b", "minitron-4b", "gemma-2b",
                "nemotron-4-340b", "moonshot-v1-16b-a3b", "dbrx-132b",
                "recurrentgemma-2b", "qwen2-vl-72b", "mamba2-1.3b"]


def _family_batch(cfg, b, s, dev):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import train
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=0))
    return to_device(train.train_batch(data, cfg, 0, 0), dev)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_train_step_on_the_card_matches_the_cpu(arch):
    """One AdamW step of each architecture's smoke model (float32, remat
    on, its family's feeds) on the card against the CPU, with the limits
    of ``test_smoke_train_step_on_the_card_matches_the_cpu``."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    init = model_zoo.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        model = model_zoo.build(cfg, device=dev)
        params = tree.map(lambda p: p.to(dev, copy=True), init)
        fn, opt = steps.make_train_step(model, cfg,
                                        ShapeSpec("t", 32, 4, "train"),
                                        peak_lr=1e-2, total_steps=10)
        state = opt.init(params)
        params, state, met = fn(params, state, 1,
                                _family_batch(cfg, 4, 32, dev))
        out[dev] = (params, met)
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-5)
    diff = torch.cat([(a - b.cpu()).abs().reshape(-1)
                      for a, b in zip(tree.leaves(pc), tree.leaves(pg))])
    assert float((diff > 1e-4).float().mean()) <= 1e-3
    assert float(diff.max()) <= 2e-2


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_remat_gradients_on_the_card_equal_no_remat(arch):
    """The recurrent families' chunk loop and scan run again in the
    backward: float32 gradients with remat equal those without, within
    1e-6."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    on = model_zoo.build(cfg, device="cuda", remat=True)
    off = model_zoo.build(cfg, device="cuda", remat=False)
    params = on.init(torch.Generator(device="cuda").manual_seed(0))
    batch = _family_batch(cfg, 2, 64, "cuda")
    la, _, ga = steps.loss_and_grads(on, params, batch)
    lb, _, gb = steps.loss_and_grads(off, params, batch)
    assert float(la) == float(lb)
    for a, b in zip(tree.leaves(ga), tree.leaves(gb)):
        assert float((a - b).abs().max()) <= 1e-6


def test_dry_run_peak_matches_the_cards_for_gemma():
    """The dry run's peak of a train step against
    ``torch.cuda.max_memory_allocated`` of the same step: gemma-2b at full
    width cut to 2 layers, (2, 256) tokens (a smoke model's tensors are
    below the allocator's 512-byte blocks), within 10%."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=2)
    shape = ShapeSpec("t", 256, 2, "train")
    rec = dryrun.lower_cell("gemma-2b", "t", cfg=cfg, shape=shape,
                            verbose=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = model_zoo.build(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    fn, opt = steps.make_train_step(model, cfg, shape)
    state = opt.init(params)
    fn(params, state, 0, _family_batch(cfg, 2, 256, "cuda"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak == pytest.approx(rec["memory"]["peak_bytes"], rel=0.1)


# ---------------------------------------------------------------------------
# the distributed tier: K3's bucket histogram and a sample sort on one card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bins,case", [(2, "random"), (9, "random"),
                                       (257, "random"), (1024, "random")]
                         + [(None, c) for c in CASES])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int8])
def test_k3_bucket_hist_matches_plain(bins, case, dtype):
    """``radix_bucket_hist`` (a search of the sorted shard for each
    splitter) against its plain version (the reference's tiled one-hot
    histogram of the interval ids), bit for bit, one launch: on a sorted
    shard with runs of ties on the splitters at D + 1 bins, and on the
    search's edge cases (``tests/_bucket_cases.py``: one key, fewer than
    33, all equal, splitters all below or above, repeated splitters, ties
    ending at the first round's probes, 1022 splitters); 1025 bins
    raise."""
    info = torch.iinfo(dtype)
    if case == "random":
        g = torch.Generator(device="cuda").manual_seed(bins)
        k = torch.randint(max(info.min, -300), min(info.max, 300) + 1,
                          (1 << 20,), generator=g, device="cuda",
                          dtype=torch.int32).sort().values.to(dtype)
        sp = k[torch.randint(0, k.shape[0], (bins - 2,), generator=g,
                             device="cuda")].sort().values
    else:
        kn, spn = bucket_case(case, 1 << 20, info.min, info.max, 5)
        k = torch.from_numpy(kn).to(dtype).cuda()
        sp = torch.from_numpy(spn).to(dtype).cuda()
    _build.reset_launches()
    got = rsk.bucket_hist(k, sp)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"radix_bucket_hist": 1}
    want = rsk.bucket_hist_plain(k.cpu(), sp.cpu())
    assert torch.equal(got.cpu(), want)
    assert int(got.sum()) == k.shape[0] and int(got[-1]) == 0
    with pytest.raises(ValueError, match="1024"):
        rsk.bucket_hist(k, torch.cat([sp, sp[:1]]) if bins == 1024
                        else k.new_zeros(1023))


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_sample_sort_on_one_card_matches_torch_sort(shape):
    """Eight mesh entries on cuda:0 (flat and 2 x 4): keys against
    ``torch.sort``'s, the permutation against its stable one; the flat
    sort launches ``radix_bucket_hist`` once a shard."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import samplesort as ss
    mesh = make_mesh(shape, ("a", "b")[:len(shape)], "cuda:0")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(-1000, 1000, (1 << 20,), generator=g, device="cuda",
                      dtype=torch.int32)
    _build.reset_launches()
    k, perm = ss.sample_sort(x, mesh, None, return_indices=True,
                             descending=True)
    ref = torch.sort(x, descending=True, stable=True)
    assert torch.equal(k, ref.values)
    assert torch.equal(perm.long(), ref.indices)
    if shape == (8,):
        assert _build.launches.get("radix_bucket_hist") == 8


@pytest.mark.parametrize("n,k,share", [(40, 8, 0.15), (64, 8, 0.15),
                                       (128256, 50, 0.15),
                                       (128256, 50, 0.0002),
                                       (1 << 20, 256, 0.001)])
def test_k5_kernels_rank_nan_first_like_plain(n, k, share):
    """K5's one-pass kernels (k <= 256: the short, stream and merge
    launches) on rows with NaNs against their plain version: NaN ranks
    above every number, in index order (``lax.top_k``'s rule), also where
    NaNs come after the admission bound has risen.  The k > 256 network
    route assumes NaN-free keys, as the sorts do (ROADMAP 3c)."""
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((6, n), generator=g, device="cuda")
    mask = torch.rand((6, n), generator=g, device="cuda") < share
    x[mask] = float("nan")
    v, i = btk.topk_rows(x, k)
    pv, pi = btk.topk_rows_plain(x, k)
    _same(v, pv)
    _same(i, pi)
    want = torch.sort(torch.where(torch.isnan(x), float("inf"), x),
                      dim=-1, descending=True, stable=True).indices[:, :k]
    nan_rank = torch.isnan(x).sum(-1).clamp(max=k)
    for r in range(6):
        first = int(nan_rank[r])
        assert torch.isnan(v[r, :first]).all()
        if first < k:
            assert torch.equal(i[r, first:].long(), want[r, first:k])


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph (launch.steps.DecodeGraph)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ("minitron-4b", "gemma-2b", "deepseek-67b", "nemotron-4-340b",
               "moonshot-v1-16b-a3b", "dbrx-132b", "mamba2-1.3b",
               "recurrentgemma-2b", "whisper-tiny", "qwen2-vl-72b")


def _graph_feed(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    feed = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()}
    if cfg.family == "encdec":
        feed["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1).cuda()
    return feed


def _clone_state(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_state(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_state(v) for v in tree)
    return tree


def _k5_launches():
    return {k: v for k, v in _build.launches.items()
            if k.startswith(("topk_rows", "bitonic_topk"))}


def _graph_setup(arch, b=2, s=13, k=10, **over):
    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = model_zoo.build(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    shape = ShapeSpec("serve", 48, b, "decode")
    return (model, params, steps.DecodeGraph(model, shape, sample_topk=k),
            steps.make_serve_step(model, shape, sample_topk=k),
            _graph_feed(cfg, b, s, len(arch)))


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_graph_matches_the_eager_step(arch):
    """The captured step against the eager ``make_serve_step`` from the
    same prefill state under the same uniforms: equal tokens and logits,
    and K5's launches counted through the replays (a step's launches,
    times the replays and the warm-up steps)."""
    from repro_torch.launch import steps
    b, k, n = 2, 10, 6
    model, params, graph, eager, feed = _graph_setup(arch, b=b, k=k)
    logits, st = graph.prefill(params, feed)
    est, lst = _clone_state(st), _clone_state(st)
    u = torch.rand((n, b, k), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _build.reset_launches()
    eager(params, tok, _clone_state(st), u[0])
    torch.cuda.synchronize()
    per_step = _k5_launches()
    assert per_step, f"{arch}: no K5 launch in a decode step"
    want, want_logits, etok = [], [], tok
    for i in range(n):
        lg, lst = model.decode_step(params, etok, lst)
        want_logits.append(lg)
        etok, est = eager(params, etok, est, u[i])
        want.append(etok)
    _build.reset_launches()
    gtok = tok
    for i in range(n):
        gtok, st = graph(params, gtok, st, u[i])
        assert torch.equal(gtok, want[i]), (arch, i)
        assert torch.equal(graph.logits(b), want_logits[i]), (arch, i)
    torch.cuda.synchronize()
    assert graph.captures == 1 and graph.replays == n
    assert graph.warmup_steps == steps.GRAPH_WARMUP
    assert _k5_launches() == {name: c * (n + steps.GRAPH_WARMUP)
                              for name, c in per_step.items()}
    assert int(st["t"]) == int(est["t"]) == 13 + n


def test_decode_graph_refuses_a_host_reading_plan_by_name():
    """The ``torch`` backend's top-k reads the host (``nonzero``): planned
    for the sampling, the capture fails and names it; nothing falls back
    to the eager step."""
    b, k = 2, 10
    model, params, graph, _, feed = _graph_setup("minitron-4b", b=b, k=k,
                                                 sort_method="torch")
    logits, st = graph.prefill(params, feed)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    u = torch.rand((b, k), device="cuda")
    with pytest.raises(RuntimeError, match="'torch' backend's top-k reads"):
        graph(params, tok, st, u)
    assert graph.captures == 0 and graph.replays == 0


def test_decode_graph_captures_with_tracing_on():
    """With obs on, the spans of the captured step record no device time
    and nothing synchronises inside the capture (a wait there would fail
    it); the warm-up steps' spans are timed; the tokens equal the eager
    step's."""
    from repro_torch import obs
    b, k, n = 2, 10, 4
    model, params, graph, eager, feed = _graph_setup("moonshot-v1-16b-a3b",
                                                     b=b, k=k)
    obs.clear()
    try:
        with obs.tracing():
            logits, st = graph.prefill(params, feed)
            est = _clone_state(st)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            etok = tok
            u = torch.rand((n, b, k), device="cuda")
            for i in range(n):
                tok, st = graph(params, tok, st, u[i])
                etok, est = eager(params, etok, est, u[i])
                assert torch.equal(tok, etok), i
            topk = [sp for sp in obs.trace.spans()
                    if sp["name"] == "engine.topk"]
    finally:
        obs.clear()
    assert graph.captures == 1 and graph.replays == n
    assert any(sp["device_ms"] is None for sp in topk)
    assert any(sp["device_ms"] is not None for sp in topk)


def test_serve_on_the_card_replays_one_graph_a_batch_size():
    """``serve`` on the card: every decode step a replay (batches x
    (steps - 1)), one capture a batch size (8 requests in batches of 3:
    sizes 3 and 2), and K5's sampling launches = the replays plus the
    warm-up steps."""
    from repro_torch.launch import serve as srv
    _build.reset_launches()
    done, stats = srv.serve("minitron-4b", n_requests=8, batch_size=3,
                            decode_steps=5, topk=10, max_len=64,
                            device="cuda")
    torch.cuda.synchronize()
    assert stats["decode_route"] == "graph"
    assert stats["graph_replays"] == stats["batches"] * 4 == 12
    assert stats["graph_captures"] == 2
    k5 = _build.launches.get("topk_rows_short", 0) \
        + _build.launches.get("topk_rows_stream", 0)
    assert k5 == stats["graph_replays"] + stats["graph_warmup_steps"]
    assert sorted(r.rid for r in done) == list(range(8))
    assert all(len(r.out) == 5 for r in done)
