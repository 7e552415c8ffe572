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
@pytest.mark.parametrize("h", [16, 32, 64, 128])
@pytest.mark.parametrize("g,s,t,q_offset,causal,window", [
    (1, 64, 64, 0, True, 0),
    (3, 100, 100, 0, True, 0),        # S not a multiple of the block
    (1, 200, 200, 0, True, 24),       # windowed
    (3, 130, 130, 0, False, 0),
    (3, 70, 200, 130, True, 0),       # absolute positions from q_offset
    (1, 96, 160, 64, True, 40),
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
@pytest.mark.parametrize("h", [64, 128])
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
    if len(shape) == 1:
        assert counts.get("radix_onesweep_hist", 0) > 0, counts
    order = torch.sort(ids, dim=-1, stable=True)
    start = torch.searchsorted(order.values, order.values, side="left")
    pos = torch.arange(shape[-1], device="cuda").expand_as(start)
    want = torch.empty_like(start).scatter_(-1, order.indices, pos - start)
    _same(got.ranks, want.to(torch.int32))
    _same(got.counts, torch.nn.functional.one_hot(
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
