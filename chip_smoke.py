#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build    compile every kernel (one ``nvcc`` per source, all at once)
            into ``build/kernels/``;
2. kernels  every kernel against its plain PyTorch version on the card,
            bit for bit (signed zeros, ties and dtype extremes included);
3. main     the port's entry points at the standard GPU sort benchmark's
            size (2^28 32-bit keys): sort, argsort (also stable), sort_kv,
            the radix and cuda backends and an engine top-k; then top-k
            through the select (K4) and cuda (K5) backends at the shapes of
            vocabulary sampling, MoE routing and gradient compression, MoE
            token grouping, a ragged segment sort and a padded-row sort.
            Each is held bit-exactly against ``torch.sort(stable=True)``
            (ties keep ascending index in both directions; the select
            backend's top-k on the IEEE total order, +0.0 above -0.0).
            Each call runs once with the launch counts set to 0 just before
            and read just after, then is timed with CUDA events over a few
            more calls;
4. timing   each kernel at the main path's shapes: its output held bit for
            bit against its plain version on the same inputs (the
            ``max_abs_err`` of the kernel table), then CUDA-event times of
            both beside ``torch.sort`` (``torch.topk`` for K4 and K5) on
            the same rows.

The last three lines are the card (``nvidia-smi`` name, power limit), the
kernel table, and ``{"ok": true, "device": ...}``.  Any failed build,
launch or comparison raises and the script exits non-zero without them.
It needs a card: without one it exits 2 before doing anything.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
MAIN_N = 1 << 28          # float32 keys of the merge sort (1 GiB)
KV_N = 1 << 26            # int32 / uint32 keys of argsort, sort_kv, radix
BATCH = (8192, 4096)      # rows of the cuda backend
TOPK_N, TOPK_K = 1 << 24, 64
VOCAB = (64, 128256)      # sampling rows over Llama 3's vocabulary, k=50
ROUTER = (16384, 64)      # MoE routing: OLMoE's 64 experts, top-8
GRAD_N = 1 << 26          # gradient compression at 1%: topk_budget
SEGMENTS = 4096           # ragged segments of the 2^24-key segment sort

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warm: bool = True):
    """(mean ms of ``fn`` over ``reps`` calls, timed with CUDA events, and
    the output of the warm-up call that precedes them, if ``warm``)."""
    import torch
    out = fn() if warm else None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def bits(t):
    """A tensor's raw bits as a signed integer tensor of its width."""
    import torch
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _f64(t):
    """Values as float64 (unsigned types through their bits)."""
    import torch
    if t.dtype in (torch.uint16, torch.uint32):
        return (bits(t).to(torch.int64) & ((1 << 8 * t.element_size()) - 1)
                ).to(torch.float64)
    return t.to(torch.float64)


def same_bits(x, y, what: str) -> float:
    """Fail unless x and y are bit-identical; return max |x - y| over the
    elements (0 where the bits agree, so equal infinities count 0)."""
    import torch
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{what}: {tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(y.shape)} {y.dtype}")
    eq = bits(x) == bits(y)
    err = 0.0 if x.numel() == 0 else torch.where(
        eq, 0.0, (_f64(x) - _f64(y)).abs()).max().item()
    if not bool(eq.all()):
        bad = (~eq).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: bits differ (max |diff| {err}), "
                             f"first at {bad}")
    return err


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------

def _keys(rng, shape, dtype):
    """Heavy ties, signed zeros and the dtype's extremes."""
    import numpy as np
    import torch
    if dtype.is_floating_point:
        raw = rng.integers(-8, 9, size=shape).astype(np.float32)
        raw.flat[0::17] = 0.0
        raw.flat[1::17] = -0.0
        raw.flat[2::97] = np.inf
        raw.flat[3::97] = -np.inf
        t = torch.from_numpy(raw).to(dtype)
        fi = torch.finfo(dtype)
        t.view(-1)[4::101] = fi.max
        t.view(-1)[5::101] = fi.min
        return t.cuda()
    info = torch.iinfo(dtype)
    raw = rng.integers(max(info.min, -8), min(info.max, 8) + 1, size=shape)
    raw.flat[0::31] = info.min
    raw.flat[1::31] = info.max
    return torch.from_numpy(raw.astype(str(dtype).split(".")[-1])).cuda()


def phase_kernels(rng) -> dict:
    import torch
    from repro_torch.core import keycodec
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import bitonic_topk as btk
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import radix_select as sel
    from repro_torch.kernels import radix_sort as rsk

    cases = 0
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
              torch.uint32, torch.int16, torch.uint16, torch.int8,
              torch.uint8)
    # K1: key-only and key-value, both directions
    for dtype in dtypes:
        for rows, n in ((300, 2), (64, 32), (96, 256), (40, 4096),
                        (3, 16384)):
            x = _keys(rng, (rows, n), dtype)
            idx = torch.arange(n, dtype=torch.int32, device="cuda") \
                .expand(rows, n).contiguous()
            for desc in (False, True):
                same_bits(bs.sort_blocks(x, descending=desc),
                          bs.apply_network(x, desc),
                          f"K1 {dtype} {rows}x{n} desc={desc}")
                k1, v1 = bs.sort_kv_blocks(x, idx, descending=desc)
                k2, v2 = bs.apply_network_kv(x, idx, desc)
                same_bits(k1, k2, f"K1 kv keys {dtype} {rows}x{n} {desc}")
                same_bits(v1, v2, f"K1 kv vals {dtype} {rows}x{n} {desc}")
                cases += 3
    # random (non-index) payloads with ties: the composite comparator
    x = _keys(rng, (64, 1024), torch.float32)
    pay = torch.from_numpy(rng.integers(-3, 4, size=(64, 1024))
                           .astype("int32")).cuda()
    for desc in (False, True):
        k1, v1 = bs.sort_kv_blocks(x, pay, descending=desc)
        k2, v2 = bs.apply_network_kv(x, pay, desc)
        same_bits(k1, k2, "K1 kv random payload keys")
        same_bits(v1, v2, "K1 kv random payload vals")
        cases += 2

    # K2: runs sharing duplicates, strided pair views as the merge tree
    for dtype in dtypes:
        for rows, l in ((500, 1), (64, 3), (32, 1000), (8, 4096),
                        (1, 1 << 20)):
            raw = _keys(rng, (rows, 2, l), dtype)
            pairs = keycodec.from_signed(
                torch.sort(keycodec.to_signed(raw), dim=-1).values, dtype)
            a, b = pairs[:, 0, :], pairs[:, 1, :]
            same_bits(mp.merge_pairs_blocks(a, b), mp.rank_merge(a, b)[0],
                      f"K2 {dtype} {rows}x{l}")
            va = torch.arange(l, dtype=torch.int32, device="cuda") \
                .expand(rows, l).contiguous()
            vb = va + l
            k1, v1 = mp.merge_pairs_kv_blocks(a, b, va, vb)
            k2, v2 = mp.rank_merge(a, b, va, vb)
            same_bits(k1, k2, f"K2 kv keys {dtype} {rows}x{l}")
            same_bits(v1, v2, f"K2 kv vals {dtype} {rows}x{l}")
            cases += 3

    # K3: one pass of each kernel, then whole kv sorts, 8/16/32-bit keys
    for carrier in (torch.int8, torch.int16, torch.int32):
        nbits = carrier.itemsize * 8
        for rows, m, tile, db in ((3, 4096, 256, 8), (2, 1 << 16, 4096, 8),
                                  (4, 3000, 1000, 4), (1, 1 << 20, 4096, 8)):
            raw = rng.integers(0, 1 << nbits, size=(rows, m))
            raw[:, 1::2] = raw[:, 0::2][:, :raw[:, 1::2].shape[1]]
            keys = torch.from_numpy(raw.astype(f"uint{nbits}")
                                    .view(f"int{nbits}")).cuda()
            vals = torch.arange(m, dtype=torch.int32, device="cuda") \
                .expand(rows, m).contiguous()
            for shift in range(0, nbits, db):
                h1 = rsk.digit_hist(keys, shift, db, tile)
                h2 = rsk.digit_hist_plain(keys, shift, db, tile)
                same_bits(h1, h2, f"K3 hist {carrier} {rows}x{m} s{shift}")
                base = rsk.tile_bases(h1, rows)
                k1, v1 = rsk.digit_scatter(keys, vals, base, shift, db, tile)
                k2, v2 = rsk.digit_scatter_plain(keys, vals, base, shift, db,
                                                 tile)
                same_bits(k1, k2, f"K3 scatter keys {carrier} s{shift}")
                same_bits(v1, v2, f"K3 scatter vals {carrier} s{shift}")
                cases += 3
            # whole sort: kernels vs the plain pass loop
            sk1, sv1 = rsk.sort_kv_blocks(keys, vals, tile=tile,
                                          digit_bits=db)
            pk, pv, t = rsk._padded(keys, vals, tile)
            for shift in range(0, nbits, db):
                hb = rsk.tile_bases(rsk.digit_hist_plain(pk, shift, db, t),
                                    rows)
                pk, pv = rsk.digit_scatter_plain(pk, pv, hb, shift, db, t)
            same_bits(sk1, pk[:, :m], f"K3 sort keys {carrier} {rows}x{m}")
            same_bits(sv1, pv[:, :m], f"K3 sort vals {carrier} {rows}x{m}")
            cases += 2

    # K4: every pass of the refinement, the first (every key active) and
    # the later ones under each row's k-th key as threshold prefix, on
    # source keys (encoded in registers) and on encoded keys; 10007 keys
    # leave a ragged last tile at either tile size
    for dtype in dtypes:
        x = _keys(rng, (5, 10007), dtype)
        enc = keycodec.encode(x, descending=True)
        nbits = 8 * x.element_size()
        u = enc.to(torch.int64) & ((1 << nbits) - 1)
        kth = torch.sort(u, dim=-1).values[:, 5000].contiguous()
        for db, tile in ((8, 4096), (4, 1000)):
            for thresh in (torch.zeros_like(kth), kth):
                for shift in range(nbits - db, -1, -db):
                    for keys, encode in ((x, True), (enc, False)):
                        same_bits(
                            sel.digit_hist(keys, thresh, shift, db, tile,
                                           encode=encode),
                            sel.digit_hist_plain(keys, thresh, shift, db,
                                                 tile, encode=encode),
                            f"K4 {dtype} db={db} shift={shift} "
                            f"encode={encode}")
                        cases += 1

    # K5: short and chunk-long rows, a row at the sentinel and a row of
    # signed zeros
    for dtype in dtypes:
        for n in (8, 64, 2048):
            x = _keys(rng, (70, n), dtype)
            if dtype.is_floating_point:
                x[1] = float("-inf")
                x[2] = 0.0
                x[2, 0::3] = -0.0
            else:
                x[1] = torch.iinfo(dtype).min
            for k in (1, 8, 50, n):
                if k <= n:
                    v1, i1 = btk.topk_blocks(x, k)
                    v2, i2 = btk.topk_plain(x, k)
                    same_bits(v1, v2, f"K5 values {dtype} n={n} k={k}")
                    same_bits(i1, i2, f"K5 indices {dtype} n={n} k={k}")
                    cases += 2
    torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _ref_sort(x, descending=False):
    """torch.sort(stable=True) in the engine's conventions: sorted keys and
    the permutation with ties in ascending index order both ways."""
    import torch
    from repro_torch.core import keycodec
    s = torch.sort(keycodec.to_signed(x), stable=True, descending=descending)
    return keycodec.from_signed(s.values, x.dtype), s.indices.to(torch.int32)


def phase_main(rng) -> dict:
    import numpy as np
    import torch
    import repro_torch.sort as rsort
    from repro_torch import engine
    from repro_torch.core import keycodec
    from repro_torch.kernels import _build

    launches: dict = {}
    steps = []

    def run(name, fn, must, reps=3):
        """One counted call (counts set to 0 just before, read just after),
        then ``reps`` more timed with CUDA events, the first as warm-up."""
        _build.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        missing = [k for k in must if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing} "
                                 f"(counts {counts})")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ms = cuda_ms(fn, reps, warm=False)[0]
        steps.append({"step": name, "ms": ms, "launches": counts})
        emit({"phase": "main", "step": name, "ms": ms, "reps": reps,
              "launches": counts})
        return out

    # 2^28 float32 through the merge engine: K1 runs + K2 merge tree
    x = torch.from_numpy(rng.standard_normal(MAIN_N, dtype=np.float32)).cuda()
    plan = engine.choose(MAIN_N, 1, torch.float32, device="cuda")
    emit({"phase": "main", "auto_plan_2^28_float32": plan.method,
          "run_method": plan.run_method, "merge_backend": plan.merge_backend,
          "run_len": plan.run_len, "costs_ns": plan.costs})
    out = run("sort merge 2^28 float32",
              lambda: rsort.sort(x, method="merge"),
              ("bitonic_sort_blocks", "merge_pairs_blocks"))
    same_bits(out, _ref_sort(x)[0], "sort 2^28")
    del out, x

    # 2^26 int32 with heavy duplicates: argsort and sort_kv, both ways
    k = torch.from_numpy(rng.integers(0, 4096, KV_N).astype(np.int32)).cuda()
    payload = torch.arange(KV_N, dtype=torch.int32, device="cuda")
    for desc in (False, True):
        ref_k, ref_i = _ref_sort(k, desc)
        order = run(f"argsort merge 2^26 int32 desc={desc}",
                    lambda: rsort.argsort(k, method="merge",
                                          descending=desc),
                    ("bitonic_sort_kv_blocks", "merge_pairs_kv_blocks"))
        same_bits(order, ref_i, f"argsort desc={desc}")
        sk, sv = run(f"sort_kv merge 2^26 int32 desc={desc}",
                     lambda: rsort.sort_kv(k, payload, method="merge",
                                           descending=desc),
                     ("bitonic_sort_kv_blocks", "merge_pairs_kv_blocks"))
        same_bits(sk, ref_k, f"sort_kv keys desc={desc}")
        same_bits(sv, ref_i, f"sort_kv payload desc={desc}")
        # a stable merge sort: K3 (stable) sorts the runs in K1's place
        order = run(f"argsort stable merge 2^26 int32 desc={desc}",
                    lambda: rsort.argsort(k, method="merge", stable=True,
                                          descending=desc),
                    ("radix_digit_hist", "radix_digit_scatter",
                     "merge_pairs_kv_blocks"))
        same_bits(order, ref_i, f"stable argsort desc={desc}")
    del k, order, sk, sv, ref_k, ref_i

    # 2^26 uint32 through the radix backend (K3)
    u = torch.from_numpy(rng.integers(0, 1 << 32, KV_N, dtype=np.uint32)
                         .view(np.int32)).cuda().view(torch.uint32)
    sk, sv = run("sort_kv radix 2^26 uint32",
                 lambda: rsort.sort_kv(u, payload, method="radix"),
                 ("radix_digit_hist", "radix_digit_scatter"))
    ref_k, ref_i = _ref_sort(u)
    same_bits(sk, ref_k, "radix keys")
    same_bits(sv, ref_i, "radix payload")
    del u, sk, sv, ref_k, ref_i, payload

    # the cuda backend on a (8192, 4096) float32 batch (K1 key-value)
    xb = torch.from_numpy(rng.standard_normal(BATCH, dtype=np.float32)).cuda()
    out = run("sort cuda 8192x4096 float32",
              lambda: rsort.sort(xb, method="cuda"),
              ("bitonic_sort_kv_blocks",))
    same_bits(out, torch.sort(xb, dim=-1, stable=True).values, "cuda batch")
    del xb, out

    # engine top-k through the merge path (K1 + K2 key-value)
    xt = torch.from_numpy(rng.standard_normal(TOPK_N, dtype=np.float32)).cuda()
    v, i = run(f"topk merge k={TOPK_K} 2^24 float32",
               lambda: rsort.topk(xt, TOPK_K, method="merge"),
               ("bitonic_sort_kv_blocks", "merge_pairs_kv_blocks"))
    ref_v, ref_i = _ref_sort(xt, descending=True)
    same_bits(v, ref_v[:TOPK_K], "topk values")
    same_bits(i, ref_i[:TOPK_K], "topk indices")

    # top-k through the selection (K4) and bitonic top-k (K5) backends.
    # References: select ranks on the IEEE total order (+0.0 above -0.0,
    # lax.top_k), cuda numerically; both take the lower index on ties.
    for shape, k in (((TOPK_N,), TOPK_K), (VOCAB, 50), (ROUTER, 8),
                     ((GRAD_N,), 671088)):
        n, batch = shape[-1], (shape[0] if len(shape) == 2 else 1)
        p = engine.choose(n, batch, torch.float32, k=k, device="cuda")
        emit({"phase": "main", "auto_topk_plan": list(shape), "k": k,
              "method": p.method, "costs_ns": p.costs})

    def check_topk(name, x, k, method, got):
        key = keycodec.total_order_key(x) if method == "select" else x
        order = torch.sort(key, dim=-1, stable=True,
                           descending=True).indices[..., :k]
        same_bits(got[1], order.to(torch.int32), f"{name} indices")
        same_bits(got[0], x.gather(-1, order), f"{name} values")

    sel_k = ("select_digit_hist", "bitonic_sort_kv_blocks")
    v_i = run(f"topk select k={TOPK_K} 2^24 float32",
              lambda: rsort.topk(xt, TOPK_K, method="select"), sel_k)
    check_topk("topk select 2^24", xt, TOPK_K, "select", v_i)
    del xt

    logits = torch.from_numpy(rng.standard_normal(VOCAB, dtype=np.float32)
                              * 4).cuda()
    v_i = run("topk select k=50 (64, 128256) float32",
              lambda: rsort.topk(logits, 50, method="select"), sel_k)
    check_topk("topk select vocab", logits, 50, "select", v_i)
    k5_k1 = ("bitonic_topk_blocks", "bitonic_sort_kv_blocks")
    v_i = run("topk cuda k=50 (64, 128256) float32",
              lambda: rsort.topk(logits, 50, method="cuda"), k5_k1)
    check_topk("topk cuda vocab", logits, 50, "cuda", v_i)
    # padded vocabulary: the last 128 lanes masked to -inf, and row 0
    # masked down to 10 finite lanes, fewer than k (the reference's top-k
    # returned index -1 there)
    masked = logits.clone()
    masked[:, -128:] = float("-inf")
    masked[0, 10:] = float("-inf")
    for method, must in (("cuda", k5_k1), ("select", sel_k)):
        v_i = run(f"topk {method} k=50 (64, 128256) float32 -inf masked",
                  lambda: rsort.topk(masked, 50, method=method), must)
        check_topk(f"topk {method} masked", masked, 50, method, v_i)
        if int(v_i[1].min()) < 0:
            raise AssertionError(f"topk {method}: negative index")
    del logits, masked

    router = torch.from_numpy(rng.standard_normal(ROUTER, dtype=np.float32)
                              ).cuda()
    v_i = run("topk cuda k=8 (16384, 64) float32",
              lambda: rsort.topk(router, 8, method="cuda"),
              ("bitonic_topk_blocks",))
    check_topk("topk cuda router", router, 8, "cuda", v_i)
    del router

    # gradient compression: the top 1% of |g| (grad_compress.topk_budget)
    g = torch.from_numpy(rng.standard_normal(GRAD_N, dtype=np.float32)
                         ).cuda().abs()
    gk = GRAD_N // 100
    v_i = run(f"topk select k={gk} |g| of 2^26 float32",
              lambda: rsort.topk(g, gk, method="select"),
              ("select_digit_hist", "bitonic_sort_kv_blocks",
               "merge_pairs_kv_blocks"))
    check_topk("topk select grad", g, gk, "select", v_i)
    del g, v_i

    # MoE dispatch: 16384 tokens x top-8 expert ids, a stable grouping
    ids = torch.from_numpy(rng.integers(0, 64, ROUTER[0] * 8)
                           .astype(np.int32)).cuda()
    p = engine.choose(ids.numel(), 1, torch.int32, device="cuda")
    emit({"phase": "main", "auto_plan_group_tokens": p.method})
    perm, splits = run("group_tokens_by_expert 131072 ids, 64 experts",
                       lambda: engine.group_tokens_by_expert(ids, 64),
                       ("radix_digit_hist", "radix_digit_scatter"))
    same_bits(perm, _ref_sort(ids)[1], "group_tokens permutation")
    counts = torch.bincount(ids.long(), minlength=64)
    same_bits(splits, torch.cat([counts.new_zeros(1), counts.cumsum(0)])
              .to(torch.int32), "group_tokens row splits")
    del ids, perm, splits

    # ragged segments: 2^24 float32 over 4096 segments of random lengths
    xs = torch.from_numpy(rng.standard_normal(TOPK_N, dtype=np.float32)
                          ).cuda()
    cuts = np.sort(rng.choice(np.arange(1, TOPK_N), SEGMENTS - 1,
                              replace=False))
    splits = torch.from_numpy(np.concatenate([[0], cuts, [TOPK_N]])
                              .astype(np.int64)).cuda()
    sv, ss = run(f"segment_sort 2^24 float32, {SEGMENTS} segments",
                 lambda: rsort.segment_sort(xs, row_splits=splits),
                 ("radix_digit_hist", "radix_digit_scatter"))
    seg = engine.segment_ids_from_row_splits(splits, TOPK_N)
    o1 = _ref_sort(xs)[1].long()
    order = o1.gather(0, _ref_sort(seg.gather(0, o1))[1].long())
    same_bits(sv, xs.gather(0, order), "segment_sort values")
    same_bits(ss, seg.gather(0, order), "segment_sort segment ids")
    del xs, splits, sv, ss, seg, o1, order

    # padded rows: each row's valid prefix sorted, the tail filled
    b = torch.from_numpy(rng.standard_normal(VOCAB, dtype=np.float32)).cuda()
    lengths = torch.from_numpy(rng.integers(0, VOCAB[1] + 1, VOCAB[0])
                               ).cuda()
    out = run("sort(valid_lengths=...) (64, 128256) float32",
              lambda: rsort.sort(b, valid_lengths=lengths, fill_value=-1.0),
              ("radix_digit_hist", "radix_digit_scatter"))
    valid = torch.arange(VOCAB[1], device="cuda")[None, :] < lengths[:, None]
    want = torch.sort(torch.where(valid, b, float("inf")), dim=-1,
                      stable=True).values
    same_bits(out, torch.where(valid, want, -1.0), "valid_lengths sort")
    torch.cuda.synchronize()
    return {"launches": launches, "steps": steps}


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
# ---------------------------------------------------------------------------

def _bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_timing(launches, run_len, radix_tile, digit_bits):
    """Each kernel at the main path's shapes: held bit for bit against its
    plain version on the same inputs, then timed beside it and beside
    ``torch.sort`` on the same rows.  Inputs are made on the card."""
    import torch
    from repro_torch.core import keycodec
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import bitonic_topk as btk
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_select as sel
    from repro_torch.kernels import radix_sort as rsk

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def compare(name, kernel, plain) -> float:
        """Max |diff| between the kernel's and the plain version's outputs
        (both tuples of tensors); fails unless they agree bit for bit."""
        return max(same_bits(g, w, f"{name} vs plain")
                   for g, w in zip(kernel(), plain()))

    def row(name, source, replaces, kernel, plain, nbytes, ops, library,
            err=0.0):
        ms, got = cuda_ms(kernel, 10)
        plain_ms, want = cuda_ms(plain, 1)
        err = max([err] + [same_bits(g, w, f"{name} vs plain")
                           for g, w in zip(got, want)])
        del got, want
        b, by = _bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None if library is None
                     else cuda_ms(library, 10)[0]})
        emit({"phase": "timing", **rows[-1]})

    # K1 key-only: the runs of the 2^28 float32 sort
    n = run_len
    lg = n.bit_length() - 1
    cas = lambda r: r * (n // 2) * lg * (lg + 1) // 2  # noqa: E731
    t = torch.randn((MAIN_N // n, n), generator=gen, device="cuda")
    row("bitonic_sort_blocks", "src/repro_torch/csrc/bitonic_sort.cu",
        "src/repro/kernels/bitonic_sort.py:144",
        lambda: (bs.sort_blocks(t),), lambda: (bs.apply_network(t, False),),
        2 * t.numel() * 4, cas(t.shape[0]),
        lambda: torch.sort(t, dim=-1))
    del t
    # K1 key-value: the runs of the 2^26 int32 argsort
    t = ints((KV_N // n, n), 4096)
    idx = torch.arange(n, dtype=torch.int32, device="cuda") \
        .expand(t.shape).contiguous()
    row("bitonic_sort_kv_blocks", "src/repro_torch/csrc/bitonic_sort.cu",
        "src/repro/kernels/bitonic_sort.py:172",
        lambda: bs.sort_kv_blocks(t, idx),
        lambda: bs.apply_network_kv(t, idx, False),
        2 * t.numel() * 8, cas(t.shape[0]),
        lambda: torch.sort(t, dim=-1, stable=True))
    del t, idx

    def sorted_pairs(pairs):
        """(rows, 2, L) sorted along L -> the strided (a, b) views the merge
        tree hands the kernel, and the rows as one (rows, 2L) tensor."""
        pairs = torch.sort(pairs, dim=-1).values
        return pairs[:, 0, :], pairs[:, 1, :], pairs.view(pairs.shape[0], -1)

    # K2 key-only: the last merge level of the 2^28 float32 sort (checked),
    # then the first (checked and timed)
    a, b, _ = sorted_pairs(torch.randn((1, 2, MAIN_N // 2), generator=gen,
                                       device="cuda"))
    last = compare("merge_pairs_blocks (1, 2^27) x 2",
                   lambda: (mp.merge_pairs_blocks(a, b),),
                   lambda: mp.rank_merge(a, b)[:1])
    a, b, flat = sorted_pairs(torch.randn((MAIN_N // (2 * n), 2, n),
                                          generator=gen, device="cuda"))
    row("merge_pairs_blocks", "src/repro_torch/csrc/merge_path.cu",
        "src/repro/kernels/merge_path.py:182",
        lambda: (mp.merge_pairs_blocks(a, b),),
        lambda: mp.rank_merge(a, b)[:1],
        2 * flat.numel() * 4, flat.numel(),
        lambda: torch.sort(flat, dim=-1), err=last)
    del a, b, flat

    # K2 key-value: the last and the first merge level of the 2^26 int32
    # argsort (heavy ties across the two runs)
    def kv_pairs(rows_, l):
        a, b, flat = sorted_pairs(ints((rows_, 2, l), 4096))
        va = torch.arange(l, dtype=torch.int32, device="cuda") \
            .expand(a.shape).contiguous()
        return a, b, va, va + l, flat

    a, b, va, vb, _ = kv_pairs(1, KV_N // 2)
    last = compare("merge_pairs_kv_blocks (1, 2^25) x 2",
                   lambda: mp.merge_pairs_kv_blocks(a, b, va, vb),
                   lambda: mp.rank_merge(a, b, va, vb))
    a, b, va, vb, flat = kv_pairs(KV_N // (2 * n), n)
    row("merge_pairs_kv_blocks", "src/repro_torch/csrc/merge_path.cu",
        "src/repro/kernels/merge_path.py:182",
        lambda: mp.merge_pairs_kv_blocks(a, b, va, vb),
        lambda: mp.rank_merge(a, b, va, vb),
        2 * flat.numel() * 8, flat.numel(),
        lambda: torch.sort(flat, dim=-1, stable=True), err=last)
    del a, b, va, vb, flat

    # K3: one pass of the 2^26 uint32 radix sort_kv
    keys = torch.randint(-(1 << 31), 1 << 31, (1, KV_N), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    vals = torch.arange(KV_N, dtype=torch.int32, device="cuda").view(1, -1)
    radix = 1 << digit_bits
    tiles = KV_N // radix_tile
    base = rsk.tile_bases(rsk.digit_hist_plain(keys, 0, digit_bits,
                                               radix_tile), 1)
    row("radix_digit_hist", "src/repro_torch/csrc/radix_sort.cu",
        "src/repro/kernels/radix_sort.py:123",
        lambda: (rsk.digit_hist(keys, 0, digit_bits, radix_tile),),
        lambda: (rsk.digit_hist_plain(keys, 0, digit_bits, radix_tile),),
        keys.numel() * 4 + tiles * radix * 4, keys.numel(), None)
    row("radix_digit_scatter", "src/repro_torch/csrc/radix_sort.cu",
        "src/repro/kernels/radix_sort.py:141",
        lambda: rsk.digit_scatter(keys, vals, base, 0, digit_bits,
                                  radix_tile),
        lambda: rsk.digit_scatter_plain(keys, vals, base, 0, digit_bits,
                                        radix_tile),
        2 * keys.numel() * 8 + tiles * radix * 4, keys.numel(), None)
    # the whole K3 sort (all passes + the cumsum scans) beside torch.sort
    u = keys.view(-1)
    emit({"phase": "timing", "name": "radix sort_kv_blocks 2^26 uint32",
          "ms": cuda_ms(lambda: rsk.sort_kv_blocks(keys, vals), 5)[0],
          "library_ms": cuda_ms(lambda: torch.sort(u, stable=True), 5)[0]})
    del keys, vals, base, u

    # K4: the first (all-active) pass over the 2^24 float32 row of the
    # select top-k, and a later pass under the row's 64th key as prefix;
    # torch.topk of the same row is the one library call for the function
    x = torch.randn((1, TOPK_N), generator=gen, device="cuda")
    nbits = 32
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    hist_bytes = x.numel() * 4 + 8 + radix * 4
    row("select_digit_hist", "src/repro_torch/csrc/radix_select.cu",
        "src/repro/kernels/radix_select.py:128",
        lambda: (sel.digit_hist(x, zero, nbits - digit_bits, digit_bits,
                                radix_tile, encode=True),),
        lambda: (sel.digit_hist_plain(x, zero, nbits - digit_bits,
                                      digit_bits, radix_tile, encode=True),),
        hist_bytes, x.numel(), lambda: torch.topk(x, TOPK_K))
    enc = keycodec.encode(x, descending=True)
    kth = torch.sort(enc.to(torch.int64) & 0xffffffff, dim=-1) \
        .values[:, TOPK_K - 1].contiguous()
    later = compare("select_digit_hist later pass",
                    lambda: (sel.digit_hist(x, kth, 8, digit_bits,
                                            radix_tile, encode=True),),
                    lambda: (sel.digit_hist_plain(x, kth, 8, digit_bits,
                                                  radix_tile, encode=True),))
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], later)
    emit({"phase": "timing", "name": "select_digit_hist later pass",
          "ms": cuda_ms(lambda: sel.digit_hist(x, kth, 8, digit_bits,
                                               radix_tile, encode=True),
                        10)[0]})
    # the whole select top-k (4 passes, compaction, K1 order) and the
    # cuda top-k (K5 chunks, K1 or the merge path) beside torch.topk
    for name, fn in (("select", lambda: sel.select_topk(x, TOPK_K)),
                     ("cuda", lambda: ops.bitonic_topk(x, TOPK_K))):
        emit({"phase": "timing", "name": f"topk {name} k={TOPK_K} 2^24",
              "ms": cuda_ms(fn, 5)[0],
              "library_ms": cuda_ms(lambda: torch.topk(x, TOPK_K), 5)[0]})
    del x, enc, kth
    lg = torch.randn(VOCAB, generator=gen, device="cuda")
    for name, fn in (("select", lambda: sel.select_topk(lg, 50)),
                     ("cuda", lambda: ops.bitonic_topk(lg, 50))):
        emit({"phase": "timing", "name": f"topk {name} k=50 (64, 128256)",
              "ms": cuda_ms(fn, 10)[0],
              "library_ms": cuda_ms(lambda: torch.topk(lg, 50), 10)[0]})
    del lg

    # K5: MoE routing rows, (16384, 64) float32, top-8
    r = torch.randn(ROUTER, generator=gen, device="cuda")
    n, kk = ROUTER[1], 8
    lg5 = n.bit_length() - 1
    row("bitonic_topk_blocks", "src/repro_torch/csrc/bitonic_topk.cu",
        "src/repro/kernels/bitonic_topk.py:47",
        lambda: btk.topk_blocks(r, kk), lambda: btk.topk_plain(r, kk),
        r.numel() * 4 + ROUTER[0] * kk * 8,
        ROUTER[0] * (n // 2) * lg5 * (lg5 + 1) // 2,
        lambda: torch.topk(r, kk, dim=-1))
    # and the per-chunk pass of the vocabulary top-k, (64 * 63, 2048), k=50
    c = torch.randn((VOCAB[0] * 63, 2048), generator=gen, device="cuda")
    emit({"phase": "timing", "name": "bitonic_topk_blocks (4032, 2048) k=50",
          "ms": cuda_ms(lambda: btk.topk_blocks(c, 50), 10)[0],
          "bound_ms": _bound(c.numel() * 4 + c.shape[0] * 50 * 8, 0)[0],
          "max_abs_err": max(same_bits(g, w, "K5 vocab chunks vs plain")
                             for g, w in zip(btk.topk_blocks(c, 50),
                                             btk.topk_plain(c, 50)))})
    return rows


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import tuning
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    smi = card()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    tb = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - tb,
          "dir": str(_build.BUILD_DIR.relative_to(ROOT))})

    rng = np.random.default_rng(SEED)
    tk = time.perf_counter()
    cases = phase_kernels(rng)
    emit({"phase": "kernels", "cases": cases, "bit_exact": True,
          "seconds": time.perf_counter() - tk})

    prof = tuning.active()
    tm = time.perf_counter()
    main_res = phase_main(rng)
    emit({"phase": "main", "total_launches": main_res["launches"],
          "seconds": time.perf_counter() - tm})

    tt = time.perf_counter()
    rows = phase_timing(main_res["launches"], prof.run_len, prof.radix_tile,
                        prof.digit_bits)
    emit({"phase": "timing", "seconds": time.perf_counter() - tt})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
