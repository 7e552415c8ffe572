#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build    compile every kernel (one ``nvcc`` per source, all at once)
            into ``build/kernels/``, and print what ``ptxas -v`` said of
            K7's, K3's, K1's, K2's, K4's, K5's and K6's kernels
            (registers, stack frame, spills) and K6's build warnings: no
            K7, K1, K2, K4, K5 or K6 kernel may have a stack frame or
            spills, and ptxas may not serialise K6's wgmma products.
            Then the machine code (``cuobjdump -sass``): the instructions
            of each K7 kernel's main loop by pipe, and the INT32 ALU
            instructions a pair costs (the ops of K7's bound), no K7
            kernel holding a min/max instruction;
            K6's bf16 H = 128 kernel must hold ``HGMMA`` and ``UTMALDG``
            (wgmma fed by TMA); K1's ALU instructions a compare-exchange,
            counted in the in-thread merge that closes each stage (the ops
            of K1's bound);
2. kernels  every kernel against its plain PyTorch version on the card,
            bit for bit (signed zeros, ties and dtype extremes included; K7's
            pair and stage kernels at every width, K3's onesweep histogram
            and passes for 1-, 2- and 4-byte carriers and every digit
            width; K2's partition and merges in both directions; K5's
            one-pass kernels on rows of any length, off 16-byte boundaries
            and cut into stripes of a few keys, and its network kernel);
            K6 (flash attention) within 1e-4 in float32 and 2e-2 in bf16,
            and each query's output within 2^-16 (float32) and 2^-6 (bf16)
            of the plain one's norm;
3. main     the port's entry points at the standard GPU sort benchmark's
            size (2^28 32-bit keys): sort, argsort (also stable), sort_kv,
            the radix and cuda backends and an engine top-k; then top-k
            through the select (K4) and cuda (K5) backends at the shapes of
            vocabulary sampling, MoE routing and gradient compression (each
            cuda top-k asserted as K5's launches alone: a stream and a merge
            launch, or one short-row launch), MoE
            token grouping, a ragged segment sort and a padded-row sort;
            then the paper's CAS block (``cas.run_cas``, one launch of K7's
            pair kernel over 2^24 pairs), its in-memory sorter and the imc
            backend, one launch of K7's stage kernel per network stage
            (asserted exactly), 2^22 replicated 8-input 4-bit units
            (``sort_in_memory``, 192 cycles), a (2^14, 1024) int32 sort at
            W=32 both ways, a (2^16, 256) int8 argsort through the (key,
            index) composite at W=16 both ways, and (2^12, 512) sorts of
            uint8, int16, uint16 and uint32.
            Each sort is held bit-exactly against ``torch.sort(stable=True)``
            (ties keep ascending index in both directions; the select
            backend's top-k on the IEEE total order, +0.0 above -0.0).
            Each call runs once with the launch counts set to 0 just before
            and read just after, then is timed with CUDA events over a few
            more calls; each K3 sort in it must be one onesweep histogram and
            one pass a digit (1 + 4 launches for 32-bit keys), and no
            retired kernel may run.  A ``torch.profiler`` trace of one
            2^26 argsort each way says where each one's time goes
            (kernels and aten ops by device ms); neither may run a flip
            (K2 merges descending runs with a descending comparator); a
            trace of one select top-k of the sampling rows splits it
            between K4 and the compaction;
4. relational
            the relational tier (``repro_torch.relational``) at TPC-H SF10's
            sizes (15 M orders, ~60 M line items from dbgen's key and value
            ranges, seeded): unique, Q18's group_by over l_quantity (sum,
            count, min, max, mean), a group_by of l_extendedprice (sum,
            mean), the join l_orderkey = o_orderkey, RLE and delta of
            o_orderkey with their round trips, a 64-bin histogram and three
            quantiles of l_extendedprice, group_ranks of MoE dispatch rows
            (8, 16384) over 64 experts (one-hot) and of 2^24 ids over 4096
            groups (sort path).  Each op runs ``method="auto"`` once with the
            counts set to 0 just before and read just after (the kernels of
            its plan must run: K3 on the radix route; K4 once a digit pass
            for the quantiles, their survivors ordered by K1 and K2), is
            held bit for bit against the same call on ``method="torch"``
            (``torch.sort``, no kernel may run) and by an independent check
            (``torch.unique``'s values and counts, int64 sums, float sums
            within c x 2^-24 of float64, every line item joined to its one
            order, the round trips; the sketches against ``torch.sort`` and
            ``torch.bucketize``), then is timed twice (CUDA-event and host
            ms, beside the one PyTorch call that computes the same where
            there is one);
5. serve    minitron-4b at full width and depth (32 layers, d=3072, 4.2 B
            parameters in bf16, random weights from a seeded generator)
            through ``repro_torch.launch.serve.serve`` with the prefill's
            attention on K6: 16 requests in batches of 8, prompts up to
            1023 tokens, 32 tokens each by top-k (k=50) sampling.  The
            counts are set to 0 just before and read just after: K6 must
            launch once a layer and prefill batch.  Then the same batches'
            prefill logits with K6 against the einsum attention (within
            0.2, the argmax equal on most rows, the served first tokens
            replayed; a float32 einsum prefill as the control of what bf16
            alone moves), and K6 against its plain version at each served
            batch's shape; the ``[serve] length accounting`` groups against
            a numpy count of the prompt lengths;
6. timing   each kernel at the main path's shapes: its output held against
            its plain version on the same inputs (the ``max_abs_err`` of the
            kernel table; bit for bit but for K6, which is held to the
            limits of phase 2), then CUDA-event times of both beside
            ``torch.sort`` (``torch.topk`` for K4 and K5; ``torch.minimum`` +
            ``torch.maximum`` for K7's pair kernel; nothing for K3's
            histogram and pass or K7's stage kernel, which no one call
            computes; ``scaled_dot_product_attention`` for K6) on the same
            rows; K2 (its partition and merge launches together) at the
            first and the last merge level of the 2^28 float32 sort and of
            the 2^26 int32 argsort, both ways, and its partition launch
            alone; K4's first and a later pass; K3's whole 2^26 sort beside
            ``torch.sort`` and its bound, its launches counted on one
            call; K5's short-row kernel at the MoE routing rows, its stream
            kernel (with its merge launch) at the vocabulary, sampling and
            2^24 rows, each also ascending (every key admitted), its merge
            launch alone, the serve's sampling rows through radix, cuda and
            ``torch.topk``, and its network kernel (k > 256) as before.

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
IMC_UNITS = 1 << 22       # replicated paper units: 8 inputs, 4-bit words
IMC_WIDE = (1 << 14, 1024)    # int32 rows of the W=32 imc sort
IMC_ARG = (1 << 16, 256)      # int8 rows of the composite imc argsort
IMC_DTYPES_SHAPE = (1 << 12, 512)
CAS_PAIRS = 1 << 26       # K7 extra timing: pairs of one launch
CAS_PLAIN_PAIRS = 1 << 24      # ... compared with the plain version here
SERVE = dict(n_requests=16, batch_size=8, decode_steps=32, topk=50,
             max_len=4096)        # prompts of 4 to 1023 tokens
ATTN_SHAPES = ((8, 1024), (1, 32768))    # (B, S) of K6's rows: the serve's
ATTN_HEADS = (24, 8, 128)                # prefill batch and prefill_32k
K6_TOL = {"float32": 1e-4, "bfloat16": 2e-2}    # max |kernel - plain|
# ... and the largest |kernel - plain|_2 / |plain|_2 over query rows: an
# absolute limit is loose where outputs are small (a row that sees n keys
# of randn values is ~n^-1/2), so K6 is also held to its values.  bf16:
# rounding P and the output gives ~2^-8, a 64-key tile dropped at n = 32K
# ~2^-4.5; float32: FMA order and expf, ~2^-20
K6_ROW_REL = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -6}
PREFILL_LOGITS_TOL = 0.2     # max |flash - einsum| of the served prefill

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# H100 SXM INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
# the card's head start a timed call (~0.2 ms at 1.98 GHz) in the kernel
# timings: more than a wrapper's host time, so the queue never runs dry
LEAD_CYCLES_PER_CALL = 400_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warm: bool = True, lead: bool = False):
    """(mean ms of ``fn`` over ``reps`` calls, timed with CUDA events, and
    the output of the warm-up call that precedes them, if ``warm``).  With
    ``lead`` the card first sleeps while the host queues the calls, so a
    call shorter than its Python wrapper is timed at the card's rate, not
    the host's."""
    import torch
    out = fn() if warm else None
    torch.cuda.synchronize()
    if lead:
        torch.cuda._sleep(LEAD_CYCLES_PER_CALL * reps)
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
    import numpy as np
    import torch
    from repro_torch.core import keycodec, network
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import bitonic_topk as btk
    from repro_torch.kernels import bitserial_cas as bsc
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import ops
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

    # K2: runs sharing duplicates, strided pair views as the merge tree,
    # both directions: the partition's cuts, then both merges
    for dtype in dtypes:
        for rows, l in ((500, 1), (64, 3), (32, 1000), (8, 4096),
                        (3, 12293), (1, 1 << 20)):
            raw = _keys(rng, (rows, 2, l), dtype)
            va = torch.arange(l, dtype=torch.int32, device="cuda") \
                .expand(rows, l).contiguous()
            vb = va + l
            for desc in (False, True):
                pairs = keycodec.from_signed(torch.sort(
                    keycodec.to_signed(raw), dim=-1, descending=desc)
                    .values.contiguous(), dtype)
                a, b = pairs[:, 0, :], pairs[:, 1, :]
                what = f"{dtype} {rows}x{l} desc={desc}"
                same_bits(mp.merge_path_partition(a, b, descending=desc),
                          mp.partition_plain(a, b, descending=desc),
                          f"K2 partition {what}")
                same_bits(mp.merge_pairs_blocks(a, b, descending=desc),
                          mp.rank_merge(a, b, descending=desc)[0],
                          f"K2 {what}")
                k1, v1 = mp.merge_pairs_kv_blocks(a, b, va, vb,
                                                  descending=desc)
                k2, v2 = mp.rank_merge(a, b, va, vb, descending=desc)
                same_bits(k1, k2, f"K2 kv keys {what}")
                same_bits(v1, v2, f"K2 kv vals {what}")
                cases += 4

    # K3: the onesweep histogram, every pass, then the whole kv sort (one
    # look-back scratch for all its passes) against the plain pass loop,
    # 1-, 2- and 4-byte carriers, every digit width the wrappers take, rows
    # that end in a partial tile
    for carrier in (torch.int8, torch.int16, torch.int32):
        nbits = carrier.itemsize * 8
        for rows, m, db in ((3, 4096, 8), (2, 1 << 16, 8), (4, 3000, 4),
                            (1, 1 << 20, 8), (2, 70001, 2), (2, 9000, 1)):
            raw = rng.integers(0, 1 << nbits, size=(rows, m))
            raw[:, 1::2] = raw[:, 0::2][:, :raw[:, 1::2].shape[1]]
            keys = torch.from_numpy(raw.astype(f"uint{nbits}")
                                    .view(f"int{nbits}")).cuda()
            vals = torch.arange(m, dtype=torch.int32, device="cuda") \
                .expand(rows, m).contiguous()
            what = f"{carrier} {rows}x{m} db={db}"
            hist = rsk.onesweep_hist(keys, db)
            same_bits(hist, rsk.onesweep_hist_plain(keys, db),
                      f"K3 onesweep hist {what}")
            k1, v1 = keys, vals
            for shift in range(0, nbits, db):
                k2, v2 = rsk.onesweep_pass_plain(k1, v1, hist, shift, db)
                k1, v1 = rsk.onesweep_pass(k1, v1, hist, shift, db)
                same_bits(k1, k2, f"K3 onesweep pass keys {what} s{shift}")
                same_bits(v1, v2, f"K3 onesweep pass vals {what} s{shift}")
                cases += 2
            sk1, sv1 = rsk.sort_kv_blocks(keys, vals, digit_bits=db)
            pk, pv = rsk.onesweep_sort_kv_plain(keys, vals, db)
            same_bits(sk1, pk, f"K3 sort keys {what}")
            same_bits(sv1, pv, f"K3 sort vals {what}")
            cases += 3

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
    # signed zeros; the one-pass kernels (k <= 256) also on rows of any
    # length, one element off a 16-byte boundary, and cut into stripes of a
    # few keys (ties across every stripe and CTA)
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
                if k <= min(n, btk.MAX_K):
                    v1, i1 = btk.topk_rows(x, k)
                    v2, i2 = btk.topk_rows_plain(x, k)
                    same_bits(v1, v2, f"K5 rows values {dtype} n={n} k={k}")
                    same_bits(i1, i2, f"K5 rows indices {dtype} n={n} k={k}")
                    cases += 2
        x = _keys(rng, (9, 3001), dtype)
        odd = torch.cat([x.view(-1)[:1], x.view(-1)])[1:].view(x.shape)
        for plan in (None, btk.RowPlan("stream"),
                     btk.RowPlan("stream", warps_per_row=8, ctas=3,
                                 stripe=127)):
            for t in (x, odd):
                for k in (16, 256):
                    v1, i1 = btk.topk_rows(t, k, plan)
                    v2, i2 = btk.topk_rows_plain(t, k, plan)
                    same_bits(v1, v2, f"K5 rows {dtype} {plan} k={k}")
                    same_bits(i1, i2, f"K5 rows {dtype} {plan} k={k}")
                    cases += 2

    # K7: every width, random pairs with equal operands, 0, 2^W - 1 and
    # the top bit (bit 31 at W = 32), lengths off the 16-byte vectors; then
    # the stage kernel over every stage of rows of 2 to 16384 words; its
    # own generator, so the inputs of the phases above and below stay as
    # they were
    krng = np.random.default_rng([SEED, 7])
    for width in bsc.WIDTHS:
        for n in (1, 127, 4096, 1000003):
            a, b = cas_words(krng, n, width)
            lo, hi = ops.bitserial_cas(a, b, width=width)
            plo, phi = bsc.exec_program_plain(a, b, width)
            same_bits(lo, plo, f"K7 min W={width} n={n}")
            same_bits(hi, phi, f"K7 max W={width} n={n}")
            cases += 2
        for batch, n in ((300, 2), (64, 8), (16, 256), (2, 1 << 14)):
            a, b = cas_words(krng, batch * n // 2, width)
            v = torch.cat([a, b]).view(batch, n).contiguous()
            for k, j in network.stage_schedule(n):
                want = bsc.stage_plain(v, k, j, width)
                same_bits(bsc.cas_stages(v, [(k, j)], width), want,
                          f"K7 stage ({k}, {j}) W={width} {batch}x{n}")
                cases += 1

    cases += check_k6()
    torch.cuda.synchronize()
    return cases


def check_k6() -> int:
    """K6 against its plain version: float32 and bf16, G = 1 and 3
    (minitron's), causal with and without a window, non-causal, an
    absolute offset past T's start, and lengths off the 128-row blocks; its
    own generator, as K7's.  Emits the largest errors; returns the number
    of cases."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases, worst = 0, {}
    for name in K6_TOL:
        for g in (1, 3):
            for s, t, off, causal, window in (
                    (1000, 1000, 0, True, 0), (1000, 1000, 0, True, 256),
                    (77, 77, 0, True, 0), (300, 1300, 1000, True, 0),
                    (300, 1300, 1000, True, 100), (200, 333, 0, False, 0)):
                q, k, v = attn_rows(gen, 4, g, s, t, 128, getattr(torch, name))
                errs = attn_within(
                    fa.flash_rows(q, k, v, off, causal=causal, window=window),
                    fa.flash_rows_plain(q, k, v, off, causal=causal,
                                        window=window),
                    f"K6 {name} g={g} s={s} t={t} off={off} "
                    f"causal={causal} window={window}")
                worst[name] = [max(a, b) for a, b in
                               zip(worst.get(name, (0.0, 0.0)), errs)]
                cases += 1
    emit({"phase": "kernels", "k6_max_abs_err_and_row_rel_err": worst,
          "limits": [K6_TOL, K6_ROW_REL]})
    return cases


def attn_rows(gen, rk, g, s, t, h, dtype):
    """K6's rows on the card: q (rk * g, s, h), k and v (rk, t, h)."""
    import torch
    q = torch.randn((rk * g, s, h), generator=gen, device="cuda")
    k = torch.randn((rk, t, h), generator=gen, device="cuda")
    v = torch.randn((rk, t, h), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def attn_within(x, y, what: str):
    """K6 against its plain version: ``within`` at ``K6_TOL``, and the
    largest |x - y|_2 / |y|_2 over the last axis (one query's output) at
    most ``K6_ROW_REL``; returns (max |x - y|, that ratio)."""
    name = str(y.dtype).removeprefix("torch.")
    err = within(x, y, K6_TOL[name], what)
    if not x.numel():
        return err, 0.0
    y32 = y.float()
    rel = ((x.float() - y32).norm(dim=-1)
           / y32.norm(dim=-1).clamp(min=1e-30)).max().item()
    if rel > K6_ROW_REL[name]:
        raise AssertionError(f"{what}: max row |diff|/|plain| {rel} > "
                             f"{K6_ROW_REL[name]}")
    return err, rel


def within(x, y, tol: float, what: str) -> float:
    """Fail unless x and y have one shape and dtype, are finite and differ
    by at most ``tol``; return max |x - y|."""
    import torch
    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{what}: {tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(y.shape)} {y.dtype}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (x.float() - y.float()).abs().max().item() if x.numel() else 0.0
    if err > tol:
        raise AssertionError(f"{what}: max |diff| {err} > {tol}")
    return err


def cas_words(rng, n, width):
    """Two int32 tensors on the card of W-bit words: random, with equal
    pairs, 0, 2^W - 1 and the top bit set mixed in."""
    import numpy as np
    import torch
    w = rng.integers(0, 1 << width, size=(2, n), dtype=np.uint64)
    w[1, ::5] = w[0, ::5]
    w[0, 1::13] = 0
    w[1, 2::13] = (1 << width) - 1
    w[:, 3::13] |= 1 << (width - 1)
    return tuple(torch.from_numpy(r.astype(np.uint32).view(np.int32)).cuda()
                 for r in w)


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


K3 = ("radix_onesweep_hist", "radix_onesweep_pass")
# K2: a merge is a partition launch and a merge launch
K2 = ("merge_path_partition", "merge_pairs_blocks")
K2_KV = ("merge_path_partition", "merge_pairs_kv_blocks")
# kernels that left the port: no path may reach them
RETIRED = ("radix_digit_hist", "radix_digit_scatter")


def check_k3_sorts(name, counts, passes) -> None:
    """Fail if a retired kernel ran, or, where ``passes`` is given, unless
    the K3 launches are one onesweep histogram and ``passes`` passes a
    sort, at least one sort."""
    gone = [k for k in RETIRED if counts.get(k, 0)]
    if gone:
        raise AssertionError(f"{name}: retired kernels launched: {gone}")
    if passes is None:
        return
    hist = counts.get("radix_onesweep_hist", 0)
    if hist == 0 or counts.get("radix_onesweep_pass", 0) != passes * hist:
        raise AssertionError(f"{name}: K3 launches {counts}, expected 1 "
                             f"histogram and {passes} passes a sort")


def trace_summary(fn, top: int = 8) -> dict:
    """One warm call of ``fn`` under ``torch.profiler``: the card's busy
    ms (the kernels' own times summed), the kernels and the aten ops that
    took most of it, ms each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    kernels, ops = [], []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", 0) / 1e3
        total = getattr(e, "device_time_total", 0) / 1e3
        if (own > 0 and e.device_type == DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")):
            kernels.append((e.key[:80], e.count, own))
        if e.key.startswith("aten::") and total > 0:
            ops.append((e.key, e.count, total))
    kernels.sort(key=lambda x: -x[2])
    ops.sort(key=lambda x: -x[2])
    return {"device_ms": sum(x[2] for x in kernels),
            "kernels_ms": kernels[:top], "aten_ops_ms": ops[:top],
            "flips": sum(x[1] for x in kernels + ops if "flip" in x[0])}


def phase_main(rng) -> dict:
    import numpy as np
    import torch
    import repro_torch.sort as rsort
    from repro_torch import engine
    from repro_torch.core import keycodec
    from repro_torch.kernels import _build

    launches: dict = {}
    steps = []

    def run(name, fn, must, reps=3, exact=None, library=None,
            k3_passes=None):
        """One counted call (counts set to 0 just before, read just after),
        then ``reps`` more timed with CUDA events, the first as warm-up.
        ``exact``, if given, is the whole launch count the call must make;
        ``k3_passes``, if given, the digit passes of each of its K3 sorts
        (one onesweep histogram and that many passes a sort); ``library``,
        a PyTorch call on the same rows, is timed beside."""
        _build.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        missing = [k for k in must if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing} "
                                 f"(counts {counts})")
        if exact is not None and counts != exact:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{exact}")
        check_k3_sorts(name, counts, k3_passes)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ms = cuda_ms(fn, reps, warm=False)[0]
        step = {"step": name, "ms": ms, "launches": counts}
        if library is not None:
            step["library_ms"] = cuda_ms(library, reps)[0]
        steps.append(step)
        emit({"phase": "main", **step, "reps": reps})
        return out

    # 2^28 float32 through the merge engine: K1 runs + K2 merge tree
    x = torch.from_numpy(rng.standard_normal(MAIN_N, dtype=np.float32)).cuda()
    plan = engine.choose(MAIN_N, 1, torch.float32, device="cuda")
    emit({"phase": "main", "auto_plan_2^28_float32": plan.method,
          "run_method": plan.run_method, "merge_backend": plan.merge_backend,
          "run_len": plan.run_len, "costs_ns": plan.costs})
    out = run("sort merge 2^28 float32",
              lambda: rsort.sort(x, method="merge"),
              ("bitonic_sort_blocks",) + K2)
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
                    ("bitonic_sort_kv_blocks",) + K2_KV)
        same_bits(order, ref_i, f"argsort desc={desc}")
        sk, sv = run(f"sort_kv merge 2^26 int32 desc={desc}",
                     lambda: rsort.sort_kv(k, payload, method="merge",
                                           descending=desc),
                     ("bitonic_sort_kv_blocks",) + K2_KV)
        same_bits(sk, ref_k, f"sort_kv keys desc={desc}")
        same_bits(sv, ref_i, f"sort_kv payload desc={desc}")
        # a stable merge sort: K3 (stable) sorts the runs in K1's place
        order = run(f"argsort stable merge 2^26 int32 desc={desc}",
                    lambda: rsort.argsort(k, method="merge", stable=True,
                                          descending=desc),
                    K3 + K2_KV, k3_passes=4)
        same_bits(order, ref_i, f"stable argsort desc={desc}")
    # where an argsort's time goes: a profiler trace of one call each way;
    # the merge tree merges descending runs with K2's descending
    # comparator, so neither way may flip a run
    traces = {f"desc={desc}": trace_summary(
        lambda: rsort.argsort(k, method="merge", descending=desc))
        for desc in (False, True)}
    emit({"phase": "main", "trace": "argsort merge 2^26 int32", **traces})
    flipped = {d: s["flips"] for d, s in traces.items() if s["flips"]}
    if flipped:
        raise AssertionError(f"argsort merge 2^26: flip kernels or aten "
                             f"ops in the trace: {flipped}")
    del k, order, sk, sv, ref_k, ref_i

    # 2^26 uint32 through the radix backend (K3)
    u = torch.from_numpy(rng.integers(0, 1 << 32, KV_N, dtype=np.uint32)
                         .view(np.int32)).cuda().view(torch.uint32)
    sk, sv = run("sort_kv radix 2^26 uint32",
                 lambda: rsort.sort_kv(u, payload, method="radix"), K3,
                 exact={"radix_onesweep_hist": 1, "radix_onesweep_pass": 4},
                 library=lambda: torch.sort(u.view(torch.int32) ^ -(1 << 31),
                                            stable=True))
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
               ("bitonic_sort_kv_blocks",) + K2_KV)
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
    # where a select top-k's time goes: K4's passes against the
    # compaction's PyTorch ops and K1's ordering
    emit({"phase": "main", "trace": "topk select k=50 (64, 128256)",
          **trace_summary(lambda: rsort.topk(logits, 50, method="select"))})
    # K5's one pass: a stream launch and a merge launch, nothing else
    k5 = {"topk_rows_stream": 1, "topk_rows_merge": 1}
    v_i = run("topk cuda k=50 (64, 128256) float32",
              lambda: rsort.topk(logits, 50, method="cuda"), tuple(k5),
              exact=k5)
    check_topk("topk cuda vocab", logits, 50, "cuda", v_i)
    # padded vocabulary: the last 128 lanes masked to -inf, and row 0
    # masked down to 10 finite lanes, fewer than k (the reference's top-k
    # returned index -1 there)
    masked = logits.clone()
    masked[:, -128:] = float("-inf")
    masked[0, 10:] = float("-inf")
    for method, must, exact in (("cuda", tuple(k5), k5),
                                ("select", sel_k, None)):
        v_i = run(f"topk {method} k=50 (64, 128256) float32 -inf masked",
                  lambda: rsort.topk(masked, 50, method=method), must,
                  exact=exact)
        check_topk(f"topk {method} masked", masked, 50, method, v_i)
        if int(v_i[1].min()) < 0:
            raise AssertionError(f"topk {method}: negative index")
    del logits, masked

    router = torch.from_numpy(rng.standard_normal(ROUTER, dtype=np.float32)
                              ).cuda()
    v_i = run("topk cuda k=8 (16384, 64) float32",
              lambda: rsort.topk(router, 8, method="cuda"),
              ("topk_rows_short",), exact={"topk_rows_short": 1})
    check_topk("topk cuda router", router, 8, "cuda", v_i)
    del router

    # gradient compression: the top 1% of |g| (grad_compress.topk_budget)
    g = torch.from_numpy(rng.standard_normal(GRAD_N, dtype=np.float32)
                         ).cuda().abs()
    gk = GRAD_N // 100
    v_i = run(f"topk select k={gk} |g| of 2^26 float32",
              lambda: rsort.topk(g, gk, method="select"),
              ("select_digit_hist", "bitonic_sort_kv_blocks") + K2_KV)
    check_topk("topk select grad", g, gk, "select", v_i)
    del g, v_i

    # MoE dispatch: 16384 tokens x top-8 expert ids, a stable grouping
    ids = torch.from_numpy(rng.integers(0, 64, ROUTER[0] * 8)
                           .astype(np.int32)).cuda()
    p = engine.choose(ids.numel(), 1, torch.int32, device="cuda")
    emit({"phase": "main", "auto_plan_group_tokens": p.method})
    perm, splits = run("group_tokens_by_expert 131072 ids, 64 experts",
                       lambda: engine.group_tokens_by_expert(ids, 64),
                       K3, k3_passes=4)
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
                 K3, k3_passes=4)
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
              K3, k3_passes=4)
    valid = torch.arange(VOCAB[1], device="cuda")[None, :] < lengths[:, None]
    want = torch.sort(torch.where(valid, b, float("inf")), dim=-1,
                      stable=True).values
    same_bits(out, torch.where(valid, want, -1.0), "valid_lengths sort")
    del b, lengths, out, valid, want

    phase_imc(rng, run)
    torch.cuda.synchronize()
    return {"launches": launches, "steps": steps}


def phase_imc(rng, run) -> None:
    """The paper's CAS block (K7's pair kernel), in-memory sorter and the
    imc backend: every compare-and-swap stage of the network one launch of
    K7's stage kernel, asserted; no ``torch.sort`` inside a step (it only
    checks the results after)."""
    import numpy as np
    import torch
    import repro_torch.sort as rsort
    from repro_torch.core import cas, cost_model, keycodec, network, sorter
    from repro_torch.core.sortspec import next_pow2

    k7 = ("bitserial_cas_stage",)

    def stages(n):
        return {"bitserial_cas_stage": network.n_stages(n)}

    # the paper's CAS block itself: 2^24 pairs of 4-bit words through
    # ``cas.run_cas``, one launch of the pair kernel
    a = torch.from_numpy(rng.integers(0, 16, IMC_UNITS * 4)
                         .astype(np.int32)).cuda()
    b = torch.from_numpy(rng.integers(0, 16, IMC_UNITS * 4)
                         .astype(np.int32)).cuda()
    res = run(f"run_cas {IMC_UNITS * 4} pairs W=4 (CAS block)",
              lambda: cas.run_cas(a, b, width=4), ("bitserial_cas",),
              exact={"bitserial_cas": 1},
              library=lambda: (torch.minimum(a, b), torch.maximum(a, b)))
    same_bits(res.lo, torch.minimum(a, b), "run_cas min")
    same_bits(res.hi, torch.maximum(a, b), "run_cas max")
    if res.cycles != 28:
        raise AssertionError(f"run_cas: {res.cycles} cycles, not 28")
    del a, b, res

    # the paper's unit (N=8, W=4), replicated: 2^22 independent units,
    # six K7 launches of 2^24 compare-and-swaps each
    units = torch.from_numpy(rng.integers(0, 16, (IMC_UNITS, 8))
                             .astype(np.int32)).cuda()
    res = run(f"sort_in_memory {IMC_UNITS}x8 W=4 (paper unit)",
              lambda: sorter.sort_in_memory(units, width=4), k7,
              exact=stages(8),
              library=lambda: torch.sort(units, dim=-1))
    same_bits(res.values, torch.sort(units, dim=-1).values, "paper units")
    claims = cost_model.validate_claims()
    if res.cycles != 192 or not claims.all_pass():
        raise AssertionError(f"paper unit: cycles {res.cycles}, claims "
                             f"{[r for r in claims.rows]}")
    emit({"phase": "main", "paper_unit_cycles": res.cycles,
          "compute_cycles": res.compute_cycles,
          "movement_cycles": res.movement_cycles,
          "validate_claims": claims.all_pass()})
    del units, res

    # full-width keys: int32 rows at W = 32, 55 stages of 2^23 pairs
    rows, n = IMC_WIDE
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, IMC_WIDE)
                         .astype(np.int32)).cuda()
    for desc in (False, True):
        out = run(f"sort imc {rows}x{n} int32 W=32 desc={desc}",
                  lambda: rsort.sort(x, method="imc", descending=desc), k7,
                  exact=stages(n),
                  library=lambda: torch.sort(x, dim=-1, descending=desc))
        same_bits(out, torch.sort(x, dim=-1, descending=desc).values,
                  f"imc int32 desc={desc}")
    del x, out

    # argsort through the (key, index) composite: int8 rows of heavy
    # duplicates at n=256, 8 + 8 bits -> W = 16
    rows, n = IMC_ARG
    x = torch.from_numpy(rng.integers(-8, 8, IMC_ARG).astype(np.int8)).cuda()
    width = next_pow2(keycodec.key_bits(x.dtype)
                      + keycodec.composite_index_bits(n))
    for desc in (False, True):
        order = run(f"argsort imc {rows}x{n} int8 W={width} desc={desc}",
                    lambda: rsort.argsort(x, method="imc", descending=desc),
                    k7, exact=stages(n),
                    library=lambda: torch.sort(x, dim=-1, stable=True,
                                               descending=desc))
        same_bits(order, torch.sort(x, dim=-1, stable=True, descending=desc)
                  .indices.to(torch.int32), f"imc argsort desc={desc}")
    del x, order

    # the other key types at their own widths (8, 16, 16, 32)
    rows, n = IMC_DTYPES_SHAPE
    for name in ("uint8", "int16", "uint16", "uint32"):
        info = np.iinfo(name)
        raw = rng.integers(info.min, int(info.max) + 1, IMC_DTYPES_SHAPE,
                           dtype=np.int64)
        raw[:, 0], raw[:, 1] = info.min, info.max
        x = torch.from_numpy(raw.astype(name).view(f"int{info.bits}")).cuda() \
            .view(getattr(torch, name))
        xs = keycodec.to_signed(x)
        out = run(f"sort imc {rows}x{n} {name} W={info.bits}",
                  lambda: rsort.sort(x, method="imc"), k7, exact=stages(n),
                  library=lambda: torch.sort(xs, dim=-1))
        same_bits(out, keycodec.from_signed(torch.sort(xs, dim=-1).values,
                                            x.dtype), f"imc {name}")
    del x, xs, out


# ---------------------------------------------------------------------------
# phase 4: serving minitron-4b at full width
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 4: the relational tier at TPC-H SF10
# ---------------------------------------------------------------------------

TPCH_ORDERS = 15_000_000      # SF10 orders (TPC-H 4.2.3: SF x 1,500,000)
MOE_IDS = (8, 16384)          # MoE dispatch rows (B, S*k): 16384 tokens
MOE_EXPERTS = 64              # x top-8 of OLMoE's 64 experts
FLAT_IDS = (1 << 24, 4096)    # group_ranks sort path: ids, groups
REL_QS = (0.01, 0.5, 0.99)
REL_BINS = 64


def tpch_columns(rng):
    """TPC-H SF10's join and aggregate keys, as dbgen makes them, on the
    card: ``o_orderkey`` the first 8 of every 32 key values (15 M, in
    dbgen's order), ``l_orderkey`` each order 1-7 times, shuffled;
    ``l_quantity`` 1-50, ``l_extendedprice`` quantity x a retail price of
    900.00-2099.00 (dbgen's ``p_retailprice`` range), float32."""
    import numpy as np
    import torch
    i = np.arange(TPCH_ORDERS, dtype=np.int64)
    orders = (32 * (i // 8) + i % 8 + 1).astype(np.int32)
    lines = np.repeat(orders, rng.integers(1, 8, TPCH_ORDERS))
    rng.shuffle(lines)
    qty = rng.integers(1, 51, lines.size).astype(np.int32)
    price = (qty * rng.integers(90000, 209901, lines.size) / 100
             ).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda()
                 for a in (orders, lines, qty, price))


def planned_kernels(op, method) -> tuple:
    """The kernels a sort-backed relational op's plan must launch on the
    card: K3 for the radix route and for the stable sorts of group_by and
    join on any kernel route (their merge fallback sorts runs on K3, merges
    on K2), K1 runs + K2 merges on the merge route, K1 on cuda."""
    stable = op in ("group_by", "join", "group_ranks")
    if method == "radix":
        return K3
    if method == "torch":
        return ()
    if stable or method == "merge":
        runs = K3 if stable else ("bitonic_sort_blocks",)
        return runs + ("merge_path_partition",)
    return ("bitonic_sort_kv_blocks",)


def phase_relational(rng) -> dict:
    """Every relational op through ``method="auto"`` at TPC-H SF10 (15 M
    orders, ~60 M line items), each held bit for bit against the same call
    on ``method="torch"`` (``torch.sort``, no kernel) and by an independent
    check; the sketches against ``torch.sort``-based oracles.  Each op runs
    once with the launch counts set to 0 just before and read just after
    (its plan's kernels must run), then twice more timed.  Returns the
    launches."""
    import numpy as np
    import torch
    import repro_torch.relational as rel
    from repro_torch import engine
    from repro_torch.core import tuning
    from repro_torch.engine import planner
    from repro_torch.kernels import _build

    launches: dict = {}

    def run(name, fn, must, *, plan=None, k3_passes=None, exact=None,
            library=None, reps=2, **info):
        """One counted call, then ``reps`` timed calls: CUDA-event ms on
        the stream and host ms around each call (its syncs included).
        ``exact`` maps kernels to the launches the call must make."""
        _build.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        missing = [k for k in must if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing} "
                                 f"(counts {counts})")
        wrong = {k: counts.get(k, 0) for k, v in (exact or {}).items()
                 if counts.get(k, 0) != v}
        if wrong:
            raise AssertionError(f"{name}: launches {wrong}, expected "
                                 f"{exact}")
        check_k3_sorts(name, counts, k3_passes)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        line = {"phase": "relational", "op": name,
                "plan": None if plan is None else plan.method,
                "costs_ns": None if plan is None else plan.costs,
                "ms": start.elapsed_time(end) / reps,
                "host_ms": (time.perf_counter() - t0) * 1e3 / reps,
                "launches": counts, **info}
        if library is not None:
            line["library"] = library[0]
            line["library_ms"] = cuda_ms(library[1], reps)[0]
        emit(line)
        return out

    def torch_route(name, fn):
        """The same call on ``torch.sort``: no kernel may run."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if _build.launches:
            raise AssertionError(f"{name} method=torch launched "
                                 f"{dict(_build.launches)}")
        ms = cuda_ms(fn, 2, warm=False)[0]
        emit({"phase": "relational", "op": name, "route": "torch",
              "ms": ms})
        return out

    def same(got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(g, tuple):
                same(g, w, f"{what}[{i}]")
            elif g is not None or w is not None:
                same_bits(g, w, f"{what} field {i}")

    def plan_of(op, n):
        return planner.choose_relational_cached(op, n, dtype=torch.int32,
                                                device="cuda")

    orders, lines, qty, price = tpch_columns(rng)
    n = lines.numel()
    emit({"phase": "relational", "tpch": "SF10", "orders": TPCH_ORDERS,
          "lineitems": n, "nvidia_smi": card()})

    # unique: l_orderkey's distinct orders and their line counts
    p = plan_of("unique", n)
    u = run("unique l_orderkey", lambda: rel.unique(
        lines, return_counts=True), planned_kernels("unique", p.method),
        plan=p, k3_passes=4 if p.method == "radix" else None,
        library=("torch.unique(return_counts=True)",
                 lambda: torch.unique(lines, return_counts=True)))
    same(u, torch_route("unique l_orderkey", lambda: rel.unique(
        lines, return_counts=True, method="torch")), "unique")
    tv, tc = torch.unique(lines, return_counts=True)
    if int(u.n_unique) != TPCH_ORDERS:
        raise AssertionError(f"unique: {int(u.n_unique)} orders")
    same_bits(u.values[:TPCH_ORDERS], tv, "unique values vs torch.unique")
    same_bits(u.counts[:TPCH_ORDERS], tc.to(torch.int32),
              "unique counts vs torch.unique")
    del u

    # group_by: Q18's inner aggregate over l_quantity, and the revenue sums
    inverse = torch.unique(lines, return_inverse=True)[1]
    p = plan_of("group_by", n)
    aggs = ("sum", "count", "min", "max", "mean")
    g = run("group_by l_orderkey, l_quantity", lambda: rel.group_by(
        lines, qty, agg=aggs), planned_kernels("group_by", p.method),
        plan=p, k3_passes=4 if p.method == "radix" else None, agg=aggs)
    same(g, torch_route("group_by l_orderkey, l_quantity",
                        lambda: rel.group_by(lines, qty, agg=aggs,
                                             method="torch")), "group_by q")
    s64 = torch.zeros(TPCH_ORDERS, dtype=torch.int64, device="cuda") \
        .index_add_(0, inverse, qty.to(torch.int64))
    same_bits(g.aggregates[0][:TPCH_ORDERS].to(torch.int64), s64,
              "l_quantity sums vs int64")
    same_bits(g.aggregates[1][:TPCH_ORDERS], tc.to(torch.int32),
              "group counts vs torch.unique")
    del g
    g = run("group_by l_orderkey, l_extendedprice", lambda: rel.group_by(
        lines, price, agg=("sum", "mean")),
        planned_kernels("group_by", p.method), plan=p,
        k3_passes=4 if p.method == "radix" else None, agg=("sum", "mean"))
    same(g, torch_route("group_by l_orderkey, l_extendedprice",
                        lambda: rel.group_by(lines, price,
                                             agg=("sum", "mean"),
                                             method="torch")), "group_by p")
    f64 = torch.zeros(TPCH_ORDERS, dtype=torch.float64, device="cuda") \
        .index_add_(0, inverse, price.to(torch.float64))
    cnt = tc.to(torch.float64)
    # float32 sums of c positive terms: |error| <= c * 2^-24 * sum; the
    # mean adds one more rounding
    sum_err = ((g.aggregates[0][:TPCH_ORDERS].double() - f64).abs()
               / (cnt * f64 * 2.0 ** -24)).max().item()
    mean_err = ((g.aggregates[1][:TPCH_ORDERS].double() - f64 / cnt).abs()
                / ((cnt + 1) * (f64 / cnt) * 2.0 ** -24)).max().item()
    emit({"phase": "relational", "check": "float sums vs float64",
          "max_err_over_limit": {"sum": sum_err, "mean": mean_err}})
    if not (sum_err <= 1.0 and mean_err <= 1.0):
        raise AssertionError(f"group_by float sums: {sum_err}, {mean_err} "
                             f"of the c x 2^-24 limit")
    del g, f64, cnt, s64, inverse

    # join: every line item finds its one order
    p = plan_of("join", n)
    j = run("join l_orderkey = o_orderkey", lambda: rel.join(
        lines, orders, size=n), planned_kernels("join", p.method), plan=p,
        k3_passes=4 if p.method == "radix" else None)
    same(j, torch_route("join l_orderkey = o_orderkey", lambda: rel.join(
        lines, orders, size=n, method="torch")), "join")
    left, right = j.left_idx.long(), j.right_idx.long()
    if int(j.n_pairs) != n or not bool((lines[left] == orders[right]).all()):
        raise AssertionError(f"join: {int(j.n_pairs)} pairs of {n}, or a "
                             f"pair whose keys differ")
    if not bool((torch.bincount(left, minlength=n) == 1).all()):
        raise AssertionError("join: a line item not matched exactly once")
    del j, left, right

    # rle / delta of o_orderkey, both round trips
    so = torch.sort(orders).values
    p = plan_of("rle", TPCH_ORDERS)
    r = run("rle o_orderkey", lambda: rel.run_length_encode(orders),
            planned_kernels("rle", p.method), plan=p,
            k3_passes=4 if p.method == "radix" else None,
            library=("torch.unique(return_counts=True)",
                     lambda: torch.unique(orders, return_counts=True)))
    same(r, torch_route("rle o_orderkey", lambda: rel.run_length_encode(
        orders, method="torch")), "rle")
    same_bits(rel.rle_decode(r.values, r.run_lengths, TPCH_ORDERS), so,
              "rle round trip")
    p = plan_of("delta", TPCH_ORDERS)
    d = run("delta o_orderkey", lambda: rel.delta_encode(orders),
            planned_kernels("delta", p.method), plan=p,
            k3_passes=4 if p.method == "radix" else None)
    same(d, torch_route("delta o_orderkey", lambda: rel.delta_encode(
        orders, method="torch")), "delta")
    same_bits(rel.delta_decode(d.deltas), so, "delta round trip")
    del r, d, so

    # the sketches: a torch.sort / bucketize oracle
    lo, hi = float(price.min()), float(price.max())
    h = run("histogram l_extendedprice 64 bins",
            lambda: rel.histogram(price, REL_BINS), (),
            library=("torch.histc", lambda: torch.histc(price, REL_BINS,
                                                        lo, hi)))
    idx = (torch.bucketize(price, h.edges, right=True) - 1
           ).clamp(0, REL_BINS - 1)
    same_bits(h.counts, torch.bincount(idx, minlength=REL_BINS)
              .to(torch.int32), "histogram vs bucketize")
    if int(h.counts.sum()) != n:
        raise AssertionError("histogram: counts do not add up to n")
    passes = -(-32 // tuning.active().digit_bits)
    # K4 one launch a digit pass; the ~0.99 n survivors ordered by K1
    # runs and K2 merges (past K1's cap)
    q = run("quantiles l_extendedprice", lambda: rel.quantiles(
        price, REL_QS), ("select_digit_hist", "bitonic_sort_kv_blocks")
        + K2_KV, exact={"select_digit_hist": passes}, qs=REL_QS,
        k=int(max(REL_QS) * (n - 1)) + 1,
        library=("torch.sort", lambda: torch.sort(price)))
    sp = torch.sort(price).values
    same_bits(q.values, sp[[int(f * (n - 1)) for f in REL_QS]],
              "quantiles vs torch.sort")
    del h, idx, q, sp

    # group_ranks: MoE dispatch rows (one-hot) and a flat sort path
    def ranks_oracle(ids, groups):
        o = torch.sort(ids, dim=-1, stable=True)
        first = torch.searchsorted(o.values, o.values, side="left")
        pos = torch.arange(ids.shape[-1], device="cuda").expand_as(first)
        r = torch.empty_like(first).scatter_(-1, o.indices, pos - first)
        c = torch.zeros(ids.shape[:-1] + (groups,), dtype=torch.int64,
                        device="cuda").scatter_add_(
            -1, ids.long(), torch.ones_like(ids, dtype=torch.int64))
        return r.to(torch.int32), c.to(torch.int32)

    ids = torch.from_numpy(rng.integers(0, MOE_EXPERTS, MOE_IDS)
                           .astype(np.int32)).cuda()
    gr = run(f"group_ranks {MOE_IDS} ids, {MOE_EXPERTS} experts",
             lambda: rel.group_ranks(ids, MOE_EXPERTS), ())
    same(gr, ranks_oracle(ids, MOE_EXPERTS), "group_ranks one-hot")
    flat = torch.from_numpy(rng.integers(0, FLAT_IDS[1], FLAT_IDS[0])
                            .astype(np.int32)).cuda()
    p = engine.choose(FLAT_IDS[0], 1, torch.int32, device="cuda")
    gr = run(f"group_ranks 2^24 ids, {FLAT_IDS[1]} groups",
             lambda: rel.group_ranks(flat, FLAT_IDS[1]),
             planned_kernels("group_ranks", p.method), plan=p,
             k3_passes=4 if p.method == "radix" else None)
    same(gr, torch_route(f"group_ranks 2^24 ids, {FLAT_IDS[1]} groups",
                         lambda: rel.group_ranks(flat, FLAT_IDS[1],
                                                 method="torch")),
         "group_ranks sort path")
    same(gr, ranks_oracle(flat, FLAT_IDS[1]), "group_ranks vs torch.sort")
    del gr, ids, flat, orders, lines, qty, price
    torch.cuda.synchronize()
    return launches


def phase_serve() -> dict:
    """``serve`` of minitron-4b, the prefill's attention on K6, with the
    launch counts set to 0 just before and read just after; then the same
    batches' prefill through K6 and through the einsum attention, and the
    time splits of a prefill and a decode step; the served requests'
    length accounting against a numpy count.  Returns the counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model_zoo

    cfg = get_config("minitron-4b")
    bsz, steps, n_req = (SERVE["batch_size"], SERVE["decode_steps"],
                         SERVE["n_requests"])
    plan = engine.choose(cfg.padded_vocab, bsz, torch.float32,
                         k=SERVE["topk"], device="cuda")
    emit({"phase": "serve", "model": cfg.name, "n_params": cfg.n_params(),
          "sampling_topk_rows": [bsz, cfg.padded_vocab],
          "k": SERVE["topk"], "sampling_topk_plan": plan.method,
          "costs_ns": plan.costs})

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, stats = srv.serve("minitron-4b", smoke=False, seed=SEED,
                            device="cuda", flash_prefill=True, **SERVE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    k6 = counts.get("flash_attention_fwd", 0)
    if k6 != cfg.n_layers * stats["batches"]:
        raise AssertionError(f"serve: K6 launched {k6} times, expected "
                             f"{cfg.n_layers} x {stats['batches']} batches "
                             f"(counts {counts})")
    # the sampling top-k and the scheduler's argsort sort 4-byte keys: a
    # K3 sort among them is one histogram and 4 passes
    check_k3_sorts("serve", counts,
                   4 if plan.method == "radix" or
                   counts.get("radix_onesweep_hist") else None)
    if len(done) != n_req or sorted(r.rid for r in done) != \
            list(range(n_req)):
        raise AssertionError(f"serve: {len(done)} of {n_req} answered")
    for r in done:
        if r.out is None or len(r.out) != steps or not (
                (r.out >= 0) & (r.out < cfg.vocab_size)).all():
            raise AssertionError(f"serve: request {r.rid} got {r.out}")
    # the length accounting (relational.group_by on the card) against a
    # numpy count of the prompt lengths: every request made ``steps`` tokens
    lens, per_len = np.unique([len(r.prompt) for r in done],
                              return_counts=True)
    want = [(int(k), int(c), float(steps)) for k, c in zip(lens, per_len)]
    if stats["length_groups"] != want:
        raise AssertionError(f"serve: length accounting "
                             f"{stats['length_groups']}, expected {want}")
    emit({"phase": "serve", "requests": len(done),
          "batches": stats["batches"], "launches": counts,
          "prompt_lens": sorted(len(r.prompt) for r in done),
          "length_groups": stats["length_groups"],
          "padding_waste": stats["padding_waste"],
          "prefill_ms": stats["prefill_ms"],
          "decode_tok_s": stats["decode_tps"], "seconds": seconds})
    first = {r.rid: int(r.out[0]) for r in done}
    del done, stats

    # the same batches (same requests, same scheduler) through both
    # attentions on the same weights (same seed, same card)
    einsum = model_zoo.build(cfg, device="cuda")
    flash = model_zoo.build(dataclasses.replace(cfg, flash_prefill=True),
                            device="cuda")
    params = einsum.init(torch.Generator(device="cuda").manual_seed(SEED))
    # the control: the einsum path in float32 on the same weights, how far
    # bf16 alone moves the logits
    wide = model_zoo.build(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda")
    params32 = as_float(params)
    sched = srv.LengthSortedScheduler(bsz, method=cfg.sort_method,
                                      device="cuda")
    for r in srv.make_requests(cfg.vocab_size, n_req, SERVE["max_len"],
                               steps, SEED):
        sched.submit(r)
    errs, control, decided, replayed, k6_errs = [], [], 0, 0, []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    while True:
        batch = sched.next_batch()
        if not batch:
            break
        toks = torch.from_numpy(srv.left_pad(batch)).cuda()
        # K6 against its plain version at this batch's attention shape
        q, k, v = attn_rows(gen, bsz * cfg.n_kv_heads,
                            cfg.n_heads // cfg.n_kv_heads, toks.shape[1],
                            toks.shape[1], cfg.resolved_head_dim,
                            torch.bfloat16)
        k6_errs.append(attn_within(fa.flash_rows(q, k, v),
                                   fa.flash_rows_plain(q, k, v),
                                   f"K6 at the serve's shape "
                                   f"{tuple(q.shape)}"))
        del q, k, v
        lf, state = flash.prefill(params, {"tokens": toks},
                                  max_len=toks.shape[1])
        le, _ = einsum.prefill(params, {"tokens": toks},
                               max_len=toks.shape[1])
        err = within(lf, le, PREFILL_LOGITS_TOL, "serve prefill logits")
        l32, _ = wide.prefill(params32, {"tokens": toks},
                              max_len=toks.shape[1])
        control.append(within(l32, le.float(), float("inf"),
                              "float32 control logits"))
        del l32
        top2 = le.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        if not bool((lf.argmax(-1) == le.argmax(-1))[sure].all()):
            raise AssertionError(f"serve: flash and einsum prefill argmax "
                                 f"differ where the margin exceeds 2 x {err}")
        errs.append(err)
        decided += int(sure.sum())
        replayed += sum(int(t) == first[r.rid]
                        for t, r in zip(lf.argmax(-1).tolist(), batch))
    del params32
    emit({"phase": "serve", "flash_vs_einsum_logits_max_abs_err": errs,
          "limit": PREFILL_LOGITS_TOL,
          "float32_vs_bf16_einsum_logits_max_abs_err": control,
          "logits_max_abs": le.abs().max().item(),
          "argmax_checked_rows": decided, "rows": n_req,
          "first_tokens_replayed": replayed,
          "k6_vs_plain_max_abs_and_row_rel_err_at_served_shapes": k6_errs})
    if 2 * decided <= n_req or replayed != n_req:
        raise AssertionError(f"serve: argmax checked on {decided} of {n_req} "
                             f"rows (needs most), {replayed} of {n_req} "
                             f"first tokens replayed by the prefill")
    prefill_split(flash, params, toks)
    del state
    decode_split(flash, params, toks, SERVE["max_len"])
    del params
    torch.cuda.synchronize()
    return counts


def as_float(tree):
    """A copy of a parameter tree (dicts and lists of tensors) in float32."""
    if isinstance(tree, dict):
        return {k: as_float(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_float(v) for v in tree)
    return tree.float()


def prefill_split(model, params, toks) -> None:
    """Where a prefill batch's time goes: the whole prefill (K6 on), its
    weight products (each layer's six, at the batch's token count, times
    the depth) and its K6 launches (times the depth), CUDA events; the
    rest is glue (norms, rope, casts, reshapes, the cache fill, launch
    gaps)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cfg = model.cfg
    b, s = toks.shape
    d, f, n, r = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads
    h = cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn((b * s, d), generator=gen, device="cuda").bfloat16()
    u = torch.randn((b * s, f), generator=gen, device="cuda").bfloat16()
    o = torch.randn((b * s, n * h), generator=gen, device="cuda").bfloat16()
    lp = {k: v[0] for k, v in params["body"]["mixer"].items()}
    ffn = {k: v[0] for k, v in params["body"]["ffn"].items()}

    def products():
        return (x @ lp["wq"], x @ lp["wk"], x @ lp["wv"], o @ lp["wo"],
                x @ ffn["wi"], u @ ffn["wo"])

    q, k, v = attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
    total = cuda_ms(lambda: model.prefill(params, {"tokens": toks},
                                          max_len=s), 3)[0]
    gemm = cuda_ms(products, 10)[0] * cfg.n_layers
    k6 = cuda_ms(lambda: fa.flash_rows(q, k, v), 10)[0] * cfg.n_layers
    emit({"phase": "serve", "prefill_split_batch": [b, s], "ms": total,
          "weight_products_ms": gemm, "k6_ms": k6,
          "glue_ms": total - gemm - k6,
          "weight_product_tflop_s": 2 * b * s * (2 * d * n * h + 2 * d * r * h
                                                 + 2 * d * f)
          * cfg.n_layers / gemm / 1e9})


def decode_split(model, params, toks, max_len) -> None:
    """A decode step of the batch (its cache ``max_len`` deep, as served)
    timed two ways: as served (eager, host clock over 10 synchronised
    steps) and as one CUDA-graph replay of the same step (CUDA events), the
    card's own time without the host's launch overhead.  Bound: the layer
    and unembedding weights and the whole cache, each read once."""
    import torch
    _, st = model.prefill(params, {"tokens": toks}, max_len=max_len)
    tok = toks[:, -1:].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        model.decode_step(params, tok, st)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / 10
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            model.decode_step(params, tok, st)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        model.decode_step(params, tok, st)
    device = cuda_ms(graph.replay, 20)[0]
    del graph
    nbytes = sum(v.numel() * v.element_size()
                 for v in (params["body"]["mixer"] | params["body"]["ffn"])
                 .values()) \
        + params["unembed"]["unembedding"].numel() * 2 \
        + 2 * st["body"].k.numel() * 2
    emit({"phase": "serve", "decode_step_batch": list(toks.shape),
          "cache_len": max_len, "eager_ms": host, "graph_replay_ms": device,
          "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
          "eager_tok_s": toks.shape[0] / host * 1e3})


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_ms(fn, reps: int):
    """:func:`cuda_ms` with the card's head start: a kernel table row's
    time is the card's."""
    return cuda_ms(fn, reps, lead=True)


def _bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the card's peak rate for their type (FP32 by
    default; K7's logic ops are INT32)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_timing(launches, run_len, radix_tile, digit_bits, k7_ops, k1_ops):
    """Each kernel at the main path's shapes: held bit for bit against its
    plain version on the same inputs, then timed beside it and beside
    ``torch.sort`` on the same rows.  Inputs are made on the card."""
    import torch
    from repro_torch.core import keycodec, network
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import bitserial_cas as bsc
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
            err=0.0, ops_per_s=FP32_OPS_PER_S, check=None, **extra):
        """Kernel and plain outputs bit for bit, unless ``check(got, want,
        what)``: K6's comparison of its one output, returning (max
        |kernel - plain|, max row relative error)."""
        ms, got = kernel_ms(kernel, 10)
        plain_ms, want = kernel_ms(plain, 1)
        if check is not None:
            err, extra["max_row_rel_err"] = check(got[0], want[0],
                                                  f"{name} vs plain")
        else:
            err = max([err] + [same_bits(g, w, f"{name} vs plain")
                               for g, w in zip(got, want)])
        del got, want
        b, by = _bound(nbytes, ops, ops_per_s)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None if library is None
                     else kernel_ms(library, 10)[0], **extra})
        emit({"phase": "timing", **rows[-1]})

    # K1 key-only: the runs of the 2^28 float32 sort.  Ops: the network's
    # compare-exchanges times the INT32 ALU instructions one costs in the
    # built SASS (``k1_ops``, from check_k1_sass)
    n = run_len
    lg = n.bit_length() - 1
    cas = lambda r: r * (n // 2) * lg * (lg + 1) // 2  # noqa: E731
    t = torch.randn((MAIN_N // n, n), generator=gen, device="cuda")
    row("bitonic_sort_blocks", "src/repro_torch/csrc/bitonic_sort.cu",
        "src/repro/kernels/bitonic_sort.py:144",
        lambda: (bs.sort_blocks(t),), lambda: (bs.apply_network(t, False),),
        2 * t.numel() * 4, cas(t.shape[0]) * k1_ops["key"],
        lambda: torch.sort(t, dim=-1), ops_per_s=INT32_OPS_PER_S,
        sass_alu_per_compare_exchange=k1_ops["key"])
    del t
    # K1 key-value: the runs of the 2^26 int32 argsort
    t = ints((KV_N // n, n), 4096)
    idx = torch.arange(n, dtype=torch.int32, device="cuda") \
        .expand(t.shape).contiguous()
    row("bitonic_sort_kv_blocks", "src/repro_torch/csrc/bitonic_sort.cu",
        "src/repro/kernels/bitonic_sort.py:172",
        lambda: bs.sort_kv_blocks(t, idx),
        lambda: bs.apply_network_kv(t, idx, False),
        2 * t.numel() * 8, cas(t.shape[0]) * k1_ops["kv"],
        lambda: torch.sort(t, dim=-1, stable=True),
        ops_per_s=INT32_OPS_PER_S,
        sass_alu_per_compare_exchange=k1_ops["kv"])
    del t, idx

    # K2 at the first and the last merge level of the 2^28 float32 sort
    # (key-only) and of the 2^26 int32 argsort (key-value, heavy ties
    # across the two runs), both ways, on the strided (a, b) views the
    # merge tree hands it: the wrapper's two launches (partition, merge)
    # timed together against the plain rank merge (the flip construction
    # when descending); then, ascending, the partition launch alone.  Its
    # bound: the binary searches' probes, two keys a step, and the cuts.
    for kv, total in ((False, MAIN_N), (True, KV_N)):
        name = "merge_pairs_kv_blocks" if kv else "merge_pairs_blocks"
        for level, l in (("first", n), ("last", total // 2)):
            for desc in (False, True):
                shape = (total // (2 * l), 2, l)
                pairs = ints(shape, 4096) if kv else torch.randn(
                    shape, generator=gen, device="cuda")
                pairs = torch.sort(pairs, dim=-1, descending=desc).values
                a, b = pairs[:, 0, :], pairs[:, 1, :]
                flat = pairs.view(shape[0], -1)
                va = torch.arange(l, dtype=torch.int32, device="cuda") \
                    .expand(a.shape).contiguous()
                vb = va + l
                if kv:
                    kernel = lambda: mp.merge_pairs_kv_blocks(  # noqa: E731
                        a, b, va, vb, descending=desc)
                    plain = lambda: mp.rank_merge(  # noqa: E731
                        a, b, va, vb, descending=desc)
                else:
                    kernel = lambda: (mp.merge_pairs_blocks(  # noqa: E731
                        a, b, descending=desc),)
                    plain = lambda: mp.rank_merge(  # noqa: E731
                        a, b, descending=desc)[:1]
                row(name, "src/repro_torch/csrc/merge_path.cu",
                    "src/repro/kernels/merge_path.py:182", kernel, plain,
                    2 * flat.numel() * (8 if kv else 4), flat.numel(),
                    lambda: torch.sort(flat, dim=-1, stable=kv,
                                       descending=desc),
                    level=level, descending=desc, shape=list(shape))
                if not desc:
                    cuts = shape[0] * (mp.tiles_per_row(l) + 1)
                    probes = l.bit_length()
                    row("merge_path_partition",
                        "src/repro_torch/csrc/merge_path.cu",
                        "src/repro/kernels/merge_path.py:182",
                        lambda: (mp.merge_path_partition(a, b),),
                        lambda: (mp.partition_plain(a, b),),
                        cuts * (2 * probes * a.element_size() + 4),
                        cuts * probes, None, level=level,
                        shape=list(shape), of=name,
                        search="the reference's _diag_search, "
                               "src/repro/kernels/merge_path.py:97")
                del pairs, a, b, flat, va, vb

    # K3 at the 2^26 uint32 radix sort_kv of the main path: the histogram
    # of all passes, one pass (each launch on a fresh look-back scratch,
    # made before the clock starts: the kernel alone), then the whole sort
    # beside torch.sort
    keys = torch.randint(-(1 << 31), 1 << 31, (1, KV_N), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    vals = torch.arange(KV_N, dtype=torch.int32, device="cuda").view(1, -1)
    radix = 1 << digit_bits
    passes = 32 // digit_bits
    kv_bytes = 2 * keys.numel() * 8            # read + write key, payload
    row("radix_onesweep_hist", "src/repro_torch/csrc/radix_sort.cu",
        "src/repro/kernels/radix_sort.py:123",
        lambda: (rsk.onesweep_hist(keys, digit_bits),),
        lambda: (rsk.onesweep_hist_plain(keys, digit_bits),),
        keys.numel() * 4 + passes * radix * 4, passes * keys.numel(), None,
        passes=passes)
    hist = rsk.onesweep_hist(keys, digit_bits)
    scratch = iter([rsk._scratch(keys, digit_bits) for _ in range(11)])
    row("radix_onesweep_pass", "src/repro_torch/csrc/radix_sort.cu",
        "src/repro/kernels/radix_sort.py:141",
        lambda: rsk._pass(keys, vals, hist, 0, digit_bits, next(scratch)),
        lambda: rsk.onesweep_pass_plain(keys, vals, hist, 0, digit_bits),
        kv_bytes + passes * radix * 4, keys.numel(), None,
        tile=rsk.ONESWEEP_TILE)
    del scratch
    # the whole sort (1 histogram, the passes and the scratch's memset)
    # against the plain pass loop on the card, beside torch.sort of the
    # same keys in their unsigned order; its launches counted on one call
    u = keys.view(-1) ^ -(1 << 31)
    _build.reset_launches()
    got = rsk.sort_kv_blocks(keys, vals)
    sort_launches = dict(_build.launches)
    plain_ms, want = kernel_ms(
        lambda: rsk.onesweep_sort_kv_plain(keys, vals, digit_bits), 1)
    err = max(same_bits(g, w, "radix sort_kv_blocks vs plain")
              for g, w in zip(got, want))
    del got, want
    ms = kernel_ms(lambda: rsk.sort_kv_blocks(keys, vals), 10)[0]
    b, by = _bound(keys.numel() * 4 + passes * kv_bytes, 0)
    emit({"phase": "timing", "name": "radix sort_kv_blocks 2^26 uint32 "
          "(whole K3 sort)", "ms": ms, "plain_ms": plain_ms,
          "max_abs_err": err, "bound_ms": b, "bound_by": by,
          "launches": sort_launches,
          "library_ms": kernel_ms(lambda: torch.sort(u, stable=True), 10)[0]})
    del keys, vals, hist, u

    # K4: the first (all-active) pass over the 2^24 float32 row of the
    # select top-k, and a later pass under the row's 64th key as prefix
    # (its time in the row as later_pass_ms); each launch counts into its
    # own histogram, zeroed before the clock starts (as a selection zeroes
    # one buffer for all its passes); torch.topk of the same row is the one
    # library call for the function
    x = torch.randn((1, TOPK_N), generator=gen, device="cuda")
    nbits = 32
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    enc = keycodec.encode(x, descending=True)
    kth = torch.sort(enc.to(torch.int64) & 0xffffffff, dim=-1) \
        .values[:, TOPK_K - 1].contiguous()

    def k4(thresh, shift, reps):
        bufs = iter(torch.zeros((reps + 1, 1, radix), dtype=torch.int32,
                                device="cuda"))
        return lambda: (sel.digit_hist(x, thresh, shift, digit_bits,
                                       radix_tile, encode=True,
                                       out=next(bufs)),)

    def k4_plain(thresh, shift):
        return lambda: (sel.digit_hist_plain(x, thresh, shift, digit_bits,
                                             radix_tile, encode=True),)

    later = compare("select_digit_hist later pass", k4(kth, 8, 0),
                    k4_plain(kth, 8))
    later_ms = kernel_ms(k4(kth, 8, 10), 10)[0]
    row("select_digit_hist", "src/repro_torch/csrc/radix_select.cu",
        "src/repro/kernels/radix_select.py:128",
        k4(zero, nbits - digit_bits, 10), k4_plain(zero, nbits - digit_bits),
        x.numel() * 4 + 8 + radix * 4, x.numel(),
        lambda: torch.topk(x, TOPK_K), err=later, later_pass_ms=later_ms)
    # the whole select top-k (4 passes, compaction, K1 order) and the
    # cuda top-k (K5's stream and merge launches) beside torch.topk
    for name, fn in (("select", lambda: sel.select_topk(x, TOPK_K)),
                     ("cuda", lambda: ops.bitonic_topk(x, TOPK_K))):
        emit({"phase": "timing", "name": f"topk {name} k={TOPK_K} 2^24",
              "ms": kernel_ms(fn, 5)[0],
              "library_ms": kernel_ms(lambda: torch.topk(x, TOPK_K), 5)[0]})
    del x, enc, kth
    lg = torch.randn(VOCAB, generator=gen, device="cuda")
    for name, fn in (("select", lambda: sel.select_topk(lg, 50)),
                     ("cuda", lambda: ops.bitonic_topk(lg, 50))):
        emit({"phase": "timing", "name": f"topk {name} k=50 (64, 128256)",
              "ms": kernel_ms(fn, 10)[0],
              "library_ms": kernel_ms(lambda: torch.topk(lg, 50), 10)[0]})
    del lg
    time_k5(row, gen)

    # K7 at each stage shape of the main path's imc steps: the paper units
    # (W=4, 2^24 pairs), the int32 sort (W=32, 2^23), the int8 argsort's
    # composite (W=16, 2^23) and the other key types (W=8/16/32, 2^20).
    # Each is held against its plain version on the same words, timed
    # beside it, and beside torch.minimum + torch.maximum on the same words
    # with the sign bit flipped (unsigned order in int32).  Bound: 16 B a
    # pair against the INT32 ALU instructions a pair costs in the built
    # SASS (``k7_ops``, from check_k7_sass: nvcc merges gates, so fewer
    # than the program's gates).
    def words(width, pairs):
        t = torch.randint(0, 1 << width, (pairs,), generator=gen,
                          device="cuda", dtype=torch.int64)
        return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)

    def k7_library(a, b):
        sa, sb = a ^ (-(1 << 31)), b ^ (-(1 << 31))
        return lambda: (torch.minimum(sa, sb), torch.maximum(sa, sb))

    for width, pairs, step in ((4, IMC_UNITS * 4, "paper units"),
                               (32, IMC_WIDE[0] * IMC_WIDE[1] // 2,
                                "int32 sort"),
                               (16, IMC_ARG[0] * IMC_ARG[1] // 2,
                                "int8 argsort composite"),
                               (8, IMC_DTYPES_SHAPE[0] * IMC_DTYPES_SHAPE[1]
                                // 2, "uint8 sort"),
                               (16, IMC_DTYPES_SHAPE[0] * IMC_DTYPES_SHAPE[1]
                                // 2, "int16 / uint16 sort"),
                               (32, IMC_DTYPES_SHAPE[0] * IMC_DTYPES_SHAPE[1]
                                // 2, "uint32 sort")):
        a, b = words(width, pairs), words(width, pairs)
        row("bitserial_cas", "src/repro_torch/csrc/bitserial_cas.cu",
            "src/repro/kernels/bitserial_cas.py:84",
            lambda: ops.bitserial_cas(a, b, width=width),
            lambda: bsc.exec_program_plain(a, b, width),
            16 * pairs, k7_ops[width] * pairs, k7_library(a, b),
            ops_per_s=INT32_OPS_PER_S, width=width, pairs=pairs,
            stage_of=step, gate_ops=int(bsc.program_table(width).shape[0]),
            sass_ops_per_pair=k7_ops[width])
        del a, b

    # the stage kernel at each imc step's (batch, n) and width: the
    # middle stage of the network held against its plain version on the
    # same words, then every stage of the network timed, one launch each,
    # in place; ms is a launch's mean.  Bound: the stage reads and writes
    # every word once (8 B a word) against the compiled program's INT32
    # instructions a pair (``k7_ops``; the stage's own index arithmetic
    # is not counted).
    for width, (batch, n), step in ((4, (IMC_UNITS, 8), "paper units"),
                                    (32, IMC_WIDE, "int32 sort"),
                                    (16, IMC_ARG, "int8 argsort composite"),
                                    (8, IMC_DTYPES_SHAPE, "uint8 sort"),
                                    (16, IMC_DTYPES_SHAPE,
                                     "int16 / uint16 sort"),
                                    (32, IMC_DTYPES_SHAPE, "uint32 sort")):
        v = words(width, batch * n).view(batch, n)
        sched = network.stage_schedule(n)
        k, j = sched[len(sched) // 2]
        plain_ms, want = kernel_ms(lambda: bsc.stage_plain(v, k, j, width), 1)
        err = same_bits(bsc.cas_stages(v, [(k, j)], width), want,
                        f"bitserial_cas_stage ({k}, {j}) W={width} vs plain")
        del want

        ms = kernel_ms(lambda: bsc.cas_stages(v, sched, width), 5)[0] \
            / len(sched)
        pairs = batch * n // 2
        b_, by = _bound(8 * batch * n, k7_ops[width] * pairs,
                        INT32_OPS_PER_S)
        rows.append({"name": "bitserial_cas_stage",
                     "route": "cuda", "source":
                     "src/repro_torch/csrc/bitserial_cas.cu",
                     "replaces": "src/repro/kernels/bitserial_cas.py:84",
                     "launches": launches.get("bitserial_cas_stage", 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_, "bound_by": by, "library_ms": None,
                     "width": width, "shape": [batch, n], "stages":
                     len(sched), "stage_of": step,
                     "gate_ops": int(bsc.program_table(width).shape[0]),
                     "sass_ops_per_pair": k7_ops[width]})
        emit({"phase": "timing", **rows[-1]})
        del v

    # extras, not in the kernels line: one launch over 2^26 pairs at W = 4
    # and W = 32, compared with the plain version on the first 2^24 pairs
    # (its bool planes hold W bytes a pair each)
    for width in (4, 32):
        a, b = words(width, CAS_PAIRS), words(width, CAS_PAIRS)
        ms, got = kernel_ms(lambda: ops.bitserial_cas(a, b, width=width), 10)
        pp = CAS_PLAIN_PAIRS
        err = max(same_bits(g[:pp], w, f"bitserial_cas W={width} vs plain")
                  for g, w in zip(got, bsc.exec_program_plain(a[:pp], b[:pp],
                                                              width)))
        del got
        bnd, by = _bound(16 * CAS_PAIRS, k7_ops[width] * CAS_PAIRS,
                         INT32_OPS_PER_S)
        emit({"phase": "timing", "name": f"bitserial_cas W={width} "
              f"{CAS_PAIRS} pairs (extra)", "ms": ms, "max_abs_err": err,
              "plain_pairs": pp, "bound_ms": bnd, "bound_by": by,
              "library_ms": kernel_ms(k7_library(a, b), 10)[0]})
        del a, b

    time_k6(row, gen)
    return rows


def time_k5(row, gen) -> None:
    """K5 at the main path's shapes: the one-pass kernels (each row's call
    is the wrapper's launches, held against the plain version), their
    merge launch alone, ascending rows (every key admitted), the serve's
    sampling rows three ways, and the network kernel of k > 256."""
    import torch
    import repro_torch.sort as rsort
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitonic_topk as btk

    src = "src/repro_torch/csrc/bitonic_topk.cu"
    ref = "src/repro/kernels/bitonic_topk.py:47"

    def k5_row(name, x, k, **extra):
        rows, n = x.shape
        row(name, src, ref, lambda: btk.topk_rows(x, k),
            lambda: btk.topk_rows_plain(x, k),
            x.numel() * x.element_size() + rows * k * (x.element_size() + 4),
            0, lambda: torch.topk(x, k, dim=-1), shape=[rows, n], k=k,
            plan=str(btk.plan(rows, n, k)), **extra)

    # MoE routing rows (the short kernel), vocabulary and sampling rows and
    # one long row (the stream kernel and its merge launch, timed together)
    k5_row("topk_rows_short", torch.randn(ROUTER, generator=gen,
                                          device="cuda"), 8)
    for shape, k in ((VOCAB, 50), ((8, 256000), 50), ((1, TOPK_N), TOPK_K)):
        x = torch.randn(shape, generator=gen, device="cuda")
        k5_row("topk_rows_stream", x, k, with_launch="topk_rows_merge")
        # adversarial order: every key beats the bound and is queued
        up = torch.arange(shape[1], dtype=torch.float32, device="cuda") \
            .expand(shape).contiguous()
        emit({"phase": "timing",
              "name": f"topk_rows ascending {list(shape)} k={k}",
              "ms": kernel_ms(lambda: btk.topk_rows(up, k), 10)[0],
              "random_rows_ms": kernel_ms(lambda: btk.topk_rows(x, k),
                                          10)[0],
              "max_abs_err": max(same_bits(g, w, "K5 ascending vs plain")
                                 for g, w in zip(btk.topk_rows(up, k),
                                                 btk.topk_rows_plain(up, k)))})
        del up
    # the merge launch alone, over the partial runs of the 2^24 row
    rows, n = x.shape
    p = btk.plan(rows, n, TOPK_K)
    part = torch.empty((rows, p.ctas, btk.run_len(TOPK_K)),
                       dtype=torch.int64, device="cuda")
    vo = torch.empty((rows, TOPK_K), device="cuda")
    io = torch.empty((rows, TOPK_K), dtype=torch.int32, device="cuda")
    lib, ptr, stream = btk._lib(), _build.ptr, _build.stream_of(x)
    _build.check(lib.topk_rows_stream(
        0, ptr(x), ptr(vo), ptr(io), ptr(part), rows, n, TOPK_K, p.stripe,
        p.warps_per_row, p.ctas, stream), "topk_rows_stream")

    def merge():
        _build.check(lib.topk_rows_merge(
            0, ptr(part), ptr(vo), ptr(io), rows, p.ctas,
            min(p.ctas, btk.MERGE_WARPS), TOPK_K, stream), "topk_rows_merge")
        return vo, io

    row("topk_rows_merge", src, ref, merge,
        lambda: btk.merge_runs_plain(part ^ btk.PLACEHOLDER, TOPK_K,
                                     torch.float32),
        part.numel() * 8 + rows * TOPK_K * 8, 0, None,
        shape=list(part.shape), k=TOPK_K)
    del x, part, vo, io

    # the serve's sampling rows, (8, 256000) k = 50, through the plan the
    # cost model picks today (radix), the one-pass cuda top-k and torch.topk
    x = torch.randn((8, 256000), generator=gen, device="cuda")
    emit({"phase": "timing", "name": "sampling topk (8, 256000) k=50",
          "radix_ms": kernel_ms(
              lambda: rsort.topk(x, 50, method="radix"), 10)[0],
          "cuda_ms": kernel_ms(lambda: rsort.topk(x, 50, method="cuda"),
                               10)[0],
          "library_ms": kernel_ms(lambda: torch.topk(x, 50), 10)[0]})
    del x

    # the network route (k > 256): MoE routing rows at k = 8, its row
    # before the one-pass kernels, and the per-chunk pass of a vocabulary
    # top-k past k = 256
    r = torch.randn(ROUTER, generator=gen, device="cuda")
    n, kk = ROUTER[1], 8
    lg5 = n.bit_length() - 1
    row("bitonic_topk_blocks", src, ref,
        lambda: btk.topk_blocks(r, kk), lambda: btk.topk_plain(r, kk),
        r.numel() * 4 + ROUTER[0] * kk * 8,
        ROUTER[0] * (n // 2) * lg5 * (lg5 + 1) // 2,
        lambda: torch.topk(r, kk, dim=-1))
    c = torch.randn((VOCAB[0] * 63, 2048), generator=gen, device="cuda")
    emit({"phase": "timing", "name": "bitonic_topk_blocks (4032, 2048) k=50",
          "ms": kernel_ms(lambda: btk.topk_blocks(c, 50), 10)[0],
          "bound_ms": _bound(c.numel() * 4 + c.shape[0] * 50 * 8, 0)[0],
          "max_abs_err": max(same_bits(g, w, "K5 vocab chunks vs plain")
                             for g, w in zip(btk.topk_blocks(c, 50),
                                             btk.topk_plain(c, 50)))})
    del r, c


def time_k6(row, gen) -> None:
    """K6's kernel-table rows: the serve's prefill batch, (8, 1024) x 24/8
    heads of 128, and prefill_32k's length at batch 1, bf16; beside SDPA on
    the same (B, N, S, H) tensors (causal from position 0: S = T).  Bound:
    the causal half of QK^T and PV over the bf16 tensor rate, against q, k,
    v and o read or written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    n, r, h = ATTN_HEADS
    for b, s in ATTN_SHAPES:
        q, k, v = attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
        q4, k4, v4 = (x.view(b, -1, s, h) for x in (q, k, v))
        row("flash_attention_fwd", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:101",
            lambda: (fa.flash_rows(q, k, v),),
            lambda: (fa.flash_rows_plain(q, k, v),),
            (2 * q.numel() + 2 * k.numel()) * 2, 2 * 2 * s * s / 2 * h * n * b,
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                   enable_gqa=True),
            ops_per_s=BF16_OPS_PER_S, check=attn_within,
            shape=[b, s, n, r, h], dtype="bfloat16")
        del q, k, v, q4, k4, v4


# sources whose kernels must keep everything in registers: no stack frame,
# no spills (K7's rows, K1's 16 keys a thread, K5's runs and composites,
# K6's accumulators, K2's 16 merged outputs a thread, K4's vectors in
# flight)
NO_SPILLS = ("bitserial_cas", "bitonic_sort", "bitonic_topk",
             "flash_attention", "merge_path", "radix_select")


def check_ptxas(_build) -> None:
    """Print what ``ptxas -v`` said of the K7, K3, K1, K5, K6, K2 and K4
    kernels (registers, stack frame, spills), one line a kernel, and K6's
    build warnings and performance notes; fail unless every kernel of
    ``NO_SPILLS`` has no stack frame and no spills, and if ptxas
    serialised K6's wgmma products (its C7520 note: the products then run
    one after another with nothing overlapping them)."""
    bad = []
    for name in ("bitserial_cas", "radix_sort") + NO_SPILLS[1:]:
        for u in _build.ptxas_usage(name):
            emit({"phase": "build", "ptxas": name, **u})
            if name in NO_SPILLS and (
                    u.get("stack") != 0 or u.get("spill_stores") != 0
                    or u.get("spill_loads") != 0):
                bad.append(u["kernel"])
    log = _build._lib_path("flash_attention").with_suffix(".log")
    warnings = [ln.strip() for ln in log.read_text().splitlines()
                if "warning" in ln.lower() or "Performance Loss" in ln]
    emit({"phase": "build", "ptxas_warnings": "flash_attention",
          "lines": warnings})
    if bad:
        raise AssertionError(f"kernels with a stack frame or spills: {bad}")
    serial = [ln for ln in warnings if "serialized" in ln]
    if serial:
        raise AssertionError(f"K6's wgmma products are serialised: {serial}")


def check_k6_sass(_build) -> None:
    """K6's bf16 H = 128 kernel, the serve's, must run its products on
    ``wgmma`` (``HGMMA`` in the SASS) fed by TMA (``UTMALDG``); prints
    both counts for every wgmma kernel."""
    funcs = sass_functions(_build.sass("flash_attention"))
    found = False
    for name, ins in funcs.items():
        if "flash_wgmma_kernel" not in name:
            continue
        ops = [op for _, op, _ in ins]
        counts = {"HGMMA": ops.count("HGMMA"), "UTMALDG": ops.count("UTMALDG")}
        emit({"phase": "build", "sass": name, **counts})
        if "__nv_bfloat16" in name and "Li128E" in name:
            found = True
            if not all(counts.values()):
                raise AssertionError(f"K6 bf16 H=128 kernel {name}: "
                                     f"{counts}, needs HGMMA and UTMALDG")
    if not found:
        raise AssertionError(f"no bf16 H=128 wgmma kernel among "
                             f"{sorted(funcs)}")


def check_k1_sass(_build) -> dict:
    """What a K1 compare-exchange costs in the built machine code: in each
    kernel's stage loop (the outermost loop holding the shuffles), the
    longest run of instructions free of memory, shuffles and branches is
    the in-thread merge that closes every stage (E keys a thread: log2(E)
    substages of E / 2 compare-exchanges); its ALU instructions over those
    compare-exchanges.  Returns {"key": float32 key-only, "kv": int32
    key-value} ALU instructions a compare-exchange at E = 16 (the main
    path's rows of 4096), the ops of K1's bound."""
    import re
    funcs = sass_functions(_build.sass("bitonic_sort"))
    out = {}
    for name, ins in funcs.items():
        m = re.search(r"bitonic_kernelI(\w+?)Lb([01])ELi(\d+)ELi(\d+)E",
                      name)
        if m is None:
            raise AssertionError(f"unexpected K1 kernel {name}")
        e = int(m.group(3))                 # keys a thread
        if e != 16:          # the key-value rows of 16384: no shuffles
            continue
        loops = [(lo, hi) for lo, hi in sass_loops(ins)
                 if any(op == "SHFL" and lo <= a <= hi for a, op, _ in ins)]
        if not loops:
            raise AssertionError(f"K1 {name}: no stage loop in the SASS")
        lo, hi = max(loops, key=lambda r: r[1] - r[0])
        inner = [r for r in sass_loops(ins)
                 if lo <= r[0] and r[1] < hi and r != (lo, hi)]
        body = [x for x in ins if lo <= x[0] <= hi
                and not any(a <= x[0] <= b for a, b in inner)]
        best, run = [], []
        for x in body + [(0, "BRA", "")]:
            op = x[1]
            if (op.startswith(SASS_MEMORY) or op in SASS_CONTROL
                    or op == "SHFL"):
                if pipe_counts(run)["alu"] > pipe_counts(best)["alu"]:
                    best = run
                run = []
            else:
                run.append(x)
        counts = pipe_counts(best)
        per_cx = counts["alu"] / (e // 2 * (e.bit_length() - 1))
        emit({"phase": "build", "sass": f"bitonic_kernel<{m.group(1)}, "
              f"kv={m.group(2)}, E={e}, T={m.group(4)}>",
              "merge_instructions": len(best), **counts,
              "alu_per_compare_exchange": per_cx})
        if e == 16 and (m.group(1), m.group(2)) == ("4KF32", "0"):
            out["key"] = per_cx
        if e == 16 and (m.group(1), m.group(2)) == ("4KIntIiE", "1"):
            out["kv"] = per_cx
    if sorted(out) != ["key", "kv"] or min(out.values()) < 1:
        raise AssertionError(f"K1 compare-exchange costs in the SASS: {out}")
    return out


# SASS opcodes by the pipe they issue to: memory and control take no
# logic slot; IMAD and friends issue to the FMA pipe; the rest (LOP3, SHF,
# LEA, SEL, IADD3, ISETP, ...) to the INT32 ALU pipe that bounds K7
SASS_MEMORY = ("LD", "ST", "ATOM", "RED")
SASS_CONTROL = ("BRA", "EXIT", "NOP", "BSSY", "BSYNC", "WARPSYNC", "YIELD",
                "BAR", "CALL", "RET")
SASS_FMA = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text -> {mangled kernel: [(address, opcode,
    instruction)]}, predicates stripped from the opcode."""
    import re
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body):
            t = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2))
            ins.append((int(m.group(1), 16), t.split()[0].split(".")[0], t))
        out[name] = ins
    return out


def sass_loops(ins):
    """The loops of one kernel: [(first, last) address of each backward
    branch's body]."""
    import re
    loops = []
    for addr, op, t in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", t)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    return loops


def pipe_counts(ins) -> dict:
    """Instructions by the pipe they issue to (``alu``, ``fma``,
    ``memory``, ``control``)."""
    n = {"alu": 0, "fma": 0, "memory": 0, "control": 0}
    for _, op, _ in ins:
        kind = ("memory" if op.startswith(SASS_MEMORY)
                else "control" if op in SASS_CONTROL
                else "fma" if op in SASS_FMA else "alu")
        n[kind] += 1
    return n


def check_k7_sass(_build) -> dict:
    """What a K7 pair costs in the built machine code: for each width, the
    INT32 ALU instructions of the pair kernel's 4-pair loop (16-byte loads)
    over 4 -- the gate program as nvcc compiled it, with its share of the
    loop's index arithmetic -- beside the program's gates.  Prints a line
    a width and fails if any K7 kernel holds a min/max instruction.
    Returns {W: ALU instructions a pair}, the ops of K7's bound."""
    import re
    from repro_torch.kernels import bitserial_cas as bsc
    funcs = sass_functions(_build.sass("bitserial_cas"))
    per_pair = {}
    for name, ins in funcs.items():
        mnmx = sorted({op for _, op, _ in ins if "MNMX" in op})
        if mnmx:
            raise AssertionError(f"K7 kernel {name} holds {mnmx}: the "
                                 f"gate program was compiled into a min/max")
        m = re.search(r"cas_(pairs|stage)ILi(\d+)E", name)
        if m is None:
            raise AssertionError(f"unexpected K7 kernel {name}")
        kernel, width = m.group(1), int(m.group(2))
        bodies = [[x for x in ins if lo <= x[0] <= hi]
                  for lo, hi in sass_loops(ins)]
        if kernel == "pairs":
            bodies = [b for b in bodies
                      if any(t.startswith("LDG.E.128") for _, _, t in b)]
        if len(bodies) != 1:
            raise AssertionError(f"K7 {kernel} W={width}: expected one "
                                 f"main loop in the SASS, found "
                                 f"{len(bodies)}")
        # a pair is two loads (a and b, or v[i] and v[i ^ j]); a 16-byte
        # load carries four pairs' words
        loads = [t for _, op, t in bodies[0] if op == "LDG"]
        pairs = sum(4 if ".128" in t else 1 for t in loads) // 2
        counts = pipe_counts(bodies[0])
        if kernel == "pairs":
            per_pair[width] = counts["alu"] / pairs
        emit({"phase": "build", "sass": f"cas_{kernel}<{width}>",
              "gates": int(bsc.program_table(width).shape[0]),
              "loop_pairs": pairs, "loop_instructions": len(bodies[0]),
              **counts, "alu_per_pair": counts["alu"] / pairs,
              "min_max_instructions": 0})
    if sorted(per_pair) != [2, 4, 8, 16, 32]:
        raise AssertionError(f"K7 pair kernels in the SASS: {per_pair}")
    return per_pair


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
    # float32 products in full float32 (the K6 float32 comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = card()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    tb = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - tb,
          "dir": str(_build.BUILD_DIR.relative_to(ROOT))})
    check_ptxas(_build)
    k7_ops = check_k7_sass(_build)
    check_k6_sass(_build)
    k1_ops = check_k1_sass(_build)

    rng = np.random.default_rng(SEED)
    tk = time.perf_counter()
    cases = phase_kernels(rng)
    emit({"phase": "kernels", "cases": cases, "bit_exact": True,
          "k6_limits": {"max_abs_err": K6_TOL, "max_row_rel_err": K6_ROW_REL},
          "seconds": time.perf_counter() - tk})

    prof = tuning.active()
    tm = time.perf_counter()
    main_res = phase_main(rng)
    emit({"phase": "main", "total_launches": main_res["launches"],
          "seconds": time.perf_counter() - tm})

    tr = time.perf_counter()
    rel_launches = phase_relational(rng)
    emit({"phase": "relational", "total_launches": rel_launches,
          "seconds": time.perf_counter() - tr})

    ts = time.perf_counter()
    serve_launches = phase_serve()
    emit({"phase": "serve", "seconds": time.perf_counter() - ts})
    launches = dict(main_res["launches"])
    for counts in (rel_launches, serve_launches):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    tt = time.perf_counter()
    rows = phase_timing(launches, prof.run_len, prof.radix_tile,
                        prof.digit_bits, k7_ops, k1_ops)
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
