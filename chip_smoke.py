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
            K6's bf16 kernels at H = 16, 32, 128, 192 and 256 must hold
            ``HGMMA`` and ``UTMALDG`` (wgmma fed by TMA); K1's ALU
            instructions a
            compare-exchange,
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
            for the quantiles, their survivors ordered by K1 and K2; where
            ``auto`` plans ``torch.sort``, the op again on ``method="radix"``
            with K3's launches asserted and the same bits), is
            held bit for bit against the same call on ``method="torch"``
            (``torch.sort``, no kernel may run) and by an independent check
            (``torch.unique``'s values and counts, int64 sums, float sums
            within c x 2^-24 of float64, every line item joined to its one
            order, the round trips; the sketches against ``torch.sort`` and
            ``torch.bucketize``), then is timed twice (CUDA-event and host
            ms, beside the one PyTorch call that computes the same where
            there is one);
4b. distributed
            the distributed tier on an 8-entry mesh (8 distinct cards where
            the machine has them, else 8 entries on cuda:0) and a 2 x 4
            mesh, at 2^28 float32 keys (2^25 a shard): sort, stable
            argsort and sort_kv (int32 payload) both ways through
            ``repro_torch.sort(..., mesh=)`` (each flat sort one
            ``radix_bucket_hist`` a shard and K2's merge tree, 3 levels x
            8 entries, exactly), ``distributed_sort`` with each strategy,
            the 2 x 4 two-level sort with 4 outer slices and the int8 codec
            on a float32 payload, ``sample_topk`` / ``distributed_topk`` at
            k = 64 and 1024 (K4 must run); each against ``torch.sort`` /
            ``torch.topk`` of the whole array on its keycodec key, bit for
            bit; the flat exchange and merge again under ``torch.profiler``
            (no sort kernel, K2's launches, phase 1's bucket histograms
            counted apart); the relational phase's SF10 columns through
            mesh unique, group_by and join against the single-device calls;
            a serve scheduler backlog of 8192 over the mesh against a
            mesh-free scheduler; ``topology.calibrate`` and a state snapshot
            round trip.  One JSON line a call: plan, CUDA-event and host
            ms, bytes per tier, bucket skew, peak memory;
5. serve    minitron-4b at full width and depth (32 layers, d=3072, 4.2 B
            parameters in bf16, random weights from a seeded generator)
            through ``repro_torch.launch.serve.serve`` with the prefill's
            attention on K6: 16 requests in batches of 8, prompts up to
            1023 tokens, 32 tokens each by top-k (k=50) sampling, every
            decode step a replay of the step captured as one CUDA graph
            (``launch.steps.DecodeGraph``).  The counts are set to 0 just
            before and read just after: K6 must launch once a layer and
            prefill batch, the replays must number batches x 31, and K5's
            sampling launches (counted through the replays) one a replay
            and warm-up step (``check_decode_graph``).  Then the same
            batches' prefill logits with K6 against the einsum attention
            (within
            0.2, the argmax equal on most rows, the served first tokens
            replayed; a float32 einsum prefill as the control of what bf16
            alone moves), and K6 against its plain version at each served
            batch's shape; the ``[serve] length accounting`` groups against
            a numpy count of the prompt lengths; the time split of a
            prefill; and ``decode_split``: the first served batch's decode
            captured against the eager step from the same prefill state
            under the same uniforms (logits within the eager path's own
            spread, tokens equal), eager and captured ms a step beside the
            bound, and one captured step's top kernels under
            ``torch.profiler``;
5b. moe_serve
            moonshot-v1-16b-a3b at full size (48 layers, 64 experts top-6
            + 2 shared, 28.4 B parameters in bf16, random weights from a
            seeded generator) through ``serve`` with the prefill's
            attention on K6: 16 requests in batches of 8, prompts up to 511
            tokens, ``max_len`` 2048, 32 tokens each by top-k (k=50).  The
            counts are set to 0 just before and read just after: every
            decode step a replay of the captured graph, the router's K5
            (``topk_rows_short``) once a MoE layer a forward (47 x
            (prefill batches + replays + warm-up steps)), apart from the
            sampling top-k's K5 (``topk_rows_stream``, once a replay and
            warm-up step), and K6 once a layer and prefill batch; prefill
            ms, decode tokens/s, peak memory and the top-k plans are
            printed; then ``decode_split`` of the first batch on the
            weights rebuilt, and K6 against its plain version at (8, 1024)
            x 16/16 heads of 128;
5c. families
            the ssm, hybrid, encdec and vlm families and the dense configs
            this slice added, each at full width with random weights from
            the seed, through ``serve`` with K6 on (8 requests in one batch,
            prompts up to 1023 tokens, 16 tokens each by top-k, k = 50),
            one model at a time, freed before the next: mamba2-1.3b (48
            layers), recurrentgemma-2b (26), gemma-2b (18), whisper-tiny
            (4 + 4, frames (8, 1500, 384)), and cut in depth where the
            weights do not fit: qwen2-vl-72b 8 of 80 layers, deepseek-67b 8
            of 95, nemotron-4-340b 2 of 96, and the MoE dbrx-132b 8 of 40
            (``serve(config=...)``).  The counts are set to 0 just before
            each serve and read just after: K6 once an attention layer a
            prefill batch (head dim 256 for gemma and recurrentgemma, 192
            for nemotron; none for mamba2 and whisper), every decode step
            a replay, and K5's sampling and dbrx's router launches
            counted through the replays.  Then, on the same weights,
            ``decode_split`` of the first batch and each family's checks:
            mamba2's float32 decode step at
            position 300 against a 301-token prefill; recurrentgemma's
            (1, 4096) prefill through K6 and through the einsum path (the
            2048-key window bites) and 8 decode steps across the ring
            buffer from both; gemma's and nemotron's (8, 1024) prefill both
            ways; qwen2-vl's (2, 2048) prefill with (2, 1024, 8192) vision
            embeddings and the M-RoPE ids of a 32 x 32 patch grid both
            ways (each within 0.2 and one K6 launch an attention layer);
            the long_500k shape for mamba2 and recurrentgemma (a
            524288-deep decode state no larger than a 4096-deep one, no
            cache past 2048 slots, 8 finite decode steps from position
            524280).  One line a model: prefill ms, decode tokens/s, the
            captured and eager ms a decode step, peak GiB, the card's name
            and power limit;
5d. train   moonshot at full width, depth cut to 3 (one dense prefix
            layer, a stacked body of two MoE layers, 1.93 B parameters),
            AdamW over ``SyntheticLM`` batches of 4 x 1024: one step's
            gradients with the router on K5 against the same step with
            ``router_method="torch"`` (within ``TRAIN_GRAD_TOL`` of each
            leaf's largest value); then 5 steps without a codec and 5 with
            the top-k codec (an eighth of each tensor), each step counted
            (the router's K5 twice a MoE layer: the forward and its remat
            recompute) with its loss, grad norm, ms, tokens/s and peak
            memory; the loss finite and falling.
            Then the smoke model: one float32 step on the card against the
            CPU (``SMOKE_TOL``), and ``launch.train`` saved, restored and
            continued on the card (the step count carries on);
5d2. families_train
            every architecture but nemotron-4-340b at full width, at the
            depth the one-card dry run (``launch.dryrun``, fake tensors)
            fits in 80% of the card's memory, built with remat from the
            seed: 5 steps of 4 x 1024 tokens (qwen2-vl 2 x 2048) with the
            plan's optimizer, frames and vision feeds where the family takes
            them; each loss finite and falling; K5's router launches twice a
            MoE layer and step, no kernel on a dense stack; one line a model
            with the predicted and measured peak, step ms (CUDA events),
            the roofline's bound and the MFU.  Then remat on against off
            (float32 gradients within 1e-6) for one architecture of each
            kind at smoke size, and nemotron-4-340b's dry-run record (it
            does not fit; no step);
            minitron-4b's losses again on one fixed batch (5 steps), then
            ``settle_3e``'s four lines on that batch: 5 steps at lr 0
            (losses equal), the loss along the step whose loss rose, 5
            steps at a tenth of the lr, and the first AdamW update of four
            leaves against one written out in float64 (fails on (a) or
            (d));
5d3. sharding
            a one-rank NCCL group on the card and a (1, 1) ``("data",
            "model")`` DeviceMesh: full-width minitron-4b served through
            ``launch.serve`` with a ``ShardingPolicy`` (bf16, 8 requests,
            batch 8, 16 tokens; its decode steps replays of one captured
            graph, as without a policy), its tokens equal to the same serve
            without a policy under the same uniforms and its K6 and K5
            launches equal; then K6's context-parallel decomposition (the per-rank
            work of ``_run_cp_flash``): at (8, 1024) and (1, 32768) x 24/8
            heads of 128, bf16, the queries cut into tp = 2, 4 and 8
            blocks at ``q_offset = i * S / tp`` against the whole K/V, the
            blocks' concatenation equal bit for bit to the whole and each
            block within K6's limits of its plain version, each block
            timed; then two full-width minitron-4b train steps at 2 layers
            under the policy: the first loss equal to the unsharded step's,
            the second within 1e-4 relative;
            the group is destroyed;
5e. data    2^20 token rows of 128 with a tenth planted as copies:
            ``dedup_rows`` on ``method="radix"`` (its ``unique`` exactly
            one K3 histogram and 4 passes) and on ``auto``, and
            ``global_dedup`` through the spill tier in 4 chunks (K3 a
            chunk, every K2 merge a partition launch and a merge launch),
            each keep-mask equal to a numpy brute force over the rows;
6. spill    the spill tier above the default 4 GiB threshold, inputs on
            the host: a 3 x 2^29 float32 ``method="auto"`` sort (its plan
            must be ``spill``; its chunk sorts as the planner prices a sort
            of their size, ``torch.sort`` under the seed), held bit for bit
            with overlap off and on, ``spill_argsort`` / ``spill_sort_kv``
            of 2^30 int32 keys in 16 runs both ways and a bfloat16 run on
            ``method="radix"`` (K3's rows), and a NaN-holding float32 run;
            each call counted (K3: a histogram and a pass a digit a chunk
            sort; K2: a partition launch a merge launch), held against
            ``torch.sort(stable=True)`` on the card (``spill_reference``:
            chunks sorted as their plan sorts them, one stable sort of the
            runs by the merge's order), and printed with its spill- and
            merge-phase ms, overlap fraction and link bytes beside a plain
            pinned 1 GiB copy's rate;
7. calibrate
            ``planner.calibrate`` at (64, 2048) and (4096, 4096): constants,
            probes, sweeps; the plans the seed and both calibrated profiles
            pick at this script's sort, top-k and SF10 shapes beside the
            ms of each candidate; the profile persisted, resolved by a
            fresh process (``source == "persisted"``), then
            ``reset_calibration()``: the timing phase runs on the seeds;
8. timing   each kernel at the main path's shapes: its output held against
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
            ``torch.topk``, and its network kernel (k > 256) as before;
            K6 at minitron's, moonshot's, gemma-2b's (H = 256, MQA) and
            nemotron-4-340b's (H = 192) prefill batches, and at H = 32
            and 16 on (8, 1024) x 8/8 heads; and K6 on the
            last context-parallel block of minitron's two prefill shapes
            at tp = 8 (``q_offset = 7 S / 8``), beside SDPA with the
            block's mask.

The last three lines are the card (``nvidia-smi`` name, power limit), the
kernel table, and ``{"ok": true, "device": ...}``.  Any failed build,
launch or comparison raises and the script exits non-zero without them.
It needs a card: without one it exits 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import itertools
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
# every K6 row: (B, S) and (query heads, kv heads, head dim); then
# moonshot's prefill batch, the families phase's wide heads: gemma-2b's
# (MQA, 256) and nemotron-4-340b's (192), and H = 32 and 16, the narrow
# widths (the card tests' smoke configs run 16)
K6_ROWS = tuple((bs, ATTN_HEADS) for bs in ATTN_SHAPES) \
    + (((8, 1024), (16, 16, 128)), ((8, 1024), (8, 1, 256)),
       ((8, 1024), (96, 8, 192)), ((8, 1024), (8, 8, 32)),
       ((8, 1024), (8, 8, 16)))
K6_TOL = {"float32": 1e-4, "bfloat16": 2e-2}    # max |kernel - plain|
# ... and the largest |kernel - plain|_2 / |plain|_2 over query rows: an
# absolute limit is loose where outputs are small (a row that sees n keys
# of randn values is ~n^-1/2), so K6 is also held to its values.  bf16:
# rounding P and the output gives ~2^-8, a 64-key tile dropped at n = 32K
# ~2^-4.5; float32: FMA order and expf, ~2^-20
K6_ROW_REL = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -6}
PREFILL_LOGITS_TOL = 0.2     # max |flash - einsum| of the served prefill
GRAPH_CHECK_STEPS = 8        # decode steps of each captured-vs-eager check
# the sharding phase: the policy serve (minitron-4b, full width), the
# context-parallel block counts, the 2-layer train step
SHARD_SERVE = dict(n_requests=8, batch_size=8, decode_steps=16, topk=50,
                   max_len=4096)
CP_TPS = (2, 4, 8)
SHARD_TRAIN = dict(layers=2, batch=4, seq=1024, steps=2)
# the (1, 1) policy step's losses against the unsharded step's: the first
# (the same forward) equal; after an AdamW step within 1e-4 relative (the
# sharded backward sums some products in another order, and an update's
# bf16 rounding of a parameter near a rounding boundary then differs)
SHARD_LOSS_REL = 1e-4
K6_NAMES = ("flash_attention_fwd",)
K5_NAMES = ("topk_rows_stream", "topk_rows_merge", "topk_rows_short",
            "bitonic_topk_blocks")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# H100 SXM INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
# H100 SXM exponent unit: 16 MUFU.EX2 a clock an SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1.98 GHz boost; K6 takes one exp2 a visible score
MUFU_EX2_PER_S = 132 * 16 * 1.98e9
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
    """K6 against its plain version: float32 and bf16, head dims 128, 192
    (nemotron-4-340b's) and 256 (gemma-2b's, recurrentgemma-2b's), G = 1
    and 3 (minitron's), causal with and without a window, non-causal, an
    absolute offset past T's start, and lengths off the 128-row blocks; its
    own generator, as K7's.  Emits the largest errors; returns the number
    of cases."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases, worst = 0, {}
    for name, h, g in itertools.product(K6_TOL, (128, 192, 256), (1, 3)):
        for s, t, off, causal, window in (
                (1000, 1000, 0, True, 0), (1000, 1000, 0, True, 256),
                (77, 77, 0, True, 0), (300, 1300, 1000, True, 0),
                (300, 1300, 1000, True, 100), (200, 333, 0, False, 0)):
            q, k, v = attn_rows(gen, 4, g, s, t, h, getattr(torch, name))
            errs = attn_within(
                fa.flash_rows(q, k, v, off, causal=causal, window=window),
                fa.flash_rows_plain(q, k, v, off, causal=causal,
                                    window=window),
                f"K6 {name} h={h} g={g} s={s} t={t} off={off} "
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


def check_decode_graph(what, stats, counts, steps, n_moe=0) -> dict:
    """Fail unless ``serve`` decoded through CUDA-graph replays, one a
    decode step of every batch (batches x (steps - 1)), and K5 ran as the
    replays count it: the sampling (``topk_rows_stream``) once a replay
    and once a warm-up step before each capture, and each of ``n_moe``
    routers (``topk_rows_short``) once a forward (the prefills, the
    replays, the warm-up steps).  Returns the graph figures."""
    replays, warm = stats["graph_replays"], stats["graph_warmup_steps"]
    if stats["decode_route"] != "graph" or stats["graph_captures"] < 1 \
            or replays != stats["batches"] * (steps - 1):
        raise AssertionError(f"{what}: decode route {stats['decode_route']}"
                             f", {stats['graph_captures']} captures, "
                             f"{replays} replays; expected one replay a "
                             f"decode step: {stats['batches']} x "
                             f"{steps - 1}")
    want = {"topk_rows_stream": replays + warm}
    if n_moe:
        want["topk_rows_short"] = n_moe * (stats["batches"] + replays + warm)
    wrong = {k: counts.get(k, 0) for k, v in want.items()
             if counts.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"{what}: K5 launches {wrong}, expected {want} "
                             f"(counts {counts})")
    return {k: stats[k] for k in ("decode_route", "graph_captures",
                                  "graph_replays", "graph_warmup_steps")}


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
    # the seed prices torch.sort as the radix sort it is on the card, and
    # below K3: the 2^28 float32 sort and the 2^26 argsort plan it (both
    # routes' ms are in the calibrate phase's table)
    argsort_plan = engine.choose(KV_N, 1, torch.int32, device="cuda")
    if (plan.method, argsort_plan.method) != ("torch", "torch"):
        raise AssertionError(f"seed plans: 2^28 float32 sort {plan.method}, "
                             f"2^26 int32 argsort {argsort_plan.method}; "
                             f"expected torch for both")
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
    counts = torch.bincount(ids.long(), minlength=64)
    # the auto plan's kernels (K3 on radix; torch.sort, no kernel, under
    # the seed), then K3's own row where auto plans another route
    for m in ("auto",) + (() if p.method == "radix" else ("radix",)):
        on_k3 = "radix" in (m, p.method)
        perm, splits = run(f"group_tokens_by_expert 131072 ids, 64 experts "
                           f"{m}",
                           lambda: engine.group_tokens_by_expert(
                               ids, 64, method=m),
                           K3 if on_k3 else (),
                           k3_passes=4 if on_k3 else None)
        same_bits(perm, _ref_sort(ids)[1], "group_tokens permutation")
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
    seg = engine.segment_ids_from_row_splits(splits, TOPK_N)
    o1 = _ref_sort(xs)[1].long()
    order = o1.gather(0, _ref_sort(seg.gather(0, o1))[1].long())
    p = engine.choose(TOPK_N, 1, torch.float32, device="cuda")
    for m in ("auto",) + (() if p.method == "radix" else ("radix",)):
        on_k3 = "radix" in (m, p.method)
        sv, ss = run(f"segment_sort 2^24 float32, {SEGMENTS} segments {m}",
                     lambda: rsort.segment_sort(xs, row_splits=splits,
                                                method=m),
                     K3 if on_k3 else (), k3_passes=4 if on_k3 else None)
        same_bits(sv, xs.gather(0, order), "segment_sort values")
        same_bits(ss, seg.gather(0, order), "segment_sort segment ids")
    del xs, splits, sv, ss, seg, o1, order

    # padded rows: each row's valid prefix sorted, the tail filled
    b = torch.from_numpy(rng.standard_normal(VOCAB, dtype=np.float32)).cuda()
    lengths = torch.from_numpy(rng.integers(0, VOCAB[1] + 1, VOCAB[0])
                               ).cuda()
    valid = torch.arange(VOCAB[1], device="cuda")[None, :] < lengths[:, None]
    want = torch.sort(torch.where(valid, b, float("inf")), dim=-1,
                      stable=True).values
    p = engine.choose(VOCAB[1], VOCAB[0], torch.float32, device="cuda")
    for m in ("auto",) + (() if p.method == "radix" else ("radix",)):
        on_k3 = "radix" in (m, p.method)
        out = run(f"sort(valid_lengths=...) (64, 128256) float32 {m}",
                  lambda: rsort.sort(b, valid_lengths=lengths,
                                     fill_value=-1.0, method=m),
                  K3 if on_k3 else (), k3_passes=4 if on_k3 else None)
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


def phase_relational(rng, cols) -> dict:
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
    measured: dict = {}     # op -> {route: ms}, read by phase_calibrate

    def run(name, fn, must, *, plan=None, k3_passes=None, exact=None,
            library=None, reps=2, route=None, **info):
        """One counted call, then ``reps`` timed calls: CUDA-event ms on
        the stream and host ms around each call (its syncs included).
        ``exact`` maps kernels to the launches the call must make;
        ``route`` names a pinned method's row."""
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
        line = {"phase": "relational", "op": name, "route": route,
                "plan": None if plan is None else plan.method,
                "costs_ns": None if plan is None else plan.costs,
                "ms": start.elapsed_time(end) / reps,
                "host_ms": (time.perf_counter() - t0) * 1e3 / reps,
                "launches": counts, **info}
        if library is not None:
            line["library"] = library[0]
            line["library_ms"] = cuda_ms(library[1], reps)[0]
        if route is not None or plan is not None:
            measured.setdefault(name, {})[route or plan.method] = line["ms"]
        emit(line)
        return out

    def radix_route(name, plan, fn, want):
        """K3's own row where ``auto`` plans another route (torch.sort is
        priced under K3 on the card): the same call on ``method="radix"``,
        one K3 sort of 4 passes a sorted column, the same bits."""
        if plan.method == "radix":
            return
        same(run(name, fn, K3, k3_passes=4, route="radix"), want,
             f"{name} radix")

    def torch_route(name, fn):
        """The same call on ``torch.sort``: no kernel may run."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if _build.launches:
            raise AssertionError(f"{name} method=torch launched "
                                 f"{dict(_build.launches)}")
        ms = cuda_ms(fn, 2, warm=False)[0]
        measured.setdefault(name, {})["torch"] = ms
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

    orders, lines, qty, price = cols
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
    radix_route("unique l_orderkey", p, lambda: rel.unique(
        lines, return_counts=True, method="radix"), u)
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
    radix_route("group_by l_orderkey, l_quantity", p, lambda: rel.group_by(
        lines, qty, agg=aggs, method="radix"), g)
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
    radix_route("group_by l_orderkey, l_extendedprice", p,
                lambda: rel.group_by(lines, price, agg=("sum", "mean"),
                                     method="radix"), g)
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
    radix_route("join l_orderkey = o_orderkey", p, lambda: rel.join(
        lines, orders, size=n, method="radix"), j)
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
    radix_route("rle o_orderkey", p, lambda: rel.run_length_encode(
        orders, method="radix"), r)
    same_bits(rel.rle_decode(r.values, r.run_lengths, TPCH_ORDERS), so,
              "rle round trip")
    p = plan_of("delta", TPCH_ORDERS)
    d = run("delta o_orderkey", lambda: rel.delta_encode(orders),
            planned_kernels("delta", p.method), plan=p,
            k3_passes=4 if p.method == "radix" else None)
    same(d, torch_route("delta o_orderkey", lambda: rel.delta_encode(
        orders, method="torch")), "delta")
    radix_route("delta o_orderkey", p, lambda: rel.delta_encode(
        orders, method="radix"), d)
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
    radix_route(f"group_ranks 2^24 ids, {FLAT_IDS[1]} groups", p,
                lambda: rel.group_ranks(flat, FLAT_IDS[1], method="radix"),
                gr)
    same(gr, ranks_oracle(flat, FLAT_IDS[1]), "group_ranks vs torch.sort")
    measured["n"] = {"lineitems": n, "orders": TPCH_ORDERS}
    del gr, ids, flat, orders, lines, qty, price
    torch.cuda.synchronize()
    return launches, measured


DIST_N = 1 << 28           # float32 keys of the mesh sorts (2^25 a shard)
DIST_ENTRIES = 8
DIST_CHUNKS = 4            # outer-exchange slices of the 2 x 4 sort
DIST_TOPK = (64, 1024)
DIST_BACKLOG = 8192        # scheduler backlog, over distributed_min (4096)


def dist_meshes():
    """(flat 8-entry mesh, 2 x 4 mesh, kind): 8 distinct cards where the
    machine has them, else every entry on cuda:0."""
    import torch
    from repro_torch.core.mesh import make_mesh
    distinct = torch.cuda.device_count() >= DIST_ENTRIES
    devices = None if distinct else "cuda:0"
    return (make_mesh((DIST_ENTRIES,), ("data",), devices),
            make_mesh((2, DIST_ENTRIES // 2), ("host", "dev"), devices),
            "distinct cards" if distinct else "one card, 8 entries")


def phase_distributed(rng, cols) -> dict:
    """The distributed tier at 2^28 float32 keys over an 8-entry mesh and a
    2 x 4 mesh: sort, stable argsort and sort_kv (int32 payload) both
    ways through ``repro_torch.sort(..., mesh=)``, ``distributed_sort``
    with each strategy, the 2 x 4 two-level sort with 4 outer slices and
    the int8 codec on a float32 payload, and the mesh top-k at k = 64 and
    1024.  Every result is held bit for bit against ``torch.sort`` of the
    whole array on its keycodec key (the sort's order: -0.0 below +0.0,
    ties by index; ``torch.topk`` for the top-k, with the same tie rule),
    the codec's payloads against the codec's decode of their encode.
    Each call runs once counted (launches set to 0 just before, read just
    after), then once warm: CUDA-event ms, host ms, the bytes the
    counters recorded per tier, the bucket skew and the peak memory.  The
    flat sort's exchange and merge run again under ``torch.profiler``:
    no ``torch.sort`` kernel there, K2's launches as the merge tree says,
    and one ``radix_bucket_hist`` a shard in its phase 1.  Then the SF10
    relational columns of the relational phase over the 8-entry mesh
    (unique, Q18's group_by, the join), each against the single-device
    call; a serve scheduler backlog of 8192 requests over the mesh against
    a mesh-free scheduler; one ``topology.calibrate`` and a state snapshot
    round trip.  Returns the launches."""
    import tempfile

    import numpy as np
    import torch
    import repro_torch.relational as rel
    import repro_torch.sort as rsort
    from repro_torch.core import distributed_sort as ds
    from repro_torch.core import keycodec, topology
    from repro_torch.engine import samplesort as ss
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as tserve
    from repro_torch.obs import metrics, trace as obs

    flat, two, kind = dist_meshes()
    emit({"phase": "distributed", "mesh": kind,
          "flat": [str(d) for d in flat.devices.flat],
          "two_level": {"shape": two.shape,
                        "devices": [str(d) for d in two.devices.flat]}})
    launches: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def run(name, fn, must=(), exact=None, **info):
        """One counted call, then one warm call timed by CUDA events and
        by the host clock, with the exchange counters of the warm call."""
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
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del out
        metrics.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        with obs.tracing():
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
        host = (time.perf_counter() - h0) * 1e3
        snap = metrics.snapshot()
        tiers = {k.split(".")[1]: v["value"] for k, v in snap.items()
                 if k.startswith("collectives.")}
        emit({"phase": "distributed", "call": name, "ms":
              start.elapsed_time(end), "host_ms": host, "bytes": tiers,
              "bucket_skew": snap.get("samplesort.bucket_skew",
                                      {}).get("value"),
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": counts, **info})
        obs.clear()
        metrics.reset()
        return out

    x = torch.from_numpy(rng.standard_normal(DIST_N, dtype=np.float32)
                         ).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pay = torch.randint(-(1 << 31), 1 << 31, (DIST_N,), generator=gen,
                        device="cuda", dtype=torch.int64).to(torch.int32)

    def ref_order(descending):
        """torch.sort of the whole array on its keycodec key, stable."""
        key = keycodec.encode(x, descending=descending) ^ -(1 << 31)
        return torch.sort(key, stable=True).indices.to(torch.int32)

    from repro_torch.engine import planner
    plan = planner.choose_distributed_cached(DIST_N, DIST_ENTRIES,
                                             torch.float32)
    merges = DIST_ENTRIES.bit_length() - 1      # tree levels over 8 runs
    k2_flat = {"merge_path_partition": DIST_ENTRIES * merges,
               "merge_pairs_kv_blocks": DIST_ENTRIES * merges,
               "radix_bucket_hist": DIST_ENTRIES}
    for descending in (False, True):
        order = ref_order(descending)
        want = x[order.long()]
        d = "desc" if descending else "asc"
        got = run(f"sort {d}", lambda: rsort.sort(
            x, mesh=flat, descending=descending), exact=k2_flat,
            plan=plan.strategy)
        same_bits(got, want, f"mesh sort {d}")
        del got
        got = run(f"argsort stable {d}", lambda: rsort.argsort(
            x, mesh=flat, descending=descending, stable=True),
            exact=k2_flat)
        same_bits(got, order, f"mesh argsort {d}")
        del got
        gk, gv = run(f"sort_kv int32 {d}", lambda: rsort.sort_kv(
            x, pay, mesh=flat, descending=descending), exact=k2_flat)
        same_bits(gk, want, f"mesh sort_kv keys {d}")
        same_bits(gv, pay[order.long()], f"mesh sort_kv payload {d}")
        del gk, gv, want, order
        torch.cuda.empty_cache()

    want = x[ref_order(False).long()]
    for strategy in ("sample", "oddeven", "auto"):
        got = run(f"distributed_sort {strategy}", lambda: ds.distributed_sort(
            x, flat, "data", strategy=strategy),
            must=("merge_path_partition",), plan=plan.strategy,
            costs_ns=plan.costs)
        same_bits(got, want, f"distributed_sort {strategy}")
        del got

    # the two-level sort: 4 outer slices, the int8 codec on a float32
    # payload; keys exact, payloads the codec's decode of their encode
    vf = torch.randn(DIST_N, generator=gen, device="cuda")
    topo = topology.for_mesh(two)
    hplan = planner.choose_distributed_cached(DIST_N, DIST_ENTRIES,
                                              torch.float32, topology=topo)
    gk, gv = run("two-level 2 x 4, chunks=4, int8 payload", lambda:
                 ss.sample_sort(x, two, None, values=vf,
                                pipeline_chunks=DIST_CHUNKS,
                                wire_codec="int8"),
                 must=("radix_bucket_hist", "merge_path_partition"),
                 plan=hplan.strategy, costs_ns=hplan.costs)
    same_bits(gk, want, "two-level keys")
    order = ref_order(False).long()
    step = vf.abs().max() / 127
    err = (gv - vf[order]).abs().max().item()
    if not err <= step.item() / 2 * (1 + 1e-6):
        raise AssertionError(f"two-level int8 payload: |err| {err} over "
                             f"half a step {step.item() / 2}")
    emit({"phase": "distributed", "two_level_payload_max_abs_err": err,
          "half_step": step.item() / 2})
    del gk, gv, vf
    gk = run("two-level 2 x 4 sort", lambda: rsort.sort(x, mesh=two),
             must=("radix_bucket_hist",))
    same_bits(gk, want, "two-level sort")
    del gk, want, order
    torch.cuda.empty_cache()

    # top-k, against torch.topk with lax.top_k's rule (+0.0 above -0.0,
    # the lower index first): torch.topk of the keycodec key
    key = keycodec.encode(x) ^ -(1 << 31)
    for k in DIST_TOPK:
        _, ti = torch.topk(key, k)
        kt = key[ti].cpu().numpy().astype(np.int64)
        ti = ti.cpu().numpy()
        want_i = torch.from_numpy(ti[np.lexsort((ti, -kt))].astype(np.int32))
        for name, fn in (("sample_topk", lambda: ss.sample_topk(
                x, k, flat, "data")), ("distributed_topk 2 x 4", lambda:
                ds.distributed_topk(x, k, two))):
            v, i = run(f"{name} k={k}", fn, must=("select_digit_hist",))
            same_bits(i.cpu(), want_i, f"{name} k={k} indices")
            same_bits(v, x[i.long()], f"{name} k={k} values")
    del key

    # the flat sort under the profiler, its phases apart: phase 1 (local
    # sorts, splitters, bucket histograms) must launch bucket_search_kernel
    # once a shard; the exchange and merge no sort kernel, and K2 as the
    # merge tree says
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_kernels(prof) -> dict:
        return {e.key[:90]: (e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and getattr(e, "self_device_time_total", 0) > 0}

    devs = ss._entries(flat, ("data",))
    m = DIST_N // DIST_ENTRIES
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pools = [ss._local_sort(ss._to_order_keys(x[d * m:(d + 1) * m],
                                                  False),
                                None, m, d * m, m, True, None, dev)
                 for d, dev in enumerate(devs)]
        starts, table = ss._cut(
            pools, [m] * DIST_ENTRIES, DIST_ENTRIES,
            ss.default_samples_per_shard(m, DIST_ENTRIES), True)
        torch.cuda.synchronize()
    p1 = dict(_build.launches)
    hist = sum(c for k, (c, _) in device_kernels(prof).items()
               if "bucket_search_kernel" in k)
    if hist != DIST_ENTRIES or p1.get("radix_bucket_hist") != DIST_ENTRIES:
        raise AssertionError(f"phase 1: bucket_search_kernel {hist} traced, "
                             f"{p1} counted, expected {DIST_ENTRIES} (one a "
                             f"shard)")
    cap = ss._round_capacity(int(table.max()), m)
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        merged = ss._exchange_merge(pools, starts, table, cap, None)
        out = ss._rebalance(merged, [m] * DIST_ENTRIES, devs)
        torch.cuda.synchronize()
    p2 = dict(_build.launches)
    kernels = device_kernels(prof)
    sorts = [k for k in kernels
             if "sort" in k.lower() and "searchsorted" not in k]
    if sorts:
        raise AssertionError(f"exchange/merge ran sort kernels: {sorts}")
    k2 = sum(c for k, (c, _) in kernels.items()
             if "merge_path_kernel" in k)
    part = sum(c for k, (c, _) in kernels.items()
               if "merge_partition_kernel" in k)
    if (k2, part) != (DIST_ENTRIES * merges, DIST_ENTRIES * merges) or \
            p2.get("merge_pairs_kv_blocks") != DIST_ENTRIES * merges:
        raise AssertionError(f"merge tree: K2 {k2} merge, {part} "
                             f"partition launches ({p2}), expected "
                             f"{DIST_ENTRIES * merges} each")
    got = torch.cat([pl.k for pl in out])
    same_bits(ss._from_order_keys(got, torch.float32, False),
              x[ref_order(False).long()], "profiled exchange")
    emit({"phase": "distributed", "profiled": "flat exchange + merge",
          "phase1_launches": p1, "phase1_bucket_hist_traced": hist,
          "launches": p2,
          "kernels_ms": sorted(([k, c, t] for k, (c, t) in kernels.items()),
                               key=lambda r: -r[2])[:10],
          "device_ms": sum(t for _, t in kernels.values())})
    del pools, merged, out, got, starts
    for k, v in {**p1, **p2}.items():
        launches[k] = launches.get(k, 0) + v
    del x, pay
    torch.cuda.empty_cache()

    # SF10 relational columns over the mesh against the single device
    orders, lines, qty, _ = cols
    for name, fn in (
            ("unique l_orderkey", lambda **kw: rel.unique(
                lines, return_counts=True, **kw)),
            ("group_by l_orderkey, l_quantity", lambda **kw: rel.group_by(
                lines, qty, agg=("sum", "count", "min", "max", "mean"),
                **kw)),
            ("join l_orderkey = o_orderkey", lambda **kw: rel.join(
                lines, orders, size=lines.numel(), **kw))):
        want = fn()
        got = run(f"relational {name}", lambda: fn(mesh=flat),
                  must=("radix_bucket_hist", "merge_path_partition"))
        for i, (g, w) in enumerate(zip(got, want)):
            for gg, ww in zip(*((g, w) if isinstance(g, tuple)
                                else ((g,), (w,)))):
                if gg is not None or ww is not None:
                    same_bits(gg, ww, f"mesh {name} field {i}")
        del got, want
        torch.cuda.empty_cache()

    # the serve scheduler's mesh path against a mesh-free scheduler
    lens = rng.integers(4, 4096, DIST_BACKLOG)
    batches = {}
    for label, kw in (("mesh", dict(mesh=flat)), ("local", {})):
        sch = tserve.LengthSortedScheduler(8, **kw)
        for i, n in enumerate(lens):
            sch.submit(tserve.Request(rid=i, prompt=np.zeros(int(n),
                                                             np.int32)))
        _build.reset_launches()
        first = [r.rid for r in sch.next_batch()]
        counts = dict(_build.launches)
        rest = [[r.rid for r in sch.next_batch()] for _ in range(3)]
        batches[label] = ([first] + rest, sch.mesh_sorts, counts)
    # the backlog's composite keys sort over the mesh (odd-even or the
    # sample sort, as the planner prices 8192 keys): K2 merges them
    if batches["mesh"][1] < 1 or not batches["mesh"][2].get(
            "merge_path_partition"):
        raise AssertionError(f"scheduler: no mesh sort ({batches['mesh']})")
    if batches["mesh"][0] != batches["local"][0]:
        raise AssertionError("scheduler: mesh batches differ from local")
    for k, v in batches["mesh"][2].items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "distributed", "scheduler_backlog": DIST_BACKLOG,
          "mesh_sorts": batches["mesh"][1], "first_batches_equal": True,
          "launches": batches["mesh"][2]})

    # topology: one calibrate on the mesh, a snapshot round trip
    t0 = time.perf_counter()
    # payloads of 1 MiB and 64 MiB an entry: at the default 1 KiB / 1 MiB
    # the 64 copies of a round take the host's time, not the copies'
    cal = topology.calibrate(flat, small_bytes=1 << 20, large_bytes=1 << 26,
                             set_as_active=False)
    with tempfile.TemporaryDirectory() as tmp:
        topology.set_active(cal)
        paths = tserve.snapshot_state(tmp, mesh=flat)
        topology.set_active(None)
        got = tserve.restore_state(tmp, mesh=flat)
        if "topology" not in got or topology.active().axes != cal.axes:
            raise AssertionError(f"topology round trip: {got}")
        topology.set_active(None)
    emit({"phase": "distributed", "calibrate": cal.to_dict()["axes"],
          "probe_ns": cal.probe_ns, "snapshot": [p.name for p in paths],
          "seconds": time.perf_counter() - t0,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
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
    graph = check_decode_graph("serve", stats, counts, steps)
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
          "batches": stats["batches"], "launches": counts, **graph,
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
                               steps, np.random.default_rng(SEED)):
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
    decode_split(cfg.name, flash, params, first_batch(cfg, **SERVE),
                 SERVE["max_len"], SERVE["topk"], trace=True)
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


def clone_tree(tree):
    """A copy of a decode state: dicts, lists and NamedTuples of tensors."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def first_batch(cfg, n_requests, batch_size, decode_steps, topk, max_len):
    """The first batch ``serve`` prefills from the seed's request stream,
    on the card: its left-padded tokens, and an encoder-decoder's frames
    (drawn after the prompts, as ``serve`` draws them)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as srv
    rng = np.random.default_rng(SEED)
    sched = srv.LengthSortedScheduler(batch_size, method=cfg.sort_method,
                                      device="cuda")
    for r in srv.make_requests(cfg.vocab_size, n_requests, max_len,
                               decode_steps, rng):
        sched.submit(r)
    batch = sched.next_batch()
    feed = {"tokens": torch.from_numpy(srv.left_pad(batch)).cuda()}
    if cfg.family == "encdec":
        feed["frames"] = torch.from_numpy(rng.standard_normal(
            (len(batch), cfg.enc_seq, cfg.d_model)) * 0.1).to(
                device="cuda", dtype=torch.float32)
    return feed


@contextlib.contextmanager
def routed_experts(out: list):
    """Append the number of distinct experts each MoE layer routes to
    (over the whole batch) to ``out`` while the block runs."""
    import torch
    from repro_torch.models import moe
    orig = moe._route

    def spy(params, x, cfg):
        res = orig(params, x, cfg)
        out.append(int(torch.unique(res[1]).numel()))
        return res
    moe._route = spy
    try:
        yield out
    finally:
        moe._route = orig


def decode_bytes(params, state, t, batch, routed) -> int:
    """Bytes a decode step of ``batch`` rows must move at position ``t``:
    every parameter it reads, once (an input embedding table beside a
    separate unembedding: its batch's rows only; a MoE layer's experts: the ``routed`` distinct
    experts of each MoE layer; an encoder and the cross K/V projections,
    which decode never runs: none), and the state it needs (a cache's
    slots up to ``t``, a window ring whole, every recurrent state and the
    frozen cross K/V whole)."""
    import torch
    from repro_torch.models.attention import KVCache

    def nbytes(x):
        return x.numel() * x.element_size()

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return []

    dense, experts, per_layer = 0, 0, []

    def walk(tree, key=""):
        nonlocal dense, experts
        if isinstance(tree, torch.Tensor):
            dense += nbytes(tree)
        elif isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("enc", "enc_ln") or (key == "cross_attn"
                                              and k in ("wk", "wv")):
                    continue
                if k == "embed" and "unembed" in tree:
                    dense += nbytes(v["embedding"][0]) * batch
                elif "router" in tree and k in ("wi", "wg", "wo"):
                    experts += nbytes(v)
                    if k == "wi":       # ((layers,) experts, d, f)
                        per_layer.extend([v.shape[-3]] * (
                            v.shape[0] if v.dim() == 4 else 1))
                else:
                    walk(v, k)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, key)
    walk(params)
    if per_layer:
        if len(routed) != len(per_layer):
            raise AssertionError(f"routing seen in {len(routed)} MoE layers, "
                                 f"the model has {len(per_layer)}")
        dense += experts * sum(routed) // sum(per_layer)

    def needed(tree, key=""):
        if isinstance(tree, KVCache) and key != "cross":
            return sum(nbytes(x) * min(t + 1, x.shape[-3]) // x.shape[-3]
                       for x in tree)
        if isinstance(tree, dict):
            return sum(needed(v, k) for k, v in tree.items())
        if isinstance(tree, (list, tuple)) and not isinstance(tree, KVCache):
            return sum(needed(v) for v in tree)
        return sum(nbytes(x) for x in leaves(tree))
    return dense + needed(state)


def decode_split(arch, model, params, feed, max_len, topk,
                 trace: bool = False) -> dict:
    """One batch's decode as ``serve`` runs it (``steps.DecodeGraph``, a
    CUDA graph) against the eager step (``make_serve_step``'s
    ``decode_step`` and sampler, the logits kept) from the same prefill
    state under the same uniforms, ``GRAPH_CHECK_STEPS`` steps, each run
    fed the first eager run's tokens.  A second eager run first measures
    the eager path's own spread of the logits; the captured step's logits
    must lie within it (equal where it is 0) and its tokens equal the
    eager ones wherever the sampled top-2 margin exceeds twice it
    (everywhere where it is 0).  Times: the eager step (host clock, 8
    synchronised steps), the captured step as served (host clock, with
    its uniform draw and copies) and its device time (CUDA events over 20
    calls); the bound: ``decode_bytes`` at the batch's first position over
    the card's memory rate.  With ``trace`` one captured step under
    ``torch.profiler``: its top kernels."""
    import torch
    from repro_torch import sort as sorting
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as steps_lib
    b = feed["tokens"].shape[0]
    n = GRAPH_CHECK_STEPS
    graph = steps_lib.DecodeGraph(model, ShapeSpec("serve", max_len, b,
                                                   "decode"),
                                  sample_topk=topk)
    sample = steps_lib.make_sampler(model, topk)
    logits, st = graph.prefill(params, feed)
    t0_pos = int(st["t"])
    tok0 = torch.argmax(logits, -1)[:, None].to(torch.int32)
    u = torch.rand((n, b, topk), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 28), device="cuda")
    routed, inputs, runs = [], [tok0], []
    for rep in range(2):
        es = clone_tree(st)
        toks, lgs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if rep == 1 and i == 0:     # the untimed run: what routes where
                with routed_experts(routed):
                    lg, es = model.decode_step(params, inputs[i], es)
            else:
                lg, es = model.decode_step(params, inputs[i], es)
            nxt = sample(lg, u[i])
            lgs.append(lg.float())
            toks.append(nxt)
            if rep == 0:
                inputs.append(nxt)
        torch.cuda.synchronize()
        runs.append((toks, lgs, (time.perf_counter() - t0) * 1e3 / n))
        del es
    eager_ms = runs[0][2]
    spread = max(float((a - c).abs().max())
                 for a, c in zip(runs[0][1], runs[1][1]))
    g_toks, g_lgs = [], []
    for i in range(n):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out, st = graph(params, inputs[i], st, u[i])
        g_toks.append(out)
        g_lgs.append(graph.logits(b).float().clone())
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    if graph.captures != 1 or graph.replays != n:
        raise AssertionError(f"{arch}: {graph.captures} captures and "
                             f"{graph.replays} replays, expected 1 and {n}")
    gdiff = max(float((a - c).abs().max())
                for a, c in zip(g_lgs, runs[0][1]))
    checked = 0
    for i in range(n):
        v, _ = sorting.topk(runs[0][1][i], topk,
                            method=model.cfg.sort_method, device="cuda")
        score = v + -torch.log(-torch.log(u[i] + 1e-9) + 1e-9)
        top2 = score.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * spread
        same = (g_toks[i] == runs[0][0][i])[:, 0]
        if not bool(same[sure].all()):
            raise AssertionError(f"{arch}: the captured step's tokens "
                                 f"differ from the eager step's at step {i} "
                                 f"where the margin exceeds 2 x {spread}")
        checked += int(sure.sum())
    if gdiff > spread:
        raise AssertionError(f"{arch}: captured logits differ from the eager "
                             f"ones by {gdiff}, the eager spread is {spread}")
    tok = inputs[-1]
    replay_ms = cuda_ms(lambda: graph(params, tok, st, u[0]), 20)[0]
    nbytes = decode_bytes(params, st, t0_pos, b, routed)
    row = {"model": arch, "decode_batch": [b, int(feed["tokens"].shape[1])],
           "cache_len": max_len, "steps": n, "eager_ms": eager_ms,
           "graph_ms": graph_ms, "graph_replay_ms": replay_ms,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "eager_tok_s": b / eager_ms * 1e3,
           "graph_tok_s": b / graph_ms * 1e3,
           "eager_spread": spread, "graph_vs_eager_max_abs": gdiff,
           "tokens_checked": checked, "tokens": n * b,
           "moe_experts_routed": routed or None}
    if trace:
        row["replay_trace"] = trace_summary(
            lambda: graph(params, tok, st, u[0]), top=12)
    emit({"phase": "decode_split", **row})
    del graph, st
    return row


# ---------------------------------------------------------------------------
# phases 5b, 5d, 5e: the MoE family, the training path, the data pipeline
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_SERVE = dict(n_requests=16, batch_size=8, decode_steps=32, topk=50,
                 max_len=2048)    # prompts of 4 to 511 tokens
TRAIN = dict(layers=3, batch=4, seq=1024, steps=5, peak_lr=3e-4,
             topk_frac=0.125)
# a bf16 gradient through the router's K5 against the same step's through
# torch.topk's route: the largest |diff| of a leaf over its largest |g|
TRAIN_GRAD_TOL = 1e-2
# the smoke step on the card against the CPU (float32): the loss and grad
# norm relative; the parameters within 1e-4 but for at most 0.1% of them,
# which stay within 2 lr (Adam turns a 1-ulp gradient difference where
# |g| is near eps into up to ~2 lr, lr 1e-2)
SMOKE_TOL = {"loss": 1e-5, "params": 1e-4, "params_share_past": 1e-3,
             "params_bound": 2e-2}
DATA_ROWS = 1 << 20       # token rows of the dedup phase
DATA_SEQ = 128
DATA_DUP = 0.1            # share of rows overwritten with an earlier row
DATA_CHUNK = 1 << 20      # bytes a spill chunk of fingerprints: 4 chunks


def phase_moe_serve() -> dict:
    """``serve`` of moonshot-v1-16b-a3b at full size (48 layers, 64
    experts top-6 + 2 shared, 28.4 B parameters in bf16, random weights
    from a seeded generator), the prefill's attention on K6, with the
    launch counts set to 0 just before and read just after: the router's
    K5 (``topk_rows_short``) once a MoE layer a forward, the sampling
    top-k's K5 (``topk_rows_stream``) once a decode step, K6 once a layer
    and prefill batch.  Then K6 against its plain version at the prefill's
    (8, 1024) x 16/16 heads of 128.  Returns the counts."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as srv
    from repro_torch.models import model_zoo

    cfg = get_config(MOE_ARCH)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    bsz, steps, n_req = (MOE_SERVE["batch_size"], MOE_SERVE["decode_steps"],
                         MOE_SERVE["n_requests"])
    plans = {
        "sampling (8, vocab) k=50": engine.choose(
            cfg.padded_vocab, bsz, torch.float32, k=MOE_SERVE["topk"],
            device="cuda"),
        "router decode (8, 64) k=6": engine.choose(
            cfg.moe.n_experts, bsz, torch.float32, k=cfg.moe.top_k,
            device="cuda"),
        "router prefill (8 x 512, 64) k=6": engine.choose(
            cfg.moe.n_experts, bsz * 512, torch.float32, k=cfg.moe.top_k,
            device="cuda")}
    emit({"phase": "moe_serve", "model": cfg.name,
          "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
          "plans": {k: p.method for k, p in plans.items()},
          "costs_ns": {k: p.costs for k, p in plans.items()}})
    if any(p.method != "cuda" for p in plans.values()):
        raise AssertionError("moe_serve: a router or sampling top-k is not "
                             "planned on K5")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, stats = srv.serve(MOE_ARCH, smoke=False, seed=SEED, device="cuda",
                            flash_prefill=True, **MOE_SERVE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    # the routers' K5 once a MoE layer a forward (a prefill a batch, a
    # replay a decode step, the warm-up steps), the sampling's once a
    # replay and warm-up step
    graph = check_decode_graph("moe_serve", stats, counts, steps, n_moe)
    k6 = counts.get("flash_attention_fwd", 0)
    if k6 != cfg.n_layers * stats["batches"]:
        raise AssertionError(f"moe_serve: K6 launched {k6} times, expected "
                             f"{cfg.n_layers} x {stats['batches']} "
                             f"(counts {counts})")
    check_k3_sorts("moe_serve", counts, None)
    if len(done) != n_req or sorted(r.rid for r in done) != \
            list(range(n_req)):
        raise AssertionError(f"moe_serve: {len(done)} of {n_req} answered")
    for r in done:
        if r.out is None or len(r.out) != steps or not (
                (r.out >= 0) & (r.out < cfg.vocab_size)).all():
            raise AssertionError(f"moe_serve: request {r.rid} got {r.out}")
    lens, per_len = np.unique([len(r.prompt) for r in done],
                              return_counts=True)
    if stats["length_groups"] != [(int(k), int(c), float(steps))
                                  for k, c in zip(lens, per_len)]:
        raise AssertionError(f"moe_serve: length accounting "
                             f"{stats['length_groups']}")
    emit({"phase": "moe_serve", "requests": len(done),
          "batches": stats["batches"], "launches": counts, **graph,
          "router_k5_launches": counts.get("topk_rows_short", 0),
          "sampling_k5_launches": counts.get("topk_rows_stream", 0),
          "prompt_lens": sorted(len(r.prompt) for r in done),
          "prefill_ms": stats["prefill_ms"],
          "decode_tok_s": stats["decode_tps"],
          "peak_memory_gib": peak / 2 ** 30, "seconds": seconds,
          "nvidia_smi": card()})
    del done, stats
    torch.cuda.empty_cache()
    model = model_zoo.build(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    decode_split(MOE_ARCH, model, params, first_batch(cfg, **MOE_SERVE),
                 MOE_SERVE["max_len"], MOE_SERVE["topk"])
    del model, params
    torch.cuda.empty_cache()
    # K6 at moonshot's prefill shape: 16 query heads on 16 kv heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v = attn_rows(gen, 8 * cfg.n_kv_heads, 1, 1024, 1024,
                        cfg.resolved_head_dim, torch.bfloat16)
    errs = attn_within(fa.flash_rows(q, k, v), fa.flash_rows_plain(q, k, v),
                       "K6 at moonshot's (8, 1024) x 16/16 x 128")
    emit({"phase": "moe_serve", "k6_vs_plain_max_abs_and_row_rel_err": errs,
          "shape": [8, 1024, 16, 16, 128], "limits": [K6_TOL["bfloat16"],
                                                      K6_ROW_REL["bfloat16"]]})
    del q, k, v
    return counts


# ---------------------------------------------------------------------------
# phase 5c: the ssm, hybrid, encdec and vlm families and the dense configs
# ---------------------------------------------------------------------------

FAMILY_SERVE = dict(n_requests=8, batch_size=8, decode_steps=16, topk=50,
                    max_len=4096)     # one batch, prompts of 4 to 1023 tokens
# (arch, layers served: None for the full depth; the depth cuts keep the
# weights of the widest layers within the card's 80 GB with room for the
# checks: 80 of qwen2-vl-72b's layers are 145 GB in bf16, deepseek-67b's 95
# 125 GB, nemotron-4-340b's 96 632 GB, dbrx-132b's 40 263 GB: 8 of its
# layers and its embeddings are 55 GB)
FAMILIES = (("mamba2-1.3b", None), ("recurrentgemma-2b", None),
            ("gemma-2b", None), ("whisper-tiny", None),
            ("qwen2-vl-72b", 8), ("deepseek-67b", 8),
            ("nemotron-4-340b", 2), ("dbrx-132b", 8))
# K6's head dim and kv heads where this phase asserts them: 256 with MQA
# (gemma-2b), 256 (recurrentgemma-2b), 192 (nemotron-4-340b)
K6_WIDE = {"gemma-2b": (256, 1), "recurrentgemma-2b": (256, 1),
           "nemotron-4-340b": (192, 8)}
LONG_CONTEXT = 524288        # the long_500k shape's cache depth
WINDOW_PREFILL = (1, 4096)   # recurrentgemma: twice its 2048-key window
VISION_PREFILL = (2, 2048)   # qwen2-vl: a 32 x 32 patch grid, then text
VISION_GRID = 32
DECODE_TOL = 1e-2   # float32: a decode step against a longer prefill


def grid_positions(b, s, prefix, side):
    """(3, B, S) int32 M-RoPE ids on the card: a side x side patch grid at
    t = 0 over the first ``prefix`` positions (h = row, w = column), then
    text from ``side`` on with t = h = w (Qwen2-VL's layout)."""
    import torch
    pos = torch.zeros((3, b, s), dtype=torch.int32, device="cuda")
    i = torch.arange(prefix, device="cuda")
    pos[1, :, :prefix] = (i // side).to(torch.int32)
    pos[2, :, :prefix] = (i % side).to(torch.int32)
    pos[:, :, prefix:] = (side + torch.arange(s - prefix, device="cuda")).to(
        torch.int32)
    return pos


def flash_vs_einsum(cfg, params, batch, what, max_len):
    """The prefill of ``batch`` with K6 (counted: one launch an attention
    layer) and with the einsum attention on the same weights; fails unless
    the last logits agree within ``PREFILL_LOGITS_TOL``.  Returns (max
    |diff|, the two decode states)."""
    import dataclasses
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import model_zoo
    out = {}
    for flash in (True, False):
        m = model_zoo.build(dataclasses.replace(cfg, flash_prefill=flash),
                            device="cuda")
        _build.reset_launches()
        out[flash] = m.prefill(params, batch, max_len=max_len)
        torch.cuda.synchronize()
        k6 = _build.launches.get("flash_attention_fwd", 0)
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        if k6 != (n_attn if flash else 0):
            raise AssertionError(f"{what}: K6 launched {k6} times with "
                                 f"flash={flash}, expected {n_attn}")
    err = within(out[True][0], out[False][0], PREFILL_LOGITS_TOL,
                 f"{what}: flash vs einsum prefill logits")
    return err, out[True][1], out[False][1]


def state_bytes(state) -> int:
    """Bytes of every tensor of a decode state."""
    import torch
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    return 0


def long_context(model, params) -> dict:
    """The long_500k shape: ``decode_state(1, 524288)`` holds no cache
    slot past the window (its bytes equal a 4096-deep state's and no
    sequence axis exceeds 2048), and eight decode steps from position
    524280 give finite logits."""
    import torch
    st = model.decode_state(1, LONG_CONTEXT)
    small = state_bytes(model.decode_state(1, 4096))
    seq = [x.shape[-3] for layer in st["prefix"] + [st["body"]]
           if layer is not None and hasattr(layer, "k")
           for x in (layer.k, layer.v)]
    if state_bytes(st) != small or any(n > 2048 for n in seq):
        raise AssertionError(f"{model.cfg.name}: a {LONG_CONTEXT}-deep "
                             f"decode state holds {state_bytes(st)} bytes "
                             f"(4096-deep: {small}), cache lengths {seq}")
    st["t"] = torch.full((), LONG_CONTEXT - 8, dtype=torch.int32,
                         device="cuda")
    tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    for _ in range(8):
        logits, st = model.decode_step(params, tok, st)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{model.cfg.name}: non-finite logits at "
                                 f"t = {int(st['t']) - 1}")
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    return {"state_bytes": state_bytes(st), "cache_lengths": sorted(set(seq)),
            "decoded_to": int(st["t"])}


def family_checks(arch, cfg, model, params) -> dict:
    """The per-family checks on the served model's weights (rebuilt from
    the same seed): what each family adds to the path."""
    import dataclasses
    import torch
    from repro_torch.models import model_zoo
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    out = {}
    if arch == "mamba2-1.3b":
        # decode continues prefill: decode_step at position s against a
        # prefill of s + 1 tokens, in float32 (and bf16, reported)
        toks = torch.randint(0, cfg.vocab_size, (2, 301), generator=gen,
                             device="cuda", dtype=torch.int32)
        wide = model_zoo.build(dataclasses.replace(cfg, dtype="float32"),
                               device="cuda")
        for name, m, p in (("float32", wide, as_float(params)),
                           ("bfloat16", model, params)):
            full, _ = m.prefill(p, {"tokens": toks}, max_len=512)
            _, st = m.prefill(p, {"tokens": toks[:, :300]}, max_len=512)
            step, _ = m.decode_step(p, toks[:, 300:], st)
            tol = DECODE_TOL if name == "float32" else float("inf")
            out[f"decode_vs_prefill_{name}_max_abs_err"] = within(
                step, full, tol, f"mamba2 {name} decode vs prefill")
            del p, st
        out["logits_max_abs"] = full[:, :cfg.vocab_size].abs().max().item()
        out["long_context"] = long_context(model, params)
    elif arch == "recurrentgemma-2b":
        b, s = WINDOW_PREFILL
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device="cuda", dtype=torch.int32)
        err, sf, se = flash_vs_einsum(cfg, params, {"tokens": toks},
                                      "recurrentgemma (1, 4096)", s + 8)
        out["window_prefill"] = [b, s]
        out["flash_vs_einsum_max_abs_err"] = err
        # eight steps across the 2048-slot ring buffer from both states
        errs, tok = [], toks[:, -1:]
        for _ in range(8):
            lf, sf = model.decode_step(params, tok, sf)
            le, se = model.decode_step(params, tok, se)
            errs.append(within(lf, le, PREFILL_LOGITS_TOL,
                               "recurrentgemma decode after the window"))
            tok = le.argmax(-1, keepdim=True).to(torch.int32)
        out["ring_decode_max_abs_err"] = errs
        del sf, se
        out["long_context"] = long_context(model, params)
    elif arch in ("gemma-2b", "nemotron-4-340b"):
        toks = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen,
                             device="cuda", dtype=torch.int32)
        err, _, _ = flash_vs_einsum(cfg, params, {"tokens": toks},
                                    f"{arch} (8, 1024)", 1024)
        out["flash_vs_einsum_max_abs_err"] = err
    elif arch == "qwen2-vl-72b":
        b, s = VISION_PREFILL
        prefix = VISION_GRID * VISION_GRID
        if prefix != cfg.vision_prefix:
            raise AssertionError(f"qwen2-vl: vision prefix "
                                 f"{cfg.vision_prefix}, grid {prefix}")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32),
                 "vision_embeds": (torch.randn((b, prefix, cfg.d_model),
                                               generator=gen, device="cuda")
                                   * 0.1).bfloat16(),
                 "positions": grid_positions(b, s, prefix, VISION_GRID)}
        err, _, _ = flash_vs_einsum(cfg, params, batch,
                                    "qwen2-vl vision prefill", s)
        out["vision_prefill"] = [b, s, prefix]
        out["flash_vs_einsum_max_abs_err"] = err
    torch.cuda.synchronize()
    return out


def phase_families() -> dict:
    """The ssm (mamba2-1.3b), hybrid (recurrentgemma-2b), encdec
    (whisper-tiny) and vlm (qwen2-vl-72b) families, the dense gemma-2b,
    deepseek-67b and nemotron-4-340b and the MoE dbrx-132b, each at full
    width (the depth cut where the weights do not fit, ``FAMILIES``:
    ``serve``'s ``config``), random weights from the seed, with K6 on,
    through ``serve``, one at a time and freed before the next.  The
    counts are set to 0 just before each serve and read just after: K6
    once an attention layer a prefill batch (none for mamba2 and whisper),
    every decode step a replay of the captured graph, and K5 as the
    replays count it (``check_decode_graph``).  Then, on the same weights
    rebuilt, the captured decode against the eager step
    (``decode_split``) and each family's own checks
    (``family_checks``).  Returns the counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as srv
    from repro_torch.models import model_zoo

    bsz, steps, n_req = (FAMILY_SERVE["batch_size"],
                         FAMILY_SERVE["decode_steps"],
                         FAMILY_SERVE["n_requests"])
    smi = card()
    total = {}
    for arch, layers in FAMILIES:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        encdec = cfg.family == "encdec"
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers if cfg.moe else 0
        n_attn = 0 if encdec else sum(cfg.layer_kind(i) == "attn"
                                      for i in range(cfg.n_layers))
        if arch in K6_WIDE and (cfg.resolved_head_dim,
                                cfg.n_kv_heads) != K6_WIDE[arch]:
            raise AssertionError(f"{arch}: K6 at head dim "
                                 f"{cfg.resolved_head_dim}, "
                                 f"{cfg.n_kv_heads} kv heads; expected "
                                 f"{K6_WIDE[arch]}")
        plan = engine.choose(cfg.padded_vocab, bsz, torch.float32,
                             k=FAMILY_SERVE["topk"], device="cuda")
        if plan.method != "cuda":
            raise AssertionError(f"{arch}: the sampling top-k is planned on "
                                 f"{plan.method}, not K5")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, stats = srv.serve(arch, smoke=False, seed=SEED, device="cuda",
                                flash_prefill=True, config=cfg,
                                **FAMILY_SERVE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        k6 = counts.get("flash_attention_fwd", 0)
        if k6 != n_attn * stats["batches"]:
            raise AssertionError(f"{arch}: K6 launched {k6} times, expected "
                                 f"{n_attn} x {stats['batches']} (counts "
                                 f"{counts})")
        graph = check_decode_graph(arch, stats, counts, steps, n_moe)
        check_k3_sorts(arch, counts, None)
        if sorted(r.rid for r in done) != list(range(n_req)):
            raise AssertionError(f"{arch}: {len(done)} of {n_req} answered")
        for r in done:
            if r.out is None or len(r.out) != steps or not (
                    (r.out >= 0) & (r.out < cfg.vocab_size)).all():
                raise AssertionError(f"{arch}: request {r.rid} got {r.out}")
        lens, per_len = np.unique([len(r.prompt) for r in done],
                                  return_counts=True)
        if stats["length_groups"] != [(int(k), int(c), float(steps))
                                      for k, c in zip(lens, per_len)]:
            raise AssertionError(f"{arch}: length accounting "
                                 f"{stats['length_groups']}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        prompt_lens = sorted(len(r.prompt) for r in done)
        del done
        torch.cuda.empty_cache()
        tc = time.perf_counter()
        model = model_zoo.build(dataclasses.replace(cfg, flash_prefill=True),
                                device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        split = decode_split(arch, model, params,
                             first_batch(cfg, **FAMILY_SERVE),
                             FAMILY_SERVE["max_len"], FAMILY_SERVE["topk"])
        model = model_zoo.build(cfg, device="cuda")
        checks = family_checks(arch, cfg, model, params)
        del model, params
        torch.cuda.empty_cache()
        emit({"phase": "families", "model": arch, "family": cfg.family,
              "layers": cfg.n_layers, "n_params": cfg.n_params(),
              "reduced": None if layers is None else
              f"depth {get_config(arch).n_layers} -> {layers} layers",
              "k6_head_dim": cfg.resolved_head_dim if n_attn else None,
              "k6_launches": counts.get("flash_attention_fwd", 0),
              "sampling_k5_launches": counts.get("topk_rows_stream", 0),
              "router_k5_launches": counts.get("topk_rows_short", 0),
              "launches": counts, "batches": stats["batches"], **graph,
              "prompt_lens": prompt_lens,
              "prefill_ms": stats["prefill_ms"],
              "decode_tok_s": stats["decode_tps"],
              "peak_memory_gib": peak / 2 ** 30, "serve_seconds": seconds,
              "decode_split": split, "checks": checks,
              "checks_seconds": time.perf_counter() - tc,
              "nvidia_smi": smi})
    return total


def _train_smoke_on_card_vs_cpu() -> dict:
    """One AdamW step of moonshot's smoke model in float32 on the card and
    on the CPU from the same weights and batch: the small input the
    full-width run is held to."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32")
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -100, np.int32)],
                            axis=1)
    init = model_zoo.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED))
    out = {}
    for dev in ("cpu", "cuda"):
        model = model_zoo.build(cfg, device=dev)
        params = tree.map(lambda p: p.to(dev, copy=True), init)
        fn, opt = steps_lib.make_train_step(
            model, cfg, ShapeSpec("smoke", 32, 4, "train"), peak_lr=1e-2,
            total_steps=10)
        state = opt.init(params)
        params, state, met = fn(params, state, 1, {
            "tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)})
        out[dev] = (params, float(met["loss"]), float(met["grad_norm"]))
    (pc, lc, gc), (pg, lg, gg) = out["cpu"], out["cuda"]
    diff = torch.cat([(a - b.cpu()).abs().reshape(-1)
                      for a, b in zip(tree.leaves(pc), tree.leaves(pg))])
    res = {"loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_norm_rel_err": abs(gg - gc) / abs(gc),
           "params_max_abs_err": diff.max().item(),
           "params_share_past": (diff > SMOKE_TOL["params"]).float().mean()
           .item()}
    if res["loss_rel_err"] > SMOKE_TOL["loss"] or \
            res["grad_norm_rel_err"] > SMOKE_TOL["loss"] or \
            res["params_share_past"] > SMOKE_TOL["params_share_past"] or \
            res["params_max_abs_err"] > SMOKE_TOL["params_bound"]:
        raise AssertionError(f"train smoke: card vs CPU {res}, limits "
                             f"{SMOKE_TOL}")
    return res


def phase_train() -> dict:
    """moonshot-v1-16b-a3b at full width, depth cut to 3 (one dense
    prefix layer and a stacked body of two MoE layers), AdamW on
    ``SyntheticLM`` batches of 4 x 1024: one step's gradients with the
    router on K5 against the same step with ``router_method="torch"``;
    then 5 steps without a codec and 5 with the top-k codec (an eighth of
    each tensor), each step counted and timed; the loss finite and
    falling.  The model keeps only each layer's inputs through the
    forward (remat, the default while a gradient is taken), so a MoE
    layer's forward runs again in the backward and its router's K5
    launches twice a gradient: in the forward and in the recompute.  Then the smoke
    model: one step on the card against the CPU, and a save, restore and
    continue of ``launch.train`` (the step count carries on).  Returns the
    launches."""
    import contextlib
    import dataclasses
    import io
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.engine import planner
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import grad_compress

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAIN["layers"])
    b, s = TRAIN["batch"], TRAIN["seq"]
    model = model_zoo.build(cfg, device="cuda")
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    if (model.impl.n_prefix, model.impl.n_body) != (1, n_moe):
        raise AssertionError("train: not one dense prefix layer and a "
                             "stacked MoE body")
    router = planner.choose(cfg.moe.n_experts, b * s, torch.float32,
                            k=cfg.moe.top_k, device="cuda")
    emit({"phase": "train", "model": cfg.name, "layers": cfg.n_layers,
          "n_params": cfg.n_params(), "tokens_a_step": b * s,
          "router_plan": router.method, "reduced": "depth 48 -> 3 layers",
          "nvidia_smi": card()})
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=SEED))
    launches: dict = {}

    # one step's gradients: the router on K5 against torch.topk's route
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    batch = to_device(data.global_batch_at(0), "cuda")
    _build.reset_launches()
    la, _, ga = steps_lib.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    if _build.launches.get("topk_rows_short", 0) != 2 * n_moe:
        raise AssertionError(f"train: router K5 launches "
                             f"{dict(_build.launches)}, expected "
                             f"{2 * n_moe} (forward + remat recompute)")
    ref = model_zoo.build(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_method="torch")), device="cuda")
    lb, _, gb = steps_lib.loss_and_grads(ref, params, batch)
    worst = 0.0
    for (path, x), y in zip(tree.leaves_with_path(ga), tree.leaves(gb)):
        err = (x.float() - y.float()).abs().max().item() / max(
            y.float().abs().max().item(), 1e-30)
        worst = max(worst, err)
        if err > TRAIN_GRAD_TOL:
            raise AssertionError(f"train: gradient {path} with the router "
                                 f"on K5 differs from torch.topk's route by "
                                 f"{err} of its largest value")
    emit({"phase": "train", "check": "gradients, router on K5 vs torch",
          "loss": [float(la), float(lb)], "max_rel_err": worst,
          "limit": TRAIN_GRAD_TOL})
    del params, ga, gb, ref, batch

    for codec in (None, "topk"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        hook = None
        if codec is not None:
            cinit, hook = grad_compress.make_compressor(
                grad_compress.CompressorConfig(
                    codec=codec, topk_frac=TRAIN["topk_frac"]))
        fn, opt = steps_lib.make_train_step(
            model, cfg, ShapeSpec("train", s, b, "train"),
            peak_lr=TRAIN["peak_lr"], total_steps=TRAIN["steps"],
            grad_compressor=hook)
        state = opt.init(params)
        if codec is not None:
            state.update(cinit(params))
        losses = []
        for step in range(TRAIN["steps"]):
            batch = to_device(data.global_batch_at(step), "cuda")
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, met = fn(params, state, step, batch)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = dict(_build.launches)
            if counts.get("topk_rows_short", 0) != 2 * n_moe:
                raise AssertionError(f"train: router K5 launches {counts}, "
                                     f"expected {2 * n_moe} a step "
                                     f"(forward + remat recompute)")
            check_k3_sorts("train", counts, None)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            losses.append(loss)
            emit({"phase": "train", "codec": codec, "step": step,
                  "loss": loss, "grad_norm": float(met["grad_norm"]),
                  "lr": float(met["lr"]), "ms": ms,
                  "tokens_s": b * s / ms * 1e3,
                  "peak_memory_gib": torch.cuda.max_memory_allocated()
                  / 2 ** 30, "launches": counts})
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"train codec={codec}: losses {losses} "
                                 f"not finite and falling")
        del params, state, fn, opt, batch
    torch.cuda.empty_cache()

    smoke = _train_smoke_on_card_vs_cpu()
    # save, restore, continue: the driver's own oracle
    ck = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        kw = dict(smoke=True, batch=4, seq=64, lr=1e-2, ckpt_dir=ck,
                  ckpt_every=3, log_every=100, device="cuda")
        first = train_lib.train(MOE_ARCH, steps=6, **kw)
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            more = train_lib.train(MOE_ARCH, steps=9, **kw)
        latest = Checkpointer(ck).latest_step()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if "resumed from step 6 -> starting at 6" not in said.getvalue() or \
            len(more) != 3 or latest != 9 or not first[-1] < first[0]:
        raise AssertionError(f"train: resume did not continue the step "
                             f"count ({said.getvalue()!r}, {first}, {more}, "
                             f"latest {latest})")
    emit({"phase": "train", "smoke_card_vs_cpu": smoke,
          "limits": SMOKE_TOL, "smoke_losses": first + more,
          "resumed_at": 6, "latest_checkpoint": latest})
    return launches


# the families_train phase: every architecture but nemotron-4-340b at full
# width, cut to the depth the dry run fits on the card (FIT_SHARE of its
# memory: room for the dry run's misses, 0-23% on the card, and for the
# allocator's fragmentation: after the earlier phases moonshot's 6 layers,
# fitted to 0.85, found 9.7 GiB reserved but unallocated and ran out)
TRAIN_ARCHS = ("whisper-tiny", "mamba2-1.3b", "recurrentgemma-2b",
               "gemma-2b", "minitron-4b", "moonshot-v1-16b-a3b",
               "deepseek-67b", "qwen2-vl-72b", "dbrx-132b")
# Adam's first steps move every weight by ~lr in a coherent direction, a
# product's output by ~lr x its fan-in: the learning rate falls with the
# widest fan-in, max(d_model, d_ff) (0.1 / 1536 = 6.5e-5 for whisper-tiny,
# 0.1 / 29568 = 3.4e-6 for qwen2-vl-72b), so that a fresh model's loss
# falls from the first step
FAMILY_TRAIN = dict(batch=4, seq=1024, steps=5, lr_x_fan_in=0.1)
FIXED_BATCH_ARCH = "minitron-4b"    # also trained on one fixed batch


def family_lr(cfg) -> float:
    return FAMILY_TRAIN["lr_x_fan_in"] / max(cfg.d_model, cfg.d_ff)
VLM_TRAIN = (2, 2048)     # qwen2-vl: its 1024-token vision prefix, then text
FIT_SHARE = 0.8
REMAT_ARCHS = ("minitron-4b", "mamba2-1.3b", "recurrentgemma-2b",
               "whisper-tiny", "moonshot-v1-16b-a3b")
REMAT_TOL = 1e-6          # float32 gradients, remat on against off


def _remat_check() -> dict:
    """One architecture of each kind (dense, ssm, hybrid, encdec, MoE) at
    smoke size in float32 on the card: the gradients with remat equal
    those without, within ``REMAT_TOL``."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_zoo
    out = {}
    for arch in REMAT_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=2, seed=SEED))
        batch = to_device(train_lib.train_batch(data, cfg, 0, SEED), "cuda")
        on = model_zoo.build(cfg, device="cuda", remat=True)
        off = model_zoo.build(cfg, device="cuda", remat=False)
        params = on.init(torch.Generator(device="cuda").manual_seed(SEED))
        la, _, ga = steps_lib.loss_and_grads(on, params, batch)
        lb, _, gb = steps_lib.loss_and_grads(off, params, batch)
        err = max((x - y).abs().max().item()
                  for x, y in zip(tree.leaves(ga), tree.leaves(gb)))
        if err > REMAT_TOL or float(la) != float(lb):
            raise AssertionError(f"remat {arch}: gradients differ by {err} "
                                 f"(loss {float(la)} vs {float(lb)})")
        out[arch] = err
    return out


# fault 3e: the fixed-batch run's alphas along the step after which its
# loss rose (step 1 -> 2), the smaller lr, the leaves AdamW is checked on
# by hand (an attention projection, an MLP matrix, the embedding, a norm
# gain) and that check's limit: |port - by hand| of a leaf's first update
# within this share of lr, beside the float32 rounding of the master
SETTLE_ALPHAS = (0.0, 0.25, 0.5, 1.0)
SETTLE_LR_X_FAN_IN = 0.01
SETTLE_LEAVES = ("['wq']", "['wi']", "['embedding']", "['scale']")
SETTLE_UPDATE_TOL = 1e-3


def settle_3e(model, cfg, shape, plan, batch, n_steps, device="cuda"
              ) -> dict:
    """Whether fault 3e (minitron-4b's fixed-batch losses rise and fall at
    full width) is the port's or the step size's: four checks on the same
    model, cut and batch, one line each.  (a) ``n_steps`` steps at lr 0:
    the losses must be equal (else something outside the update moves).
    (b) The float32 masters before and after step 1 (the loss rose after
    it): the loss (forward only, the step's microbatches) at theta_1 +
    alpha (theta_2 - theta_1) for ``SETTLE_ALPHAS``; a loss that falls
    and then rises along the step says the step is too long.  (c)
    ``n_steps`` steps at ``SETTLE_LR_X_FAN_IN``.  (d) The first update of
    ``SETTLE_LEAVES`` against AdamW written out here in float64 from the
    same gradients (optax.adamw's formula with the reference's b1, b2,
    eps and weight decay on every leaf, after the global-norm clip).
    Raises if (a) or (d) fails."""
    import math
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps as steps_lib

    accum = torch.bfloat16 if plan.accum == "bfloat16" else torch.float32

    def make(lr):
        return steps_lib.make_train_step(
            model, cfg, shape, optimizer_name=plan.optimizer,
            microbatch=plan.microbatch, accum_dtype=accum, peak_lr=lr,
            total_steps=n_steps)

    def fresh(opt):
        params = model.init(torch.Generator(device=device).manual_seed(SEED))
        return params, opt.init(params)

    def micro(j):
        per = batch["tokens"].shape[0] // plan.microbatch
        return {k: v.narrow(steps_lib.batch_axis(k), j * per, per)
                for k, v in batch.items()}

    out, chunk = {}, 1 << 24
    # (a) lr 0
    fn, opt = make(0.0)
    params, state = fresh(opt)
    la = []
    for step in range(n_steps):
        params, state, met = fn(params, state, step, batch)
        la.append(float(met["loss"]))
    out["a"] = {"losses": la, "equal": all(x == la[0] for x in la)}
    emit({"phase": "families_train", "fault": "3e", "check": "(a) lr 0",
          **out["a"]})
    del params, state, fn, opt, met

    # (b) along step 1
    torch.cuda.empty_cache()
    lr = family_lr(cfg)
    fn, opt = make(lr)
    params, state = fresh(opt)
    steps_loss = []
    params, state, met = fn(params, state, 0, batch)
    steps_loss.append(float(met["loss"]))
    # theta_1 waits in host memory (a float32 copy of the model)
    theta1 = [m.to("cpu", copy=True) for m in tree.leaves(state["master"])]
    params, state, met = fn(params, state, 1, batch)
    steps_loss.append(float(met["loss"]))
    along = {}
    with torch.no_grad():
        for alpha in SETTLE_ALPHAS:
            for p, t1, t2 in zip(tree.leaves(params), theta1,
                                 tree.leaves(state["master"])):
                for c0 in range(0, p.numel(), chunk):
                    p.view(-1)[c0:c0 + chunk].copy_(torch.lerp(
                        t1.view(-1)[c0:c0 + chunk].to(t2.device),
                        t2.view(-1)[c0:c0 + chunk], alpha))
            along[alpha] = sum(float(model.loss(params, micro(j))[0])
                               for j in range(plan.microbatch)) \
                / plan.microbatch
    lowest = min(along, key=along.get)
    out["b"] = {"step_losses": steps_loss, "alpha_losses": along,
                "lowest_at_alpha": lowest,
                "falls_then_rises": 0 < lowest < 1 and all(
                    along[x] > along[y] for x, y in
                    zip(SETTLE_ALPHAS, SETTLE_ALPHAS[1:]) if y <= lowest)
                and all(along[x] < along[y] for x, y in
                        zip(SETTLE_ALPHAS, SETTLE_ALPHAS[1:])
                        if x >= lowest)}
    emit({"phase": "families_train", "fault": "3e",
          "check": "(b) along step 1 -> 2", "lr": lr, **out["b"]})
    del params, state, fn, opt, met, theta1
    torch.cuda.empty_cache()

    # (c) a tenth of the learning rate
    small = SETTLE_LR_X_FAN_IN / max(cfg.d_model, cfg.d_ff)
    fn, opt = make(small)
    params, state = fresh(opt)
    lc = []
    for step in range(n_steps):
        params, state, met = fn(params, state, step, batch)
        lc.append(float(met["loss"]))
    out["c"] = {"lr": small, "losses": lc,
                "falls_at_each_step": all(b_ < a_ for a_, b_ in
                                          zip(lc, lc[1:]))}
    emit({"phase": "families_train", "fault": "3e",
          "check": "(c) lr_x_fan_in 0.01", **out["c"]})
    del params, state, fn, opt, met

    # (d) AdamW by hand on the first update, from the same gradients
    torch.cuda.empty_cache()
    b1, b2, eps, wd, clip = 0.9, 0.95, 1e-8, 0.1, 1.0
    fn, opt = make(lr)
    params, state = fresh(opt)
    _, _, grads = steps_lib.loss_and_grads(model, params, micro(0))
    gl = tree.leaves(grads)
    norm = math.sqrt(sum(float(g.reshape(-1)[c0:c0 + chunk].double()
                               .square().sum())
                         for g in gl for c0 in range(0, g.numel(), chunk)))
    scale = min(1.0, clip / (norm + 1e-9))
    # lr at step 0: warmup min(500, n_steps // 10) = 0, so the cosine at
    # its start, peak_lr (a warmup of w > 0 would give 0)
    warm = min(500, n_steps // 10)
    lr0 = 0.0 if warm > 0 else lr
    paths = [k for k, _ in tree.leaves_with_path(state["master"])]
    picked = [next(i for i, k in enumerate(paths) if k.endswith(name))
              for name in SETTLE_LEAVES]
    before = {i: tree.leaves(state["master"])[i].to("cpu", copy=True)
              for i in picked}
    opt.update(grads, state, 0)
    leaves_d = {}
    ok = True
    for i in picked:
        t0 = before[i].reshape(-1)
        g = gl[i].reshape(-1)
        port = tree.leaves(state["master"])[i].reshape(-1)
        worst = 0.0
        for c0 in range(0, t0.numel(), chunk):
            th = t0[c0:c0 + chunk].to(g.device).double()
            gc = g[c0:c0 + chunk].double() * scale
            m = (1 - b1) * gc
            v = (1 - b2) * gc * gc
            mhat, vhat = m / (1 - b1), v / (1 - b2)
            hand = th - lr0 * (mhat / (vhat.sqrt() + eps) + wd * th)
            # beyond the float32 rounding of the master (an ulp of theta)
            err = (port[c0:c0 + chunk].double() - hand).abs() \
                - th.abs() * 2.0 ** -23
            worst = max(worst, float(err.max()))
        rel = worst / lr0 if lr0 else worst
        ok = ok and rel <= SETTLE_UPDATE_TOL
        leaves_d[paths[i]] = {"shape": list(gl[i].shape),
                              "max_err_over_lr": rel}
    out["d"] = {"lr": lr0, "grad_norm": norm, "clip_scale": scale,
                "leaves": leaves_d, "limit": SETTLE_UPDATE_TOL,
                "within": ok}
    emit({"phase": "families_train", "fault": "3e",
          "check": "(d) AdamW by hand, first update", **out["d"]})
    del params, state, fn, opt, grads, gl, before
    if not out["a"]["equal"] or not ok:
        raise AssertionError(f"fault 3e: a port fault: (a) {out['a']}, "
                             f"(d) {out['d']}")
    return out


def phase_families_train() -> dict:
    """Every architecture but nemotron-4-340b trained on the card at full
    width (``TRAIN_ARCHS``), one at a time and freed before the next.  For
    each: the dry run (``repro_torch.launch.dryrun.fit_depth``, fake
    tensors) picks the deepest cut whose predicted peak is within
    ``FIT_SHARE`` of the card's memory, and the roofline bounds its step;
    then the model is built with remat (the default) from the seed and
    takes ``FAMILY_TRAIN["steps"]`` steps of 4 x 1024 tokens (qwen2-vl 2 x
    2048) with the plan's optimizer (AdamW; Adafactor for dbrx), the
    encoder-decoder's and the vlm's batches carrying their frame and
    vision feeds (``launch.train.train_batch``).  The counts are set to 0
    just before the steps and read just after: under remat a MoE router's
    K5 (``topk_rows_short``) launches twice a MoE layer, microbatch and
    step (the forward and its recompute in the backward), and a dense
    stack launches no kernel.  Each loss finite, the last below the first.
    One line a model: depth, predicted and measured peak, step ms (CUDA
    events; the first step apart), the roofline's bound and the MFU.
    Then the remat check (``_remat_check``) and nemotron-4-340b's dry-run
    record, which does not fit (it takes no step).  Returns the launches."""
    import gc
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_zoo

    smi = card()
    capacity = torch.cuda.get_device_properties(0).total_memory
    limit = FIT_SHARE * capacity
    n_steps = FAMILY_TRAIN["steps"]
    launches: dict = {}
    for arch in TRAIN_ARCHS:
        full = get_config(arch)
        b, s = VLM_TRAIN if full.vision_prefix else (FAMILY_TRAIN["batch"],
                                                      FAMILY_TRAIN["seq"])
        shape = ShapeSpec("families_train", s, b, "train")
        plan = dryrun.train_plan(arch, shape)
        td = time.perf_counter()
        cfg, rec = dryrun.fit_depth(arch, shape, plan, limit)
        dry_s = time.perf_counter() - td
        row = roofline.analyze_record(rec)
        predicted = rec["memory"]["peak_bytes"]
        emit({"phase": "families_train", "model": arch,
              "dry_run": {"layers": cfg.n_layers, "of": full.n_layers,
                          "peak_gib": predicted / 2 ** 30,
                          "limit_gib": limit / 2 ** 30,
                          "traced": rec["traced"], "seconds": dry_s}})
        n_moe = (cfg.n_layers - cfg.moe.first_dense_layers
                 if cfg.moe is not None else 0)
        want = ({"topk_rows_short": 2 * n_moe * plan.microbatch * n_steps}
                if n_moe else {})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = model_zoo.build(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        fn, opt = steps_lib.make_train_step(
            model, cfg, shape, optimizer_name=plan.optimizer,
            microbatch=plan.microbatch,
            accum_dtype=(torch.bfloat16 if plan.accum == "bfloat16"
                         else torch.float32),
            peak_lr=family_lr(cfg), total_steps=n_steps)
        state = opt.init(params)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
        batches = [to_device(train_lib.train_batch(data, cfg, i, SEED),
                             "cuda") for i in range(n_steps)]
        losses, ms = [], []
        torch.cuda.synchronize()
        _build.reset_launches()
        for step in range(n_steps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            params, state, met = fn(params, state, step, batches[step])
            t1.record()
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        counts = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        if counts != want:
            raise AssertionError(f"families_train {arch}: launches {counts}, "
                                 f"expected {want}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"families_train {arch}: losses {losses} "
                                 f"not finite and falling")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if arch == FIXED_BATCH_ARCH:
            # the same steps again on one fixed batch: whether the losses'
            # rises above come from the batches (variance) or the steps
            del params, state, met
            torch.cuda.empty_cache()
            params = model.init(torch.Generator(device="cuda")
                                .manual_seed(SEED))
            state = opt.init(params)
            fixed = []
            for step in range(n_steps):
                params, state, met = fn(params, state, step, batches[0])
                fixed.append(float(met["loss"]))
            emit({"phase": "families_train", "model": arch,
                  "fixed_batch_losses": fixed,
                  "falls_at_each_step": all(
                      b_ < a for a, b_ in zip(fixed, fixed[1:])),
                  "varied_batch_losses": losses,
                  "peak_lr": family_lr(cfg)})
            del params, state, met
            torch.cuda.empty_cache()
            settle_3e(model, cfg, shape, plan, batches[0], n_steps)
            params = state = met = None
        step_ms = sum(ms[1:]) / len(ms[1:])
        emit({"phase": "families_train", "model": arch,
              "family": cfg.family, "layers": cfg.n_layers,
              "reduced": None if cfg.n_layers == full.n_layers else
              f"depth {full.n_layers} -> {cfg.n_layers} layers (dry run)",
              "n_params": cfg.n_params(), "tokens_a_step": b * s,
              "optimizer": plan.optimizer, "microbatch": plan.microbatch,
              "peak_lr": family_lr(cfg),
              "losses": losses, "first_step_ms": ms[0], "step_ms": step_ms,
              "steps_ms": ms, "tokens_s": b * s / step_ms * 1e3,
              "peak_gib": peak / 2 ** 30,
              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
              "predicted_peak_gib": predicted / 2 ** 30,
              "peak_over_predicted": peak / predicted,
              "bound_ms": row["t_bound_s"] * 1e3,
              "bound_by": row["dominant"],
              "mfu_bound": row["mfu_bound"],
              "mfu": roofline.mfu(row, step_ms / 1e3),
              "launches": counts, "nvidia_smi": smi})
        del model, params, state, fn, opt, met, batches
        torch.cuda.empty_cache()

    emit({"phase": "families_train", "check": "remat on vs off, float32",
          "max_abs_err": _remat_check(), "limit": REMAT_TOL})
    nemo = "nemotron-4-340b"
    shape = ShapeSpec("families_train", FAMILY_TRAIN["seq"],
                      FAMILY_TRAIN["batch"], "train")
    rec = dryrun.lower_cell(nemo, shape.name,
                            plan=dryrun.train_plan(nemo, shape), shape=shape,
                            capacity_bytes=limit, verbose=False)
    if rec["ok"]:
        raise AssertionError(f"{nemo}: the dry run fits it on one card")
    emit({"phase": "families_train", "model": nemo, "trained": False,
          "dry_run": {k: rec[k] for k in ("ok", "reason", "memory",
                                          "n_layers", "plan", "traced")}})
    return launches


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def cp_blocks(gen) -> list:
    """K6's context-parallel decomposition on the card: at each of
    ``ATTN_SHAPES`` x ``ATTN_HEADS`` (bf16), the whole causal output, then
    the queries cut into ``tp`` blocks (``CP_TPS``), block i at ``q_offset
    = i * S / tp`` against the whole K/V: the concatenation equal bit for
    bit to the whole (S / tp is a multiple of ``Q_BLOCK``, so a block's
    queries visit the whole's key tiles in its order), each block within
    K6's limits of its plain version and timed.  Returns the rows."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    rows = []
    n, r, h = ATTN_HEADS
    for b, s in ATTN_SHAPES:
        q, k, v = attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
        whole = fa.flash_rows(q, k, v)
        for tp in CP_TPS:
            blk = s // tp
            if blk % fa.Q_BLOCK:
                raise AssertionError(f"CP block {blk} not a multiple of "
                                     f"{fa.Q_BLOCK}")
            outs = []
            for i in range(tp):
                qb = q[:, i * blk:(i + 1) * blk].contiguous()
                off = i * blk
                got = fa.flash_rows(qb, k, v, off)
                outs.append(got)
                err = attn_within(got, fa.flash_rows_plain(qb, k, v, off),
                                  f"K6 CP block {i}/{tp} at {(b, s)}")
                ms, _ = cuda_ms(lambda: fa.flash_rows(qb, k, v, off), 10,
                                lead=True)
                pairs = fa.visible_pairs(blk, s, off)
                seen = min(off + blk, s)
                nbytes = (2 * qb.numel() + 2 * k.shape[0] * seen * h) * 2
                bound, by = _bound(nbytes, 4 * h * q.shape[0] * pairs,
                                   BF16_OPS_PER_S, q.shape[0] * pairs)
                rows.append({"shape": [b, s, n, r, h], "tp": tp, "block": i,
                             "q_offset": off, "ms": ms, "bound_ms": bound,
                             "bound_by": by, "max_abs_err": err[0],
                             "max_row_rel_err": err[1]})
                emit({"phase": "sharding", "cp_block": rows[-1]})
                del qb
            cat = torch.cat(outs, dim=1)
            if not torch.equal(cat, whole):
                raise AssertionError(f"K6 CP at {(b, s)} tp={tp}: the blocks "
                                     f"differ from the whole, max |diff| "
                                     f"{(cat.float() - whole.float()).abs().max().item()}")
            del outs, cat
        del q, k, v, whole
    return rows


def phase_sharding() -> dict:
    """The sharding policy on the card (one rank): a one-rank NCCL group
    and a (1, 1) ``("data", "model")`` DeviceMesh.  Minitron-4b served at
    full width with and without a ``ShardingPolicy`` (the launch counts set
    to 0 just before each serve and read just after), each decode step a
    replay of its captured graph (the policy's DTensor dispatch runs at
    capture only): the same tokens under the same uniforms, and the same
    K6 and K5 launches.  Then K6's
    context-parallel blocks (``cp_blocks``), and two full-width
    minitron-4b train steps at 2 layers with and without the policy: the
    first losses equal, the rest within ``SHARD_LOSS_REL``.  The group is destroyed at the end.
    Returns the launches of the serves and the steps."""
    import dataclasses
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model_zoo
    from repro_torch.sharding.partitioning import ShardingPolicy, full_tensor

    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_device_mesh((1, 1), device="cuda")
        policy = ShardingPolicy(mesh=mesh)
        emit({"phase": "sharding", "mesh": str(mesh),
              "backend": dist.get_backend()})
        outs, counts = {}, {}
        for name, pol in (("plain", None), ("policy", policy)):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            done, stats = srv.serve("minitron-4b", smoke=False, seed=SEED,
                                    device="cuda", flash_prefill=True,
                                    policy=pol, **SHARD_SERVE)
            torch.cuda.synchronize()
            counts[name] = dict(_build.launches)
            add(counts[name])
            graph = check_decode_graph(f"sharding {name} serve", stats,
                                       counts[name],
                                       SHARD_SERVE["decode_steps"])
            outs[name] = {r.rid: r.out.tolist() for r in done}
            emit({"phase": "sharding", "serve": name,
                  "requests": len(done), "batches": stats["batches"],
                  "launches": counts[name], **graph,
                  "prefill_ms": stats["prefill_ms"],
                  "decode_tok_s": stats["decode_tps"],
                  "seconds": time.perf_counter() - t0})
            del done, stats
            torch.cuda.empty_cache()
        if outs["plain"] != outs["policy"]:
            bad = [rid for rid in outs["plain"]
                   if outs["plain"][rid] != outs["policy"].get(rid)]
            raise AssertionError(f"sharding: the policy serve's tokens "
                                 f"differ for requests {bad}")
        for names, what in ((K6_NAMES, "K6"), (K5_NAMES, "K5")):
            a = {k: counts["plain"].get(k, 0) for k in names}
            b = {k: counts["policy"].get(k, 0) for k in names}
            if a != b or not sum(a.values()):
                raise AssertionError(f"sharding: {what} launches {b} under "
                                     f"the policy, {a} without")
        emit({"phase": "sharding", "tokens_equal": True,
              "k6_launches": {k: counts["policy"].get(k, 0)
                              for k in K6_NAMES},
              "k5_launches": {k: counts["policy"].get(k, 0)
                              for k in K5_NAMES}})

        gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
        cp_blocks(gen)
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(get_config("minitron-4b"),
                                  n_layers=SHARD_TRAIN["layers"])
        b, s = SHARD_TRAIN["batch"], SHARD_TRAIN["seq"]
        shape = ShapeSpec("sharding_train", s, b, "train")
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
        batch = to_device(train_lib.train_batch(data, cfg, 0, SEED), "cuda")
        losses = {}
        for name, pol in (("plain", None), ("policy", policy)):
            model = model_zoo.build(cfg, device="cuda", policy=pol)
            fn, opt = steps_lib.make_train_step(
                model, cfg, shape, peak_lr=family_lr(cfg),
                total_steps=SHARD_TRAIN["steps"] + 1)
            params = model.init(torch.Generator(device="cuda")
                                .manual_seed(SEED))
            state = opt.init(params)
            params, state = steps_lib.place_train_state(model, opt, params,
                                                        state)
            feed = steps_lib.place_batch(model, batch)
            torch.cuda.synchronize()
            _build.reset_launches()
            got = []
            for step in range(SHARD_TRAIN["steps"]):
                params, state, met = fn(params, state, step, feed)
                got.append(float(full_tensor(met["loss"])))
            add(dict(_build.launches))
            losses[name] = got
            del model, fn, opt, params, state, feed, met
            torch.cuda.empty_cache()
        rel = max(abs(a - b_) / abs(a) for a, b_ in zip(losses["plain"],
                                                        losses["policy"]))
        if not all(math.isfinite(x) for x in losses["policy"]) or \
                losses["plain"][0] != losses["policy"][0] or \
                rel > SHARD_LOSS_REL:
            raise AssertionError(f"sharding: train losses {losses}")
        emit({"phase": "sharding", "train": f"minitron-4b, "
              f"{SHARD_TRAIN['layers']} layers, {b} x {s} tokens",
              "losses": losses, "max_rel_diff": rel,
              "limit": SHARD_LOSS_REL})
    finally:
        dist.destroy_process_group()
    return launches


def phase_data(rng) -> dict:
    """Dedup of 2^20 token rows of 128 with a tenth of the rows planted as
    copies of others: ``dedup_rows`` on K3 (``method="radix"``: its
    ``unique`` one histogram and 4 passes, exactly) and on the ``auto``
    plan, and ``global_dedup`` through the spill tier in 4 chunks (K3 a
    chunk, every K2 merge a partition launch and a merge launch); every
    keep-mask equal to a numpy brute force over the rows themselves.
    Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.data import pipeline
    from repro_torch.engine import planner
    from repro_torch.kernels import _build

    tokens = rng.integers(0, 163840, (DATA_ROWS, DATA_SEQ), dtype=np.int32)
    n_dup = int(DATA_ROWS * DATA_DUP)
    dst = rng.choice(DATA_ROWS, n_dup, replace=False)
    keep_rows = np.setdiff1d(np.arange(DATA_ROWS), dst)
    tokens[dst] = tokens[rng.choice(keep_rows, n_dup)]
    t0 = time.perf_counter()
    rows = np.ascontiguousarray(tokens).view(
        np.dtype((np.void, 4 * DATA_SEQ)))[:, 0]
    _, first = np.unique(rows, return_index=True)
    brute = np.zeros(DATA_ROWS, bool)
    brute[first] = True
    brute_s = time.perf_counter() - t0
    plan = planner.choose_relational("unique", DATA_ROWS,
                                     dtype=torch.uint32, device="cuda")
    emit({"phase": "data", "rows": DATA_ROWS, "seq": DATA_SEQ,
          "planted_duplicates": n_dup, "distinct": int(brute.sum()),
          "brute_force_s": brute_s, "unique_auto_plan": plan.method,
          "nvidia_smi": card()})
    launches: dict = {}

    def run(name, fn, check):
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        keep = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = dict(_build.launches)
        check(counts)
        if not np.array_equal(keep, brute):
            raise AssertionError(f"{name}: keep-mask differs from the brute "
                                 f"force at {np.flatnonzero(keep != brute)[:5]}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        emit({"phase": "data", "call": name, "seconds": seconds,
              "kept": int(keep.sum()), "launches": counts})

    def k3_exact(counts):
        want = {"radix_onesweep_hist": 1, "radix_onesweep_pass": 4}
        if counts != want:
            raise AssertionError(f"dedup_rows radix: launches {counts}, "
                                 f"expected {want}")

    def spill_k3_k2(counts):
        chunks = DATA_ROWS * 4 // DATA_CHUNK
        check_k3_sorts("global_dedup", counts, 4)
        part = counts.get("merge_path_partition", 0)
        merges = counts.get("merge_pairs_kv_blocks", 0) \
            + counts.get("merge_pairs_blocks", 0)
        if counts.get("radix_onesweep_hist", 0) != chunks or part == 0 or \
                part != merges:
            raise AssertionError(f"global_dedup: launches {counts}, expected "
                                 f"{chunks} K3 sorts and a K2 partition a "
                                 f"merge")

    run("dedup_rows radix", lambda: pipeline.dedup_rows(
        tokens, method="radix"), k3_exact)
    run(f"dedup_rows auto ({plan.method})",
        lambda: pipeline.dedup_rows(tokens),
        lambda c: check_k3_sorts("dedup_rows auto", c,
                                 4 if plan.method == "radix" else None))
    run("global_dedup radix, 4 chunks", lambda: pipeline.global_dedup(
        tokens, chunk_bytes=DATA_CHUNK, method="radix"), spill_k3_k2)
    del tokens, rows, brute
    return launches


# ---------------------------------------------------------------------------
# phase 6: the spill tier, above the default threshold
# ---------------------------------------------------------------------------

SPILL_N = 3 << 29          # float32 keys of the auto spill sort: 6 GiB
SPILL_KV_N = 1 << 30       # int32 keys in [0, 2^20): argsort, sort_kv
SPILL_KV_KEYS = 1 << 20
SPILL_KV_CHUNK = 1 << 28   # bytes a chunk: 16 runs of 2^26 keys
SPILL_SMALL = 1 << 24      # the bfloat16 and the NaN-holding float32 runs
SPILL_SMALL_CHUNK = 1 << 22
LINK_BYTES = 1 << 30       # one plain pinned copy each way


def _release_pinned() -> None:
    """Hand cached pinned host blocks back (where torch has the call)."""
    import gc
    import torch
    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def spill_reference(x, chunk, descending, chunk_order):
    """What the spill tier must return for ``x`` on the card, built from
    ``torch.sort(stable=True)``: each chunk sorted as its plan sorts it
    (``chunk_order(c)``: the chunk's sorted keys), then the runs merged by
    one stable ``torch.sort`` of their concatenation on the reference
    merge's order (``merge.order_key``: -0.0 with +0.0, NaN last), ties in
    run order.  For keys without signed zeros or NaN this is
    ``torch.sort(x, stable=True)`` itself."""
    import torch
    from repro_torch.engine.merge import order_key
    cat = torch.cat([chunk_order(x[s:s + chunk].cuda())
                     for s in range(0, x.numel(), chunk)])
    idx = torch.sort(order_key(cat), stable=True,
                     descending=descending).indices
    return cat[idx]


def total_order_sorted(c):
    """A chunk as ``radix`` sorts it: stable, on the IEEE total order
    (-0.0 below +0.0, ``keycodec``'s order)."""
    import torch
    from repro_torch.core import keycodec
    return c[torch.sort(keycodec.total_order_key(c), stable=True).indices]


def host_trace(fn, top: int = 10) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms, the ops
    that took the most host time (self CPU ms) and what took the card's
    time (kernels and copies, device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    host, card = [], []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", 0) / 1e3
        if own > 0 and e.device_type == DeviceType.CUDA:
            card.append((e.key[:60], e.count, own))
        elif e.self_cpu_time_total > 0:
            host.append((e.key[:60], e.count, e.self_cpu_time_total / 1e3))
    host.sort(key=lambda r: -r[2])
    card.sort(key=lambda r: -r[2])
    return {"wall_ms": wall, "host_ms": host[:top], "card_ms": card[:top]}


def phase_spill(rng) -> dict:
    """The spill tier at sizes above the default 4 GiB threshold, inputs
    on the host: ``repro_torch.sort.sort(method="auto")`` of 3 x 2^29
    float32 (two uneven chunks; the plan must be ``spill``),
    ``spill_argsort`` and ``spill_sort_kv`` of 2^30 int32 keys in [0,
    2^20) at 2^28-byte chunks (16 runs, the grouped merge width), both
    ways, and a bfloat16 and a NaN-holding float32 run.  Each call runs
    once traced with the launch counts set to 0 just before and read just
    after (K3: one histogram and a pass a digit a chunk sort; K2: a
    partition launch a merge launch), is held bit for bit against
    ``torch.sort(stable=True)`` of the same keys on the card (sorted keys,
    and the permutation against its indices), and prints its phase times,
    overlap fraction and link bytes beside the link's plain rate.
    Returns the launches."""
    import numpy as np
    import torch
    import repro_torch.sort as rsort
    from repro_torch import engine
    from repro_torch.engine import spill
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics, trace

    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=30).stdout
    emit({"phase": "spill", "free_g": free.split("\n")[:3],
          "threshold_bytes": engine.planner._tuning.active()
          .spill_threshold_bytes})
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_BYTES, dtype=torch.uint8, device="cuda")
    h2d_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 3)[0]
    d2h_ms = cuda_ms(lambda: host.copy_(dev, non_blocking=True), 3)[0]
    rate = {"h2d": LINK_BYTES / h2d_ms * 1e3, "d2h": LINK_BYTES / d2h_ms * 1e3}
    emit({"phase": "spill", "link": "pinned copy_ of 1 GiB",
          "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
          "h2d_GB_s": rate["h2d"] / 1e9, "d2h_GB_s": rate["d2h"] / 1e9})
    del host, dev
    launches: dict = {}

    def run(name, fn, payload, chunks, passes):
        """One traced call, the counts set to 0 just before and read just
        after.  ``chunks`` K3 chunk sorts of ``passes`` passes each (None:
        no K3, the NaN run's chunks sort on torch.sort); every K2 merge a
        partition launch and a merge launch."""
        torch.cuda.synchronize()
        metrics.reset()
        trace.clear()
        _build.reset_launches()
        trace.enable()
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            trace.disable()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        check_k3_sorts(name, counts, passes)
        hist = counts.get("radix_onesweep_hist", 0)
        if hist != (chunks or 0):
            raise AssertionError(f"{name}: {hist} K3 sorts, expected "
                                 f"{chunks} chunk sorts ({counts})")
        part = counts.get("merge_path_partition", 0)
        merges = counts.get("merge_pairs_blocks", 0) \
            + counts.get("merge_pairs_kv_blocks", 0)
        if part == 0 or part != merges:
            raise AssertionError(f"{name}: K2 launches {counts}, expected "
                                 f"a partition launch a merge launch")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        h2d = metrics.counter("spill.h2d_bytes").value
        d2h = metrics.counter("spill.d2h_bytes").value
        emit({"phase": "spill", "call": name, "launches": counts,
              "traced_wall_ms": wall,
              "spill_phase_ms": metrics.gauge("spill.spill_phase_ms").value,
              "merge_phase_ms": metrics.gauge("spill.merge_phase_ms").value,
              "overlap_fraction":
                  metrics.gauge("spill.overlap_fraction").value,
              "h2d_bytes": h2d, "d2h_bytes": d2h,
              "four_x_payload_bytes": 4 * payload,
              "link_bound_ms": (h2d / rate["h2d"] + d2h / rate["d2h"]) * 1e3,
              "merge_blocks": sum(1 for sp in trace.spans()
                                  if sp["name"] == "spill.merge_block")})
        trace.clear()
        metrics.reset()
        return out

    # 6 GiB of float32 through the front door: the plan must be spill
    x = torch.from_numpy(rng.standard_normal(SPILL_N, dtype=np.float32))
    plan = engine.choose(SPILL_N, 1, torch.float32, device="cuda")
    emit({"phase": "spill", "auto_plan_3x2^29_float32": plan.method,
          "costs_ns": plan.costs})
    if plan.method != "spill":
        raise AssertionError(f"6 GiB float32: plan {plan.method}, not spill")
    # its chunk sorts are planned as any sort of their size: torch.sort
    # under the seed (priced as the radix sort it is on the card, below
    # K3), K3 where a profile prices K3 lower
    chunk_plan = engine.choose(spill.chunk_elems(4), 1, torch.float32,
                               device="cuda").method
    on_k3 = chunk_plan == "radix"
    emit({"phase": "spill", "chunk_plan_2^30_float32": chunk_plan})
    out = run("sort auto 3x2^29 float32", lambda: rsort.sort(x), x.nbytes,
              2 if on_k3 else None, 4 if on_k3 else None)
    if out.device.type != "cpu":
        raise AssertionError("spill sort: the result is not on the host")
    # untraced, on the pinned blocks the traced call left cached: the
    # pipeline's wall time each way, alternating, the same bits
    for overlap in (True, False, False, True):
        t0 = time.perf_counter()
        again = spill.spill_sort(x, overlap=overlap)
        emit({"phase": "spill", "call": f"sort 3x2^29 float32 overlap="
              f"{overlap} (untraced)",
              "wall_ms": (time.perf_counter() - t0) * 1e3})
        if not torch.equal(again.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"spill sort: overlap={overlap} differs")
        del again
    emit({"phase": "spill", "trace": "warm sort 3x2^29 float32",
          **host_trace(lambda: spill.spill_sort(x))})
    _release_pinned()
    # the radix chunk sorts order -0.0 below +0.0 (numpy's float32 normals
    # hold a few signed zeros), torch.sort's keep their input order, the
    # merge treats them as equal
    want = spill_reference(
        x, spill.chunk_elems(4), False, total_order_sorted if on_k3 else
        (lambda c: torch.sort(c, stable=True).values))
    del x
    same_bits(out.cuda(), want, "spill sort 3x2^29 vs torch.sort")
    del out, want
    torch.cuda.empty_cache()
    _release_pinned()

    # 2^30 int32 keys with ties: argsort and sort_kv, both ways
    k = torch.from_numpy(rng.integers(0, SPILL_KV_KEYS, SPILL_KV_N)
                         .astype(np.int32))
    p = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, SPILL_KV_N)
                         .astype(np.int32))
    chunks = SPILL_KV_N * 4 // SPILL_KV_CHUNK
    for desc in (False, True):
        kd = k.cuda()
        ref = torch.sort(kd, stable=True, descending=desc)
        want_k, want_i = ref.values, ref.indices.to(torch.int32)
        del ref, kd
        # K3's own rows: auto plans torch.sort's chunk sorts under the seed
        order = run(f"spill_argsort 2^30 int32 desc={desc} radix",
                    lambda: spill.spill_argsort(k, descending=desc,
                                                chunk_bytes=SPILL_KV_CHUNK,
                                                method="radix"),
                    2 * k.nbytes, chunks, 4)
        same_bits(order.cuda(), want_i, f"spill argsort desc={desc}")
        del order
        _release_pinned()
        sk, sv = run(f"spill_sort_kv 2^30 int32 desc={desc} radix",
                     lambda: spill.spill_sort_kv(
                         k, p, descending=desc, chunk_bytes=SPILL_KV_CHUNK,
                         method="radix"),
                     2 * k.nbytes, chunks, 4)
        same_bits(sk.cuda(), want_k, f"spill sort_kv keys desc={desc}")
        del sk
        same_bits(sv.cuda(), p.cuda()[want_i.long()],
                  f"spill sort_kv payload desc={desc}")
        del sv, want_k, want_i
        torch.cuda.empty_cache()
        _release_pinned()
    del k, p

    # bfloat16 (its order code through the pipeline) and float32 with NaN
    # (torch.sort chunk sorts, merges on the order key), small chunks
    b = torch.randn(SPILL_SMALL, generator=torch.Generator().manual_seed(
        SEED)).to(torch.bfloat16)
    out = run("spill_sort 2^24 bfloat16 radix", lambda: spill.spill_sort(
        b, chunk_bytes=SPILL_SMALL_CHUNK, method="radix"), b.numel() * 2,
        SPILL_SMALL * 2 // SPILL_SMALL_CHUNK, 2)
    same_bits(out.cuda(), total_order_sorted(b.cuda()),
              "spill sort bfloat16 (its order code: the total order)")
    f = torch.from_numpy(rng.standard_normal(SPILL_SMALL, dtype=np.float32))
    f[::1001] = float("nan")
    out = run("spill_sort 2^24 float32 NaN desc=True", lambda:
              spill.spill_sort(f, descending=True,
                               chunk_bytes=SPILL_SMALL_CHUNK * 2),
              f.numel() * 4, None, None)
    same_bits(out.cuda(), spill_reference(
        f, SPILL_SMALL_CHUNK * 2 // 4, True,
        lambda c: torch.sort(c, stable=True).values.flip(-1)),
        "spill sort NaN descending")
    del b, f, out
    torch.cuda.empty_cache()
    _release_pinned()
    return launches


# ---------------------------------------------------------------------------
# phase 7: calibration, and what it would move
# ---------------------------------------------------------------------------

CAL_SHAPES = (("default (64, 2048)", 2048, 64),
              ("card (4096, 4096)", 4096, 4096))


def phase_calibrate(main_steps, rel_ms) -> None:
    """``planner.calibrate`` at the reference's default probe (64, 2048)
    and at a card-scale one (4096, 4096): constants, probes and sweeps;
    then the plans the seed profile and each calibrated profile choose at
    this script's shapes, each beside the ms measured for its candidates
    (the sorts and top-k timed here on the card, the relational ops from
    phase 4); then the card-scale profile persisted to a temporary
    ``REPRO_TORCH_TUNING_DIR``, loaded by a fresh process (``source ==
    "persisted"``, the same fingerprint), and ``reset_calibration()``: the
    later phases run on the seeds."""
    import dataclasses
    import tempfile
    import torch
    import repro_torch.sort as rsort
    from repro_torch.core import tuning
    from repro_torch.engine import planner

    seed = tuning.active()
    profiles = {"seed": seed}
    for label, tile_n, batch in CAL_SHAPES:
        t0 = time.perf_counter()
        prof = planner.calibrate(tile_n=tile_n, batch=batch)
        emit({"phase": "calibrate", "profile": label,
              "seconds": time.perf_counter() - t0,
              "constants": dataclasses.asdict(prof.constants),
              "digit_bits": prof.digit_bits, "run_len": prof.run_len,
              "merge_fanin": prof.merge_fanin,
              "select_min_n": prof.select_min_n, "probe_ns": prof.probe_ns,
              "sweeps": prof.sweeps, "not_swept": planner.NOT_SWEPT})
        profiles[label] = prof
    planner.reset_calibration()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    steps = {s["step"]: s["ms"] for s in main_steps}
    n_lines = rel_ms["n"]["lineitems"]
    cases = [
        ("sort 2^28 float32", MAIN_N, 1, torch.float32, None),
        ("argsort 2^26 int32", KV_N, 1, torch.int32, None),
        ("topk (8, 256000) k=50", 256000, 8, torch.float32, 50),
        ("topk (64, 128256) k=50", VOCAB[1], VOCAB[0], torch.float32, 50),
        ("topk (16384, 64) k=8", ROUTER[1], ROUTER[0], torch.float32, 8),
    ]
    for name, n, batch, dtype, k in cases:
        plans = {}
        for label, prof in profiles.items():
            tuning.set_active(prof)
            planner.clear_plan_cache()
            p = planner.choose(n, batch, dtype, k=k, device="cuda")
            plans[label] = {"method": p.method,
                            "predicted_ms": p.costs[p.method] / 1e6}
        tuning.set_active(seed)
        planner.clear_plan_cache()
        cands = []
        for m in sorted(p.costs):
            be = rsort.get_backend(m)
            if k is None and be.capabilities.supports_sort \
                    and be.eligible(n, dtype, p.run_len):
                cands.append(m)
            elif k is not None and be.capabilities.supports_topk \
                    and be.topk_eligible(n, k, dtype, p.run_len):
                cands.append(m)
        shape = (batch, n) if batch > 1 else (n,)
        if dtype == torch.float32:
            x = torch.randn(shape, generator=gen, device="cuda")
        else:
            x = torch.randint(0, 4096, shape, generator=gen, device="cuda",
                              dtype=torch.int32)
        measured = {}
        for m in cands:
            if k is not None:
                fn = (lambda m=m: rsort.topk(x, k, method=m))
            elif dtype == torch.int32:
                fn = (lambda m=m: rsort.argsort(x, method=m))
            else:
                fn = (lambda m=m: rsort.sort(x, method=m))
            measured[m] = cuda_ms(fn, 5, lead=True)[0]
        del x
        emit({"phase": "calibrate", "plan_table": name, "plans": plans,
              "measured_ms": measured})
    for op, n in (("unique", n_lines), ("group_by", n_lines),
                  ("join", n_lines), ("rle", TPCH_ORDERS),
                  ("delta", TPCH_ORDERS)):
        plans = {}
        for label, prof in profiles.items():
            tuning.set_active(prof)
            planner.clear_plan_cache()
            p = planner.choose_relational(op, n, dtype=torch.int32,
                                          device="cuda")
            plans[label] = {"method": p.method,
                            "predicted_ms": p.costs[p.method] / 1e6}
        tuning.set_active(seed)
        planner.clear_plan_cache()
        emit({"phase": "calibrate", "plan_table": f"{op} n={n} (SF10)",
              "plans": plans,
              "measured_ms": {key: val for key, val in rel_ms.items()
                              if key.startswith(op)}})
    emit({"phase": "calibrate", "main_phase_ms": {
        key: steps[key] for key in ("sort merge 2^28 float32",
                                    "argsort merge 2^26 int32 desc=False",
                                    "sort_kv radix 2^26 uint32")}})

    # persisted, then resolved by a fresh process
    with tempfile.TemporaryDirectory() as d:
        card = profiles[CAL_SHAPES[1][0]]
        path = tuning.save(card, tuning.profile_path(d))
        code = ("import json; from repro_torch.core import tuning; "
                "p = tuning.active(); print(json.dumps({'source': p.source, "
                "'fingerprint': p.fingerprint, 'run_len': p.run_len}))")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                 tuning.PROFILE_DIR_ENV: d})
        if out.returncode != 0:
            raise AssertionError(f"calibrate: the fresh process failed: "
                                 f"{out.stderr[-2000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        emit({"phase": "calibrate", "persisted": os.path.basename(path),
              "fresh_process": got})
        if got["source"] != "persisted" \
                or got["fingerprint"] != card.fingerprint:
            raise AssertionError(f"calibrate: a fresh process resolved "
                                 f"{got}, not the persisted {card.fingerprint}")
    planner.reset_calibration()


# ---------------------------------------------------------------------------
# phase 8: timing at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_ms(fn, reps: int):
    """:func:`cuda_ms` with the card's head start: a kernel table row's
    time is the card's."""
    return cuda_ms(fn, reps, lead=True)


def _bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S,
           ex2: float = 0):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the card's peak rate for their type (FP32 by
    default; K7's logic ops are INT32), and exponentials over the
    exponent unit's rate (K6's ``ex2``, one a visible score)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(ops / ops_per_s, ex2 / MUFU_EX2_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def search_rounds(n: int) -> int:
    """Dependent rounds of K3's 33-ary search over n sorted keys: each
    leaves at most ceil(len / 33) keys, until 32 or fewer are read at
    once."""
    rounds = 1
    while n > 32:
        n, rounds = -(-n // 33), rounds + 1
    return rounds


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
            err=0.0, ops_per_s=FP32_OPS_PER_S, check=None, ex2=0, **extra):
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
        b, by = _bound(nbytes, ops, ops_per_s, ex2)
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

    # K3's bucket histogram at the flat sample sort's shape: one sorted
    # 2^25-key shard of signed-order keys against the 7 splitters of an
    # 8-entry mesh; torch.searchsorted of the splitters, the binary-search
    # route, is the library call.  Its bound: the bytes the search needs,
    # 32 keys a splitter a round (5 dependent rounds at 2^25 keys: latency,
    # not bytes, is its real limit), the splitters and the counts
    shard = torch.sort(torch.randint(-(1 << 31), 1 << 31,
                                     (DIST_N // DIST_ENTRIES,), generator=gen,
                                     device="cuda", dtype=torch.int64)
                       .to(torch.int32)).values
    sp = shard[torch.arange(1, DIST_ENTRIES, device="cuda")
               * (shard.numel() // DIST_ENTRIES)].contiguous()
    rounds = search_rounds(shard.numel())
    row("radix_bucket_hist", "src/repro_torch/csrc/radix_sort.cu",
        "src/repro/kernels/radix_sort.py:123",
        lambda: (rsk.bucket_hist(shard, sp),),
        lambda: (rsk.bucket_hist_plain(shard, sp),),
        sp.numel() * (rounds * 32 + 1) * 4 + (DIST_ENTRIES + 1) * 4, 0,
        lambda: torch.searchsorted(shard, sp, right=True),
        keys=shard.numel(), buckets=DIST_ENTRIES, search_rounds=rounds,
        used_by="src/repro/engine/samplesort.py:130")
    del shard, sp

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
    """K6's kernel-table rows: minitron's serve prefill batch, (8, 1024) x
    24/8 heads of 128, prefill_32k's length at batch 1, moonshot's
    prefill batch, (8, 1024) x 16/16 heads of 128, and the families
    phase's wide heads at (8, 1024): gemma-2b's 8/1 of 256 and
    nemotron-4-340b's 96/8 of 192, then 8/8 of 32 and of 16 (the narrow
    widths), bf16, all on the wgmma kernel; beside SDPA on the same (B, N,
    S, H) tensors (causal from position 0: S = T).  Bound: the largest of
    q, k, v and o read or written once over the memory rate, QK^T and PV
    over the visible scores (4 H flops each) over the bf16 tensor rate,
    and one exp2 a visible score over the exponent unit's rate (it bounds
    H = 16 and 32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    def terms(nbytes, pairs, h):
        return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                "flops": 4 * h * pairs / BF16_OPS_PER_S * 1e3,
                "ex2": pairs / MUFU_EX2_PER_S * 1e3}

    for (b, s), (n, r, h) in K6_ROWS:
        q, k, v = attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
        q4, k4, v4 = (x.view(b, -1, s, h) for x in (q, k, v))
        pairs = b * n * fa.visible_pairs(s, s)
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2
        row("flash_attention_fwd", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:101",
            lambda: (fa.flash_rows(q, k, v),),
            lambda: (fa.flash_rows_plain(q, k, v),),
            nbytes, 4 * h * pairs,
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                   enable_gqa=True),
            ops_per_s=BF16_OPS_PER_S, check=attn_within, ex2=pairs,
            shape=[b, s, n, r, h], dtype="bfloat16",
            bound_terms_ms=terms(nbytes, pairs, h))
        del q, k, v, q4, k4, v4
    # the last context-parallel block of minitron's prefill shapes at the
    # widest split: its queries at q_offset = 7 S / 8 see every key.
    # SDPA takes the block's causal mask and K/V repeated to the query
    # heads (its memory-efficient kernel; it has no offset argument)
    n, r, h = ATTN_HEADS
    tp = CP_TPS[-1]
    for b, s in ATTN_SHAPES:
        blk = s // tp
        off = s - blk
        q, k, v = attn_rows(gen, b * r, n // r, s, s, h, torch.bfloat16)
        qb = q[:, off:].contiguous()
        del q
        q4 = qb.view(b, n, blk, h)
        k4, v4 = (x.view(b, r, s, h).repeat_interleave(n // r, dim=1)
                  for x in (k, v))
        pos = torch.arange(s, device="cuda")
        mask = pos[None, :] <= (off + pos[:blk])[:, None]
        pairs = b * n * fa.visible_pairs(blk, s, off)
        nbytes = (2 * qb.numel() + 2 * k.numel()) * 2
        row("flash_attention_fwd", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:101",
            lambda: (fa.flash_rows(qb, k, v, off),),
            lambda: (fa.flash_rows_plain(qb, k, v, off),),
            nbytes, 4 * h * pairs,
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask),
            ops_per_s=BF16_OPS_PER_S, check=attn_within, ex2=pairs,
            shape=[b, s, n, r, h], dtype="bfloat16", q_offset=off,
            cp_block=f"{tp - 1} of {tp}",
            bound_terms_ms=terms(nbytes, pairs, h))
        del qb, k, v, q4, k4, v4, mask


# sources whose kernels must keep everything in registers: no stack frame,
# no spills (K7's rows, K1's 16 keys a thread, K5's runs and composites,
# K6's accumulators, K2's 16 merged outputs a thread, K4's vectors in
# flight)
NO_SPILLS = ("bitserial_cas", "bitonic_sort", "bitonic_topk",
             "flash_attention", "merge_path", "radix_select")


def check_ptxas(_build) -> None:
    """Print what ``ptxas -v`` said of the K7, K3, K1, K5, K6, K2 and K4
    kernels (registers, stack frame, spills), one line a kernel, the K6
    wgmma kernels' at H = 192 and 256, and at 16 and 32, once more on a
    line of their own (ptxas counts the launch bound's 168 registers a
    thread there: ``check_k6_sass`` reads what the consumers use after
    setmaxnreg), and
    K6's build warnings and performance notes; fail unless every kernel of
    ``NO_SPILLS`` has no stack frame and no spills, and if ptxas
    serialised K6's wgmma products (its C7520 note: the products then run
    one after another with nothing overlapping them)."""
    import re
    bad, wide, narrow = [], {}, {}
    for name in ("bitserial_cas", "radix_sort") + NO_SPILLS[1:]:
        for u in _build.ptxas_usage(name):
            emit({"phase": "build", "ptxas": name, **u})
            if name in NO_SPILLS and (
                    u.get("stack") != 0 or u.get("spill_stores") != 0
                    or u.get("spill_loads") != 0):
                bad.append(u["kernel"])
            h = re.search(r"flash_wgmma_kernel<[^,]+, (\(int\))?(\d+)>",
                          u["kernel"])
            if h and h.group(2) in ("192", "256", "16", "32"):
                (wide if int(h.group(2)) > 128 else narrow)[u["kernel"]] = {
                    k: u.get(k) for k in ("registers", "stack",
                                          "spill_stores", "spill_loads")}
    emit({"phase": "build", "ptxas_k6_wide_wgmma": wide})
    emit({"phase": "build", "ptxas_k6_narrow_wgmma": narrow})
    if len(wide) != 4 or len(narrow) != 4:
        raise AssertionError(f"K6's wgmma kernels at H = 16 / 32 / 192 / "
                             f"256 in bf16 and fp16: found {sorted(wide)}, "
                             f"{sorted(narrow)}")
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


K6_SASS_HEADS = (16, 32, 128, 192, 256)


def check_k6_sass(_build) -> None:
    """K6's bf16 kernels at H = 128 (the serve's), 192 (nemotron-4-340b's),
    256 (gemma-2b's, recurrentgemma-2b's), 32 and 16 (the narrow widths)
    must run their products on ``wgmma`` (``HGMMA`` in the SASS) fed by
    TMA (``UTMALDG``); prints
    both counts for every wgmma kernel, fp16's too, and the highest
    register a kernel's machine code names (its consumers' use after
    setmaxnreg, which ``ptxas -v`` does not report)."""
    import re
    funcs = sass_functions(_build.sass("flash_attention"))
    found = set()
    for name, ins in funcs.items():
        if "flash_wgmma_kernel" not in name:
            continue
        ops = [op for _, op, _ in ins]
        counts = {"HGMMA": ops.count("HGMMA"), "UTMALDG": ops.count("UTMALDG")}
        top = max((int(r) for _, _, t in ins
                   for r in re.findall(r"\bR(\d+)\b", t)), default=-1)
        emit({"phase": "build", "sass": name, **counts,
              "highest_register": top})
        for h in K6_SASS_HEADS:
            if "__nv_bfloat16" in name and f"Li{h}E" in name:
                found.add(h)
                if not all(counts.values()):
                    raise AssertionError(f"K6 bf16 H={h} kernel {name}: "
                                         f"{counts}, needs HGMMA and "
                                         f"UTMALDG")
    if found != set(K6_SASS_HEADS):
        raise AssertionError(f"bf16 wgmma kernels at H = {K6_SASS_HEADS}: "
                             f"found {sorted(found)} among {sorted(funcs)}")


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
    cols = tpch_columns(rng)
    rel_launches, rel_ms = phase_relational(rng, cols)
    emit({"phase": "relational", "total_launches": rel_launches,
          "seconds": time.perf_counter() - tr})

    td = time.perf_counter()
    dist_launches = phase_distributed(np.random.default_rng((SEED, 22)),
                                      cols)
    del cols
    torch.cuda.empty_cache()
    emit({"phase": "distributed", "total_launches": dist_launches,
          "seconds": time.perf_counter() - td})

    ts = time.perf_counter()
    serve_launches = phase_serve()
    emit({"phase": "serve", "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    moe_launches = phase_moe_serve()
    emit({"phase": "moe_serve", "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    family_launches = phase_families()
    emit({"phase": "families", "total_launches": family_launches,
          "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    train_launches = phase_train()
    emit({"phase": "train", "total_launches": train_launches,
          "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    families_train_launches = phase_families_train()
    emit({"phase": "families_train",
          "total_launches": families_train_launches,
          "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    torch.cuda.empty_cache()
    sharding_launches = phase_sharding()
    emit({"phase": "sharding", "total_launches": sharding_launches,
          "seconds": time.perf_counter() - ts})

    ts = time.perf_counter()
    data_launches = phase_data(rng)
    emit({"phase": "data", "total_launches": data_launches,
          "seconds": time.perf_counter() - ts})

    tp = time.perf_counter()
    spill_launches = phase_spill(rng)
    emit({"phase": "spill", "total_launches": spill_launches,
          "seconds": time.perf_counter() - tp})

    tc = time.perf_counter()
    phase_calibrate(main_res["steps"], rel_ms)
    emit({"phase": "calibrate", "seconds": time.perf_counter() - tc})
    if tuning.active() != prof:
        raise AssertionError("calibrate: the seed profile was not restored")

    launches = dict(main_res["launches"])
    for counts in (rel_launches, dist_launches, serve_launches, moe_launches,
                   family_launches, train_launches, families_train_launches,
                   sharding_launches, data_launches, spill_launches):
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
