"""Spill-to-host tier — sorts larger than the card can hold.

The same structure as the JAX package's tier, one level above the card's
memory:

    cut     the host-resident input into chunks of the profile's
            ``spill_threshold_bytes`` (the knob the planner routes on),
    sort    each chunk on the device through the engine (``method="auto"``:
            whatever the planner prices cheapest at the chunk size),
    spill   each sorted run back to pinned host memory while the next
            chunk sorts: chunk ``i+1``'s copy up and sort are queued before
            the host waits for run ``i``'s copy down,
    merge   the host runs with a k-way merge-path: exact stable cursors of
            every run at each output-block boundary (bisection over cross-
            run binary searches on the host), each block's slices merged on
            the device by the engine's tournament (``merge.kway_merge_kv``,
            K2 on a card) at most ``merge_fanin`` runs at a time.

On a card the copies run on two side streams: up (host -> card, from
pinned memory) and down (card -> pinned host memory), ordered against the
compute stream with events, and every tensor that crosses streams is
handed over with ``record_stream``.  A pageable input is staged through
two pinned buffers in turn.  On the CPU (``device="cpu"``) the same
pipeline runs without copies.

Results are **CPU tensors**: an out-of-core sort that ended with one array
on the card would defeat itself.  Keys are exactly the reference's bits:
uint16/uint32 ride as their order-preserving signed carriers, bfloat16 as
its order-embedding code (``keycodec.encode``, descending folded in, the
pipeline always ascending), decoded bit for bit at the end.  Float inputs
that hold NaN sort their chunks on ``torch.sort`` (NaN last, as the
reference's ``xla``) and merge on ``merge.order_key``.

Observability (when ``repro_torch.obs`` tracing is on): a ``spill.sort``
(``spill.sort_kv``) span over the pipeline with a ``spill.chunk`` span a
chunk and a ``spill.merge_block`` span a block; ``spill.h2d_bytes`` /
``spill.d2h_bytes`` count every byte handed to and taken back from the
sorting device (a card input's chunks cross nothing); the
``spill.overlap_fraction`` gauge is the share of the spill phase's wall
time the host did not spend waiting on the link (1.0: transfers hidden
behind the chunk sorts); ``spill.spill_phase_ms`` / ``spill.merge_phase_ms``
are the two phases' wall times (the merge phase's until its last copy
down has landed).

``codec="int8"`` (or an ``(encode, decode)`` pair) keeps runs quantized on
the host, per run, as the optimizer's int8 gradient codec does: monotonic,
so runs stay sorted, but lossy — opt-in, never part of auto dispatch.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import keycodec
from repro_torch.core import tuning as _tuning
from repro_torch.core.sortspec import resolve_device
from repro_torch.engine import merge as _merge
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs

__all__ = [
    "chunk_elems", "spill_sort", "spill_sort_kv", "spill_argsort",
    "sort_rows", "sort_rows_kv", "argsort_rows",
]

# outputs of one merged block, at most: every padded run of its tournament
# then stays within K2's int32 positions (2L < 2^31), and a block of
# uneven slices (padded to the widest) within a few GiB of the card
MAX_MERGE_BLOCK = 1 << 26


def chunk_elems(itemsize: int, chunk_bytes: Optional[int] = None) -> int:
    """Elements of one width a device chunk holds.  ``chunk_bytes``
    defaults to the profile's ``spill_threshold_bytes``: the chunks are the
    largest arrays the planner does not spill."""
    cb = chunk_bytes if chunk_bytes is not None \
        else _tuning.active().spill_threshold_bytes
    if cb < _tuning.MIN_SPILL_THRESHOLD_BYTES:
        raise ValueError(
            f"chunk_bytes must be >= {_tuning.MIN_SPILL_THRESHOLD_BYTES}, "
            f"got {cb}")
    return max(2, int(cb) // max(1, int(itemsize)))


# ---------------------------------------------------------------------------
# optional wire compression (the int8 gradient codec, split in two)
# ---------------------------------------------------------------------------

def _int8_encode(a: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Per-run symmetric int8 quantization (absmax scale).  The division
    is by a full tensor of the scale: torch divides by a scalar through
    its reciprocal, which rounds otherwise than the reference."""
    scale = float(a.abs().max()) / 127.0 if a.numel() else 0.0
    if scale == 0.0 or not math.isfinite(scale):
        scale = 1.0
    f = a.float()
    q = torch.round(f / torch.full_like(f, scale)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _int8_decode(q: torch.Tensor, scale: float, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


class _RunStore:
    """Host-resident sorted runs, optionally held compressed (``codec``:
    None, ``"int8"`` or an ``(encode, decode)`` pair, ``encode(run) ->
    (payload, state)``, ``decode(payload, state, dtype) -> run``); what a
    codec saves counts on ``spill.codec_bytes_saved``."""

    def __init__(self, codec, dtype):
        if codec == "int8" and not dtype.is_floating_point:
            raise ValueError(f"int8 spill codec quantizes float runs, got "
                             f"{keycodec.dtype_name(dtype)}")
        self._codec = codec
        self._dtype = dtype
        self._runs: List = []

    def append(self, run: torch.Tensor) -> None:
        if self._codec is None:
            self._runs.append(run)
            return
        enc = _int8_encode if self._codec == "int8" else self._codec[0]
        q, state = enc(run)
        saved = run.numel() * run.element_size() - q.numel() * q.element_size()
        if saved > 0:
            _metrics.counter("spill.codec_bytes_saved").inc(saved)
        self._runs.append((q, state))

    def materialize(self) -> List[torch.Tensor]:
        if self._codec is None:
            return self._runs
        dec = _int8_decode if self._codec == "int8" else self._codec[1]
        return [dec(q, s, self._dtype) for q, s in self._runs]

    def __len__(self):
        return len(self._runs)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# the host link of a card: two copy streams, pinned staging
# ---------------------------------------------------------------------------

class _Link:
    """Copies between host memory and one card, off the compute stream.

    ``up`` copies host -> card on its own stream (from pinned memory; a
    pageable source is first copied by the host into one of two pinned
    staging buffers, used in turn) and makes the compute stream wait for
    it; ``down`` copies card -> pinned host memory on a second stream once
    the compute stream has produced the tensors.  The host blocks only in
    :meth:`wait`, whose time it adds to ``blocked_s``."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.compute = torch.cuda.current_stream(dev)
        self.h2d = torch.cuda.Stream(dev)
        self.d2h = torch.cuda.Stream(dev)
        self._slots = {}        # dtype -> [[pinned buffer, event], x 2]
        self._turn = 0
        self.blocked_s = 0.0

    def wait(self, event) -> None:
        t0 = time.perf_counter()
        event.synchronize()
        self.blocked_s += time.perf_counter() - t0

    def _staged(self, host: torch.Tensor) -> Tuple[torch.Tensor, list]:
        slots = self._slots.setdefault(host.dtype, [[None, None],
                                                    [None, None]])
        slot = slots[self._turn]
        self._turn ^= 1
        if slot[1] is not None:
            self.wait(slot[1])              # its last copy up has left
        if slot[0] is None or slot[0].numel() < host.numel():
            slot[0] = torch.empty(host.numel(), dtype=host.dtype,
                                  pin_memory=True)
        buf = slot[0][:host.numel()]
        buf.copy_(host)
        return buf, slot

    def up(self, host: torch.Tensor) -> torch.Tensor:
        slot = None
        src = host
        if not host.is_pinned():
            src, slot = self._staged(host)
        with torch.cuda.stream(self.h2d):
            d = torch.empty(src.shape, dtype=src.dtype, device=self.dev)
            d.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.h2d)
        if slot is not None:
            slot[1] = done
        self.compute.wait_event(done)
        d.record_stream(self.compute)
        return d

    def down(self, dsts: Sequence[Optional[torch.Tensor]],
             srcs: Sequence[Optional[torch.Tensor]]):
        """Copy each card tensor of ``srcs`` into its pinned ``dsts``
        (None: a new pinned tensor) -> (the host tensors, their event)."""
        ready = torch.cuda.Event()
        ready.record(self.compute)
        self.d2h.wait_event(ready)
        outs = []
        with torch.cuda.stream(self.d2h):
            for dst, src in zip(dsts, srcs):
                if src is None:
                    outs.append(None)
                    continue
                if dst is None:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                dst.copy_(src, non_blocking=True)
                src.record_stream(self.d2h)
                outs.append(dst)
            done = torch.cuda.Event()
            done.record(self.d2h)
        return outs, done


# ---------------------------------------------------------------------------
# phase 1 — chunk, device-sort, spill (double-buffered)
# ---------------------------------------------------------------------------

def _spill_phase(keys: torch.Tensor, vals: Optional[torch.Tensor],
                 chunk: int, *, descending: bool, stable: bool, method: str,
                 overlap: bool, codec, dev: torch.device
                 ) -> Tuple[_RunStore, Optional[List[torch.Tensor]], float]:
    """Cut ``keys`` (and the payload) into ``chunk``-element pieces, sort
    each on ``dev``, bring the runs back to the host.

    ``overlap=True`` queues chunk ``i+1``'s copy up and sort before the
    host waits for run ``i``'s copy down; ``overlap=False`` drains every
    run before the next chunk is touched (the comparison baseline, same
    bits).  Returns the runs, the payload runs and the overlap fraction."""
    from repro_torch import engine
    n = keys.shape[0]
    key_runs = _RunStore(codec, keys.dtype)
    val_runs: Optional[List[torch.Tensor]] = None if vals is None else []
    link = _Link(dev) if dev.type == "cuda" else None
    t_begin = time.perf_counter()

    def to_dev(t):
        if t.device.type == "cpu":      # host keys handed to the sort
            _metrics.counter("spill.h2d_bytes").inc(_nbytes(t))
        return t if t.device == dev else link.up(t)

    def drain(pend) -> None:
        (hk, hv), done = pend
        if done is not None:
            link.wait(done)
        _metrics.counter("spill.d2h_bytes").inc(_nbytes(hk, hv))
        key_runs.append(hk)
        if hv is not None:
            val_runs.append(hv)

    pending = None
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        with _obs.trace("spill.chunk", start=start, stop=stop,
                        method=method):
            kc = to_dev(keys[start:stop])
            if vals is None:
                sk = engine.sort(kc[None, :], descending=descending,
                                 method=method, device=dev)[0]
                sv = None
            else:
                vc = to_dev(vals[start:stop])
                sk, sv = engine.sort_kv(kc[None, :], vc[None, :],
                                        descending=descending, stable=stable,
                                        method=method, device=dev)
                sk, sv = sk[0], sv[0]
            pend = (link.down((None, None), (sk, sv)) if link is not None
                    else ((sk, sv), None))
            del kc, sk, sv
        if overlap:
            if pending is not None:
                drain(pending)          # overlaps this chunk's sort
            pending = pend
        else:
            drain(pend)                 # fully serial baseline
    if pending is not None:
        drain(pending)
    wall = max(time.perf_counter() - t_begin, 1e-12)
    blocked = 0.0 if link is None else link.blocked_s
    frac = max(0.0, 1.0 - blocked / wall)
    _metrics.gauge("spill.overlap_fraction").set(frac)
    _metrics.gauge("spill.spill_phase_ms").set(wall * 1e3)
    return key_runs, val_runs, frac


# ---------------------------------------------------------------------------
# phase 2 — host k-way merge-path
# ---------------------------------------------------------------------------

def _count_before(asc: np.ndarray, key, tie_first: bool,
                  descending: bool) -> int:
    """How many elements of a sorted run precede ``key`` in merged order
    (``tie_first``: equal keys precede, the run lies left of the key's
    own).  ``asc`` is the run's ascending view; numpy's binary search
    orders NaN last and -0.0 with +0.0, the reference merge's order."""
    if descending:
        side = "left" if tie_first else "right"
        return int(asc.shape[0] - np.searchsorted(asc, key, side=side))
    side = "right" if tie_first else "left"
    return int(np.searchsorted(asc, key, side=side))


def _stable_rank(runs: Sequence[np.ndarray], asc: Sequence[np.ndarray],
                 r: int, i: int, descending: bool) -> int:
    """Merged position of ``runs[r][i]`` under the stable order (ties by
    run index, then in-run index)."""
    key = runs[r][i]
    rank = int(i)
    for q in range(len(runs)):
        if q != r:
            rank += _count_before(asc[q], key, tie_first=q < r,
                                  descending=descending)
    return rank


def _cursors_at(runs: Sequence[np.ndarray], asc: Sequence[np.ndarray],
                d: int, lows: Sequence[int], descending: bool) -> List[int]:
    """Cursors ``hi`` with ``sum(hi) == d``: ``runs[r][:hi[r]]`` are the
    first ``d`` elements of the stable merged order; ``lows`` (the last
    boundary's cursors) bound the bisection."""
    his = []
    for r, run in enumerate(runs):
        lo, hi = int(lows[r]), run.shape[0]
        while lo < hi:
            mid = (lo + hi) // 2
            if _stable_rank(runs, asc, r, mid, descending) < d:
                lo = mid + 1
            else:
                hi = mid
        his.append(lo)
    return his


def _grouped_kway_kv(kslices: List[torch.Tensor],
                     vslices: Optional[List[torch.Tensor]], fanin: int, *,
                     descending: bool, backend: str
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Merge tournament of capped width: contiguous groups of at most
    ``fanin`` slices merge, then the group outputs, until one remains.
    Contiguous groups keep the left-first tie rule across levels, so the
    cap keeps the merge stable.  ``vslices=None``: keys only."""
    while len(kslices) > 1:
        nk: List[torch.Tensor] = []
        nv: List[torch.Tensor] = []
        for i in range(0, len(kslices), fanin):
            gk = kslices[i:i + fanin]
            gv = None if vslices is None else vslices[i:i + fanin]
            if len(gk) == 1:
                nk.append(gk[0])
                nv.append(None if gv is None else gv[0])
            elif gv is None:
                nk.append(_merge.kway_merge(gk, descending=descending,
                                            backend=backend))
                nv.append(None)
            else:
                mk, mv = _merge.kway_merge_kv(gk, gv, descending=descending,
                                              backend=backend)
                nk.append(mk)
                nv.append(mv)
        kslices, vslices = nk, (None if vslices is None else nv)
    return kslices[0], (None if vslices is None else vslices[0])


def _merge_phase(key_runs: Sequence[torch.Tensor],
                 val_runs: Optional[Sequence[torch.Tensor]], *,
                 descending: bool, block: int, dev: torch.device
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K-way merge-path over host runs, one output block at a time: the
    host computes the stable cursors at each block boundary (``O(R^2
    log^2 L)`` binary searches), the device merges the block's slices
    (K2 on a card), at most the profile's ``merge_fanin`` at a time.
    Only the current block's slices are on the device; on a card the next
    block's cursors are computed while this block merges and copies
    down."""
    t_begin = time.perf_counter()
    runs = [r.reshape(-1) for r in key_runs]
    total = int(sum(r.shape[0] for r in runs))
    kv = val_runs is not None
    vruns = [v.reshape(-1) for v in val_runs] if kv else None
    if len(runs) == 1:
        _metrics.gauge("spill.merge_phase_ms").set(0.0)
        return runs[0], (vruns[0] if kv else None)
    cuda = dev.type == "cuda"
    link = _Link(dev) if cuda else None
    np_runs = [r.numpy() for r in runs]
    asc = [r[::-1] if descending else r for r in np_runs]
    out_k = torch.empty((total,), dtype=runs[0].dtype, pin_memory=cuda)
    out_v = torch.empty((total,), dtype=vruns[0].dtype,
                        pin_memory=cuda) if kv else None
    lows = [0] * len(runs)
    written = 0
    fanin = max(2, int(_tuning.active().merge_fanin))
    backend = "cuda" if cuda else "torch"
    bounds = list(range(block, total, block)) + [total]
    copies = []
    for d in bounds:
        his = _cursors_at(np_runs, asc, d, lows, descending)
        sel = [(r, lo, hi) for r, (lo, hi) in enumerate(zip(lows, his))
               if hi > lo]
        with _obs.trace("spill.merge_block", start=written, stop=d,
                        fan_in=len(sel)):
            if len(sel) == 1:
                r, lo, hi = sel[0]
                out_k[written:d] = runs[r][lo:hi]
                if kv:
                    out_v[written:d] = vruns[r][lo:hi]
            else:
                ks = [runs[r][lo:hi] for r, lo, hi in sel]
                vs = [vruns[r][lo:hi] for r, lo, hi in sel] if kv else None
                moved = _nbytes(*ks, *(vs or ()))
                _metrics.counter("spill.h2d_bytes").inc(moved)
                if cuda:
                    ks = [link.up(s) for s in ks]
                    vs = [link.up(s) for s in vs] if kv else None
                mk, mv = _grouped_kway_kv(ks, vs, fanin,
                                          descending=descending,
                                          backend=backend)
                _metrics.counter("spill.d2h_bytes").inc(moved)
                dsts = (out_k[written:d],
                        out_v[written:d] if kv else None)
                if cuda:
                    copies.append(link.down(dsts, (mk, mv))[1])
                else:
                    dsts[0].copy_(mk)
                    if kv:
                        dsts[1].copy_(mv)
                del ks, vs, mk, mv
        written = d
        lows = his
    for done in copies:
        done.synchronize()
    _metrics.gauge("spill.merge_phase_ms").set(
        (time.perf_counter() - t_begin) * 1e3)
    return out_k, out_v


# ---------------------------------------------------------------------------
# public 1-D drivers
# ---------------------------------------------------------------------------

def _prepare(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dim() != 1:
        raise ValueError(
            f"spill tier sorts flat 1-D arrays (rows are driven "
            f"independently by the engine); got a {t.dim()}-d input")
    return t


def _pipeline_keys(keys: torch.Tensor, descending: bool):
    """(keys the pipeline sorts, its direction, the inverse map).  bfloat16
    rides as its order-embedding code in the signed int16 carrier (the
    reference's uint16 code, sign bit flipped), ``descending`` folded in,
    so the pipeline ascends; uint16/uint32 as their signed carriers."""
    dtype = keys.dtype
    if dtype == torch.bfloat16:
        sign = -(1 << 15)
        enc = keycodec.encode(keys, descending=descending) ^ sign
        return enc, False, lambda t: keycodec.decode(
            t ^ sign, dtype, descending=descending)
    return (keycodec.to_signed(keys), descending,
            lambda t: keycodec.from_signed(t, dtype))


def _nan_safe_method(keys: torch.Tensor, method: str) -> str:
    """``auto`` chunk sorts of a float input that visibly holds NaN pin to
    the ``torch`` backend (NaN last, the reference's ``xla``): the network
    and kernel backends assume NaN-free keys.  Explicit methods are
    honoured."""
    if method == "auto" and keys.is_floating_point() and any(
            bool(torch.isnan(p).any()) for p in keys.split(1 << 24)):
        return "torch"
    return method


def spill_sort(x, *, descending: bool = False,
               chunk_bytes: Optional[int] = None, method: str = "auto",
               overlap: bool = True, codec=None,
               device="cuda") -> torch.Tensor:
    """Sort a 1-D array of any size (host- or card-resident); returns a
    sorted CPU tensor.  ``method`` is the chunk sorts' backend ("auto":
    the planner), ``device`` the one that sorts and merges ("cpu": the
    plain versions), ``codec`` the lossy int8 run compression."""
    dev = resolve_device(device)
    keys = _prepare(x)
    n = keys.shape[0]
    if n == 0:
        return keys.detach().to("cpu", copy=True)
    if keys.dtype == torch.bfloat16 and codec is not None:
        raise ValueError(
            "codec compresses raw float key runs; bfloat16 keys ride the "
            "pipeline as their keycodec code, which a magnitude quantizer "
            "would scramble")
    pk, desc, back = _pipeline_keys(keys, descending)
    method = _nan_safe_method(pk, method)
    chunk = chunk_elems(pk.element_size(), chunk_bytes)
    with _obs.trace("spill.sort", n=n, chunks=-(-n // chunk),
                    chunk_elems=chunk, overlap=overlap):
        key_runs, _, _ = _spill_phase(
            pk, None, chunk, descending=desc, stable=False, method=method,
            overlap=overlap, codec=codec, dev=dev)
        out, _ = _merge_phase(key_runs.materialize(), None, descending=desc,
                              block=min(chunk, MAX_MERGE_BLOCK), dev=dev)
    return back(out)


def spill_sort_kv(keys, values, *, descending: bool = False,
                  chunk_bytes: Optional[int] = None, method: str = "auto",
                  overlap: bool = True, codec=None, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value spill sort, always stable (equal keys keep input order:
    stable chunk sorts, run-index ties in both merges).  ``codec``
    compresses the payload runs; keys stay exact, so the order is."""
    dev = resolve_device(device)
    k = _prepare(keys)
    v = _prepare(values)
    if k.shape != v.shape:
        raise ValueError(
            f"values shape {tuple(v.shape)} must match keys shape "
            f"{tuple(k.shape)}")
    n = k.shape[0]
    if n == 0:
        return (k.detach().to("cpu", copy=True),
                v.detach().to("cpu", copy=True))
    pk, desc, back = _pipeline_keys(k, descending)
    pv = keycodec.to_signed(v)
    method = _nan_safe_method(pk, method)
    chunk = chunk_elems(pk.element_size(), chunk_bytes)
    with _obs.trace("spill.sort_kv", n=n, chunks=-(-n // chunk),
                    chunk_elems=chunk, overlap=overlap):
        key_runs, val_runs, _ = _spill_phase(
            pk, pv, chunk, descending=desc, stable=True, method=method,
            overlap=overlap, codec=None, dev=dev)
        if codec is not None:
            store = _RunStore(codec, pv.dtype)
            for vr in val_runs:
                store.append(vr)
            val_runs = store.materialize()
        out_k, out_v = _merge_phase(key_runs.materialize(), val_runs,
                                    descending=desc,
                                    block=min(chunk, MAX_MERGE_BLOCK),
                                    dev=dev)
    return back(out_k), keycodec.from_signed(out_v, v.dtype)


def spill_argsort(x, *, descending: bool = False,
                  chunk_bytes: Optional[int] = None, method: str = "auto",
                  overlap: bool = True, device="cuda") -> torch.Tensor:
    """Stable sorting permutation through the key-value path (int32
    positions, a CPU tensor)."""
    keys = _prepare(x)
    idx = torch.arange(keys.shape[0], dtype=torch.int32,
                       device=keys.device)
    return spill_sort_kv(keys, idx, descending=descending,
                         chunk_bytes=chunk_bytes, method=method,
                         overlap=overlap, device=device)[1]


# ---------------------------------------------------------------------------
# rows-form adapters — what the spill backend dispatches to
# ---------------------------------------------------------------------------

def _stack(outs: List[torch.Tensor]) -> torch.Tensor:
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def sort_rows(x2: torch.Tensor, *, descending: bool = False,
              chunk_bytes: Optional[int] = None, method: str = "auto",
              device="cuda") -> torch.Tensor:
    """(rows, n) -> sorted rows, each spilled on its own; a CPU tensor."""
    return _stack([spill_sort(r, descending=descending,
                              chunk_bytes=chunk_bytes, method=method,
                              device=device) for r in x2])


def sort_rows_kv(k2: torch.Tensor, v2: torch.Tensor, *,
                 descending: bool = False, chunk_bytes: Optional[int] = None,
                 method: str = "auto", device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    outs = [spill_sort_kv(kr, vr, descending=descending,
                          chunk_bytes=chunk_bytes, method=method,
                          device=device) for kr, vr in zip(k2, v2)]
    return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])


def argsort_rows(x2: torch.Tensor, *, descending: bool = False,
                 chunk_bytes: Optional[int] = None, method: str = "auto",
                 device="cuda") -> torch.Tensor:
    return _stack([spill_argsort(r, descending=descending,
                                 chunk_bytes=chunk_bytes, method=method,
                                 device=device) for r in x2])
