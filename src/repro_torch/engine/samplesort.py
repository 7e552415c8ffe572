"""Distributed sample sort over a device mesh.

The port of the JAX package's ``engine/samplesort.py`` on a
:class:`~repro_torch.core.mesh.Mesh` in one process: the reference's
``shard_map`` programs are host loops over the mesh's entries, each
entry's work on its own device, and every exchange goes through
``engine.collectives`` (a copy into a fresh buffer on the receiver).

  flat (one tier)
      local sort -> global splitters -> ONE bucket all-to-all over every
      entry -> merge of the received runs -> rank-directed rebalance.

  hierarchical (two tiers, ``axes = (outer, inner)``)
      1. local sort + splitters inside each outer group (a node)
      2. inner exchange + merge + rebalance inside the node, then outer
         splitters over the node-sorted shards
      3. outer exchange (in ``pipeline_chunks`` slices, optionally the
         int8 codec on a float payload) + merge + compaction, then
         sub-splitters inside the node over the received pool
      4. inner finalize exchange + merge + the GLOBAL rebalance

Exchange capacities are measured: each phase's bucket counts come to the
host, and the next exchange is sized by their maximum (times the
profile's ``capacity_slack``, rounded up to a power of two, as the
reference does to share compiled programs).

Keys travel as *signed-order keys*: the keycodec key (``descending``
complements it) with its sign bit flipped, so every comparison, merge and
search is a plain signed one (K2, ``torch.searchsorted``), and the
maximal key of the carrier pads buffers.  Validity is tracked by counts,
never by comparing with a pad.

**Ties keep ascending index order** in every path (the reference's
sample sort is not stable): the local sorts are stable, the merges
stable with the runs in source order, and a key-value sort carries each
element's global position.  In the flat schedule and the first three
hierarchical phases the source order is the position order; the
finalize merge of the two-level schedule is not, so its pool's equal keys
are put back in position order (``_repair_ties``) before the rebalance.

On the card the bucket bounds come from K3's ``radix_bucket_hist``
(``use_histogram`` defaults to on there, as the reference's does on a
TPU) and the merges run K2; ``sample_topk`` selects with K4.  Off the
card the same code runs their plain versions.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import keycodec
from repro_torch.core import tuning as _tuning
from repro_torch.engine import collectives as coll
from repro_torch.obs import metrics, trace as _obs

__all__ = ["sample_sort", "sample_sort_shards", "sample_topk",
           "select_splitters", "bucket_bounds", "default_samples_per_shard",
           "alltoall_bytes_per_device", "topk_candidate_bytes_per_device"]

AxisArg = Union[str, Tuple[str, ...], None]


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def default_samples_per_shard(local_n: int, n_dev: int) -> int:
    """Regular-sampling oversampling: enough samples that splitters land
    within a small factor of the ideal quantiles, capped by the shard."""
    return max(1, min(local_n, max(8, 2 * n_dev)))


def select_splitters(samples: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(D*s,) pooled samples -> (D-1,) global splitters."""
    pooled = torch.sort(samples.reshape(-1)).values
    total = pooled.shape[0]
    pos = (torch.arange(1, n_dev, device=samples.device) * total) // n_dev
    return pooled[pos]


def bucket_bounds(ks: torch.Tensor, splitters: torch.Tensor, *,
                  use_histogram: bool = False) -> torch.Tensor:
    """(D+1,) int32 bucket boundaries of a *sorted* shard of signed-order
    keys against the splitters: bucket d is ``ks[bounds[d]:bounds[d+1]]``
    (a key equal to a splitter goes to the lower bucket).  Two routes, the
    same numbers:

      * ``use_histogram=False``: binary search,
        ``searchsorted(ks, splitters, right=True)``;
      * ``use_histogram=True``: the bucket histogram (K3's
        ``radix_bucket_hist`` on a card, its plain version, the
        reference's tiled one-hot histogram of the interval ids, on the
        CPU) and its exclusive prefix sum."""
    from repro_torch.kernels import radix_sort as _rs
    m = ks.shape[0]
    n_dev = splitters.shape[0] + 1
    if n_dev == 1:
        return torch.tensor([0, m], dtype=torch.int32, device=ks.device)
    if use_histogram:
        counts = _rs.bucket_hist(ks, splitters)[:n_dev]
    else:
        starts = torch.searchsorted(ks, splitters, right=True,
                                    out_int32=True)
        counts = torch.diff(starts, prepend=starts.new_zeros(1),
                            append=starts.new_full((1,), m))
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


# ---------------------------------------------------------------------------
# axis plumbing: one axis, a tuple of axes, or the whole mesh
# ---------------------------------------------------------------------------

def _axes_tuple(mesh, axis_name: AxisArg) -> Tuple[str, ...]:
    """Normalise ``axis_name`` to a validated tuple of mesh axis names
    (``None`` -> every mesh axis, in mesh order)."""
    if axis_name is None:
        axes = tuple(mesh.axis_names)
    elif isinstance(axis_name, str):
        axes = (axis_name,)
    else:
        axes = tuple(axis_name)
    if not axes:
        raise ValueError("axis_name must name at least one mesh axis")
    for a in axes:
        if not isinstance(a, str):
            raise TypeError(f"axis names must be strings, got {a!r}")
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in mesh axes "
                             f"{tuple(mesh.axis_names)}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate axis names in {axes}")
    return axes


def _n_dev(mesh, axes: Tuple[str, ...]) -> int:
    d = 1
    for a in axes:
        d *= int(mesh.shape[a])
    return d


def _lin_index(mesh, axes: Tuple[str, ...], flat: int) -> int:
    """Linear index of flat mesh entry ``flat`` row-major over ``axes``:
    the order the sort shards by."""
    coords = np.unravel_index(flat, mesh.devices.shape)
    idx = 0
    for a in axes:
        i = list(mesh.axis_names).index(a)
        idx = idx * int(mesh.shape[a]) + int(coords[i])
    return idx


def _entries(mesh, axes: Tuple[str, ...]) -> List[torch.device]:
    """The devices of the sort's entries, in linear order over ``axes``
    (the first group of the mesh along them; a mesh axis left out holds
    replicas)."""
    return [mesh.devices.flat[i] for i in coll.axis_groups(mesh, axes)[0]]


def _pick_merge_backend(run_len: int, device) -> str:
    """The merge tree's backend: K2 (``cuda``) on a card, where the
    reference picks its Pallas merge on a TPU; its plain version, the
    stable rank merge (``torch``), elsewhere.  The bitonic box the
    reference takes off the TPU for power-of-two runs is not stable, and
    this port keeps ties in index order."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


# ---------------------------------------------------------------------------
# per-entry building blocks
# ---------------------------------------------------------------------------

def _sign(dtype) -> int:
    return -(1 << (torch.iinfo(dtype).bits - 1))


def _maxkey(dtype) -> int:
    return torch.iinfo(dtype).max


def _to_order_keys(x: torch.Tensor, descending: bool) -> torch.Tensor:
    enc = keycodec.encode(x, descending=descending)
    return enc ^ _sign(enc.dtype)


def _from_order_keys(s: torch.Tensor, dtype, descending: bool
                     ) -> torch.Tensor:
    return keycodec.decode(s ^ _sign(s.dtype), dtype, descending=descending)


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _take(t: Optional[torch.Tensor], idx: torch.Tensor):
    """``t[idx]`` through the bits of a float tensor (a CPU gather of
    float16 quiets signalling NaNs).  Payloads ride the sort in
    ``keycodec.to_signed`` form, so no unsigned tensor reaches here."""
    if t is None:
        return None
    if t.is_floating_point():
        return t.view(_BITS[t.element_size()])[idx.to(torch.int64)] \
            .view(t.dtype)
    return t[idx.to(torch.int64)]


class _Pool:
    """One entry's sorted pool: signed-order keys ``k`` (pads past
    ``n``), the global positions ``p`` (int32; None for a key-only sort)
    and the payload ``v`` (or None), all on ``dev``."""
    __slots__ = ("k", "p", "v", "n", "dev")

    def __init__(self, k, p, v, n, dev):
        self.k, self.p, self.v, self.n, self.dev = k, p, v, n, dev


def _local_sort(k, v, length: int, offset: int, m: int, track: bool,
                local_method: Optional[str], dev) -> _Pool:
    """Pad a shard to ``m`` slots with the maximal key and sort it through
    the front door's engine.  With positions tracked it is a stable
    key-value sort on the local positions, so the pads (positions >=
    ``length``) stay behind genuine maximal keys: validity is a prefix."""
    from repro_torch import engine
    kp = torch.full((m,), _maxkey(k.dtype), dtype=k.dtype, device=dev)
    kp[:length] = k
    method = local_method or "auto"
    if not track:
        return _Pool(engine.sort(kp, method=method, device=dev), None, None,
                     length, dev)
    lp = torch.arange(m, dtype=torch.int32, device=dev)
    ks, order = engine.sort_kv(kp, lp, stable=True, method=method,
                               device=dev)
    vs = None
    if v is not None:
        vp = torch.zeros((m,), dtype=v.dtype, device=dev)
        vp[:length] = v
        vs = _take(vp, order)
    return _Pool(ks, order + offset, vs, length, dev)


def _samples(pool: _Pool, s: int, span: int) -> torch.Tensor:
    """``s`` regular samples of the pool's first ``span`` slots (the pads
    past the pool's end read as the maximal key)."""
    pos = ((torch.arange(s, device=pool.dev) + 1) * span) // (s + 1)
    k = pool.k
    if k.shape[0] == 0:
        return torch.full((s,), _maxkey(k.dtype), dtype=k.dtype,
                          device=pool.dev)
    padded = torch.cat([k, k.new_full((1,), _maxkey(k.dtype))])
    return padded[pos.clamp(max=k.shape[0])]


def _cut(pools: Sequence[_Pool], spans: Sequence[int], p: int, s: int,
         use_histogram: bool):
    """Each pool's bucket starts and genuine counts against splitters
    pooled from the group's samples: (starts list, (G, p) count table on
    the host).  Sampling and splitters as the reference's phases do."""
    devs = [pl.dev for pl in pools]
    gathered = coll.all_gather([_samples(pl, s, sp)
                                for pl, sp in zip(pools, spans)], devs)
    starts, counts = [], []
    for pl, g in zip(pools, gathered):
        splitters = select_splitters(g, p)
        bounds = bucket_bounds(pl.k, splitters, use_histogram=use_histogram)
        vcnt = (torch.minimum(bounds[1:], torch.full_like(bounds[1:], pl.n))
                - bounds[:-1]).clamp(min=0)
        starts.append(bounds[:-1])
        counts.append(vcnt)
    table = np.stack([c.cpu().numpy() for c in counts]) if counts else \
        np.zeros((0, p), np.int64)
    return starts, table.astype(np.int64)


def _exchange_merge(pools: Sequence[_Pool], starts, table: np.ndarray,
                    c: int, merge_backend: Optional[str], *,
                    chunks: int = 1, wire_codec: Optional[str] = None
                    ) -> List[_Pool]:
    """One bucket exchange inside a group of p entries plus the merge of
    each receiver's runs, then the compaction of its genuine keys.

    Entry i sends bucket j (``starts[i][j]``, ``table[i, j]`` genuine
    keys) to entry j in a capacity-``c`` buffer padded with the maximal
    key; with ``chunks > 1`` as that many exchanges of contiguous slices,
    so the receiver merges ``p * chunks`` runs.  ``wire_codec='int8'``
    sends the payload through the int8 codec.  A position payload (the
    receive slot) rides the merge; validity, global positions and the
    payload are gathered through it, so pads that tie genuine maximal
    keys change nothing.  The runs are merged in source order, so the
    merge keeps equal keys in source order."""
    from repro_torch.engine.merge import merge_runs
    p = len(pools)
    devs = [pl.dev for pl in pools]
    track = pools[0].p is not None
    has_v = pools[0].v is not None
    sends_k, sends_p, sends_v = [], [], []
    for i, pl in enumerate(pools):
        ar = torch.arange(c, dtype=torch.int32, device=pl.dev)
        cnt = torch.as_tensor(table[i], device=pl.dev).to(torch.int32)
        within = ar[None, :] < cnt[:, None]
        m = pl.k.shape[0]
        src = (starts[i][:, None] + ar[None, :]).clamp(0, max(m - 1, 0))
        if m == 0:
            src = torch.zeros_like(src)
            kk = pl.k.new_full((1,), _maxkey(pl.k.dtype))
        else:
            kk = pl.k
        sends_k.append(torch.where(within, kk[src],
                                   torch.full_like(src, _maxkey(kk.dtype),
                                                   dtype=kk.dtype)))
        if track:
            pp = pl.p if m else pl.p.new_zeros(1)
            sends_p.append(torch.where(within, pp[src], 0))
        if has_v:
            vv = pl.v if m else pl.v.new_zeros(1)
            sends_v.append(torch.where(within, _take(vv, src),
                                       torch.zeros((), dtype=vv.dtype,
                                                   device=pl.dev)))
    recv_k = coll.chunked_all_to_all(sends_k, devs, chunks=chunks)
    recv_p = coll.chunked_all_to_all(sends_p, devs, chunks=chunks) \
        if track else None
    del sends_k, sends_p
    recv_v = None
    if has_v:
        if wire_codec == "int8":
            enc = [coll.wire_encode_int8(sv) for sv in sends_v]
            rq = coll.chunked_all_to_all([q for q, _ in enc], devs,
                                         chunks=chunks)
            rs = coll.all_to_all([sc for _, sc in enc], devs)
            recv_v = [coll.wire_decode_int8(q.reshape(p, c), sc,
                                            pools[0].v.dtype)
                      for q, sc in zip(rq, rs)]
        else:
            recv_v = coll.chunked_all_to_all(sends_v, devs, chunks=chunks)
    del sends_v

    cp = c // chunks
    n_runs = p * chunks
    r_runs = next_pow2(n_runs)
    out = []
    for j, dev in enumerate(devs):
        kdt = recv_k[j].dtype
        runs = recv_k[j].reshape(n_runs, cp)
        if r_runs != n_runs:
            runs = torch.cat([runs, torch.full((r_runs - n_runs, cp),
                                               _maxkey(kdt), dtype=kdt,
                                               device=dev)])
        slot = torch.arange(r_runs * cp, dtype=torch.int32,
                            device=dev).reshape(1, r_runs, cp)
        backend = merge_backend or _pick_merge_backend(cp, dev)
        mk, mslot = merge_runs(runs[None].contiguous(), slot,
                               descending=False, backend=backend)
        mk, mslot = mk[0], mslot[0]
        cnt = torch.as_tensor(table[:, j], device=dev)
        piece = (cnt[:, None] - torch.arange(chunks, device=dev)[None, :]
                 * cp).clamp(0, cp)
        run_valid = torch.arange(cp, device=dev)[None, :] \
            < piece.reshape(-1)[:, None]
        if r_runs != n_runs:
            run_valid = torch.cat([run_valid, torch.zeros(
                (r_runs - n_runs, cp), dtype=torch.bool, device=dev)])
        mvalid = run_valid.reshape(-1)[mslot.to(torch.int64)]
        total = int(table[:, j].sum())
        csum = torch.cumsum(mvalid, 0, dtype=torch.int32)
        sel = torch.searchsorted(
            csum, torch.arange(1, total + 1, dtype=torch.int32, device=dev),
            out_int32=True).to(torch.int64)
        slots = mslot.to(torch.int64)[sel]
        k = mk[sel]
        del mk, mslot, mvalid, csum, sel, runs, slot
        pp = recv_p[j].reshape(-1)[slots] if track else None
        vv = _take(recv_v[j].reshape(-1), slots) if has_v else None
        # this receiver's buffers are spent: free them before the next
        recv_k[j] = None
        if track:
            recv_p[j] = None
        if has_v:
            recv_v[j] = None
        out.append(_Pool(k, pp, vv, total, dev))
    return out


def _rebalance(pools: Sequence[_Pool], lengths: Sequence[int],
               devices: Sequence) -> List[_Pool]:
    """Rank-directed rebalance of a group's merged pools (in rank order)
    into slices of ``lengths``: one copy for every overlap of a pool and
    a slice (``collectives.redistribute``)."""
    ks = coll.redistribute([pl.k for pl in pools], lengths, devices)
    ps = coll.redistribute([pl.p for pl in pools], lengths, devices) \
        if pools[0].p is not None else [None] * len(lengths)
    vs = coll.redistribute([pl.v for pl in pools], lengths, devices) \
        if pools[0].v is not None else [None] * len(lengths)
    return [_Pool(k, p, v, int(n), d)
            for k, p, v, n, d in zip(ks, ps, vs, lengths, devices)]


def _pad_pool(pl: _Pool, m: int) -> _Pool:
    """The pool padded to ``m`` slots with the maximal key (and zeros)."""
    extra = m - pl.k.shape[0]
    if extra <= 0:
        return pl
    k = torch.cat([pl.k, pl.k.new_full((extra,), _maxkey(pl.k.dtype))])
    p = None if pl.p is None else torch.cat([pl.p, pl.p.new_zeros(extra)])
    v = None if pl.v is None else torch.cat([pl.v, pl.v.new_zeros(extra)])
    return _Pool(k, p, v, pl.n, pl.dev)


def _stable_order(t: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation (int32) of non-negative int32 keys:
    K3's onesweep sort with an index payload (its plain version on the
    CPU)."""
    from repro_torch.kernels import radix_sort as _rs
    idx = torch.arange(t.shape[0], dtype=torch.int32, device=t.device)
    return _rs.sort_kv_blocks(t[None].contiguous(), idx[None])[1][0]


def _repair_ties(pl: _Pool) -> _Pool:
    """Equal keys of a key-sorted pool back in ascending position order:
    the finalize merge of the two-level schedule receives its runs from
    entries whose equal keys interleave in position.  Only a pool with a
    misordered tie is touched: a stable sort by position, then a stable
    sort by the key's run id."""
    k, p = pl.k, pl.p
    if p is None or k.shape[0] < 2:
        return pl
    tie = k[1:] == k[:-1]
    if not bool((tie & (p[1:] < p[:-1])).any()):
        return pl
    run = torch.cat([k.new_zeros(1, dtype=torch.int32),
                     torch.cumsum(~tie, 0, dtype=torch.int32)])
    o = _stable_order(p)
    o = o[_stable_order(run[o.to(torch.int64)]).to(torch.int64)]
    return _Pool(k, p[o.to(torch.int64)], _take(pl.v, o), pl.n, pl.dev)


def _round_capacity(cap: int, m: int) -> int:
    """Exchange capacity: at least one slot, rounded up to a power of two
    (so nearby workloads share a capacity), never beyond the pool."""
    cap = max(1, cap)
    if cap >= m:
        return m
    return min(m, next_pow2(cap))


def alltoall_bytes_per_device(n_dev: int, local_elems: int,
                              itemsize: int, capacity: Optional[int] = None
                              ) -> int:
    """Analytic exchange volume of one sample-sort round a device: the
    capacity-padded bucket all-to-all plus the rebalance."""
    cap = capacity if capacity is not None else \
        min(local_elems, 2 * local_elems // max(1, n_dev) + 1)
    return (n_dev * cap + n_dev * local_elems) * itemsize


def topk_candidate_bytes_per_device(n_dev: int, k: int, local_elems: int,
                                    itemsize: int) -> int:
    """Analytic volume of the top-k candidate all-gather a device: D *
    min(k, m) (key, int32 index) pairs."""
    kc = min(k, local_elems)
    return n_dev * kc * (itemsize + 4)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _record_skew(table: np.ndarray, max_bucket: int) -> None:
    counts = table.astype(np.float64)
    mean_fill = float(counts.mean()) if counts.size else 0.0
    skew = float(max_bucket) / mean_fill if mean_fill else 1.0
    metrics.gauge("samplesort.bucket_skew").set(skew)
    metrics.histogram("samplesort.bucket_fill_max").observe(max_bucket)


def _flat(pools, devs, lens, mesh, axes, m, s, capacity, slack,
          use_histogram, merge_backend, pipeline_chunks, wire_codec,
          itemsize):
    n_dev = len(pools)
    n = sum(lens)
    sp1 = _obs.trace("samplesort.phase1", n=n, n_dev=n_dev,
                     kv=pools[0].p is not None, samples_per_shard=s)
    with sp1:
        starts, table = _cut(pools, [m] * n_dev, n_dev, s, use_histogram)
    max_bucket = int(table.max()) if table.size else 0
    if capacity is None:
        cap = _round_capacity(int(math.ceil(max_bucket * slack)), m)
    else:
        cap = _round_capacity(capacity, m)
        if cap < max_bucket:
            raise ValueError(
                f"capacity {capacity} is smaller than the realized maximum "
                f"bucket ({max_bucket}); the shard length {m} is always "
                f"safe")
    chunks = coll.pipeline_chunks(cap, pipeline_chunks) \
        if pipeline_chunks is not None else 1
    total_bytes = n_dev * alltoall_bytes_per_device(n_dev, m, itemsize, cap)
    if _obs.enabled():
        _record_skew(table, max_bucket)
        metrics.counter("samplesort.alltoall_bytes").inc(total_bytes)
        metrics.counter("samplesort.sorts").inc()
        if len(axes) == 2:
            coll.record_split_exchange(total_bytes, int(mesh.shape[axes[1]]),
                                       int(mesh.shape[axes[0]]))
        else:
            coll.record_exchange("nvlink", total_bytes)
    sp2 = _obs.trace("samplesort.phase2", n=n, n_dev=n_dev, capacity=cap,
                     bytes=total_bytes if _obs.enabled() else 0)
    with sp2:
        merged = _exchange_merge(pools, starts, table, cap, merge_backend,
                                 chunks=chunks, wire_codec=wire_codec)
        pools[:] = [None] * n_dev          # the shards are spent
        out = _rebalance(merged, lens, devs)
        del merged
        sp2.fence([pl.k for pl in out])
    return out


def _hier(pools, devs, lens, mesh, axes, m, s, slack, use_histogram,
          merge_backend, pipeline_chunks, wire_codec, itemsize):
    outer_ax, inner_ax = axes
    d_out, d_in = int(mesh.shape[outer_ax]), int(mesh.shape[inner_ax])
    n_dev = d_out * d_in
    n = sum(lens)
    val_is = None if pools[0].v is None else pools[0].v.element_size()
    hosts = [list(range(g * d_in, (g + 1) * d_in)) for g in range(d_out)]
    cols = [[g * d_in + i for g in range(d_out)] for i in range(d_in)]

    # phase 1: local sort done; splitters inside each node
    with _obs.trace("samplesort.hier.phase1", n=n, n_dev=n_dev,
                    d_out=d_out, d_in=d_in, samples_per_shard=s):
        cut1 = [_cut([pools[e] for e in h], [m] * d_in, d_in, s,
                     use_histogram) for h in hosts]
    max1 = max(int(t.max()) for _, t in cut1)
    c1 = _round_capacity(int(math.ceil(max1 * slack)), m)

    # phase 2: inner exchange + node rebalance + outer splitter prep
    with _obs.trace("samplesort.hier.phase2", n=n, capacity=c1):
        node = []
        for g, h in enumerate(hosts):
            merged = _exchange_merge([pools[e] for e in h], cut1[g][0],
                                     cut1[g][1], c1, merge_backend)
            for e in h:
                pools[e] = None
            valid = sum(pl.n for pl in merged)
            node_lens = [min(max(valid - i * m, 0), m) for i in range(d_in)]
            node += [_pad_pool(pl, m) for pl in _rebalance(
                merged, node_lens, [devs[e] for e in h])]
        starts2, table2 = _cut(node, [m] * n_dev, d_out, s, use_histogram)
    max2 = int(table2.max())
    c2 = _round_capacity(int(math.ceil(max2 * slack)), m)
    chunks = coll.pipeline_chunks(c2, pipeline_chunks)

    # phase 3: outer exchange (chunked, codec) + compaction + sub-splitters
    with _obs.trace("samplesort.hier.phase3", n=n, capacity=c2,
                    chunks=chunks, wire_codec=wire_codec or "none"):
        pool3: List[Optional[_Pool]] = [None] * n_dev
        for col in cols:
            merged = _exchange_merge([node[e] for e in col],
                                     [starts2[e] for e in col],
                                     table2[col], c2, merge_backend,
                                     chunks=chunks, wire_codec=wire_codec)
            for e, pl in zip(col, merged):
                pool3[e] = pl
                node[e] = None
        L = next_pow2(d_out * chunks) * (c2 // chunks)
        cut3 = [_cut([pool3[e] for e in h], [pool3[e].n for e in h], d_in,
                     s, use_histogram) for h in hosts]
    max3 = max(int(t.max()) for _, t in cut3)
    c3 = _round_capacity(int(math.ceil(max3 * slack)), L)

    if _obs.enabled():
        ici = n_dev * alltoall_bytes_per_device(d_in, m, itemsize, c1)
        ici += n_dev * d_in * c3 * itemsize
        dcn = n_dev * d_out * c2 * itemsize
        if wire_codec == "int8":
            saved = n_dev * coll.wire_bytes_saved(d_out, c2, val_is)
            dcn -= saved
            metrics.counter("collectives.wire_bytes_saved").inc(saved)
        coll.record_exchange("nvlink", ici)
        coll.record_exchange("network", dcn)
        coll.record_split_exchange(n_dev * n_dev * m * itemsize, d_in, d_out)
        metrics.counter("samplesort.alltoall_bytes").inc(
            ici + dcn + n_dev * n_dev * m * itemsize)
        metrics.counter("samplesort.sorts").inc()
        _record_skew(table2, max2)

    # phase 4: inner finalize exchange + global rebalance
    sp4 = _obs.trace("samplesort.hier.phase4", n=n, capacity=c3)
    with sp4:
        final: List[_Pool] = []
        for g, h in enumerate(hosts):
            merged = _exchange_merge([pool3[e] for e in h], cut3[g][0],
                                     cut3[g][1], c3, merge_backend)
            for e in h:
                pool3[e] = None
            final += [_repair_ties(pl) for pl in merged]
            del merged
        out = _rebalance(final, lens, devs)
        sp4.fence([pl.k for pl in out])
    return out


def _check_codec(wire_codec, values):
    if wire_codec is None:
        return
    if wire_codec not in coll.WIRE_CODECS:
        raise ValueError(f"unknown wire_codec {wire_codec!r}; "
                         f"available: {coll.WIRE_CODECS}")
    if values is None:
        raise ValueError("wire_codec compresses the PAYLOAD buckets; "
                         "pass values= (keys always travel wide)")
    if not values[0].is_floating_point():
        raise ValueError(
            f"wire_codec='int8' quantises float payloads, got "
            f"{keycodec.dtype_name(values[0].dtype)!r}")


def _sort_shards(shards, mesh, axes, values, descending, return_indices,
                 local_method, samples_per_shard, capacity, capacity_slack,
                 use_histogram, merge_backend, hierarchical,
                 pipeline_chunks, wire_codec):
    """The engine under both entry points: shard tensors in, the sorted
    array's pools out (cut like the input, each on its entry)."""
    n_dev = _n_dev(mesh, axes)
    if len(shards) != n_dev:
        raise ValueError(f"{n_dev} mesh entries over {axes} need {n_dev} "
                         f"shards, got {len(shards)}")
    dtype = shards[0].dtype
    for t in shards:
        if t.dim() != 1 or t.dtype != dtype:
            raise ValueError("shards must be 1-D tensors of one dtype")
    if not keycodec.supports(dtype):
        raise ValueError(
            f"sample_sort needs a keycodec dtype {keycodec.SUPPORTED}, "
            f"got {keycodec.dtype_name(dtype)!r}")
    if values is not None:
        if len(values) != n_dev or any(
                v.shape != t.shape for v, t in zip(values, shards)):
            raise ValueError("values must match the key shards one for one")
    two_tier = len(axes) == 2 and all(int(mesh.shape[a]) > 1 for a in axes)
    if hierarchical and len(axes) != 2:
        raise ValueError(
            f"hierarchical sample_sort needs exactly two mesh axes "
            f"(outer, inner); got {axes}")
    hier = two_tier if hierarchical is None else (hierarchical and two_tier)
    _check_codec(wire_codec, values)
    if hier and capacity is not None:
        raise ValueError(
            "capacity= overrides the FLAT exchange capacity; the "
            "hierarchical path measures three per-phase capacities "
            "(pass hierarchical=False to pin the flat one)")
    devs = _entries(mesh, axes)
    lens = [int(t.shape[0]) for t in shards]
    m = max(1, max(lens))
    if use_histogram is None:
        use_histogram = devs[0].type == "cuda"
    s = samples_per_shard or default_samples_per_shard(m, n_dev)
    slack = capacity_slack if capacity_slack is not None \
        else _tuning.active().capacity_slack
    track = values is not None or return_indices
    kc = keycodec.key_dtype(dtype)
    itemsize = torch.empty((), dtype=kc).element_size() + \
        (values[0].element_size() if values is not None else 0)
    pools, off = [], 0
    for d, (t, dev) in enumerate(zip(shards, devs)):
        k = _to_order_keys(coll.copy_to(t, dev), descending)
        v = None if values is None else \
            keycodec.to_signed(coll.copy_to(values[d], dev))
        pools.append(_local_sort(k, v, lens[d], off, m, track, local_method,
                                 dev))
        off += lens[d]
    if n_dev == 1:
        return [_Pool(pools[0].k[:lens[0]], None if not track
                      else pools[0].p[:lens[0]],
                      None if values is None else pools[0].v[:lens[0]],
                      lens[0], devs[0])], dtype, \
            None if values is None else values[0].dtype
    if hier:
        out = _hier(pools, devs, lens, mesh, axes, m, s, slack,
                    use_histogram, merge_backend, pipeline_chunks,
                    wire_codec, itemsize)
    else:
        out = _flat(pools, devs, lens, mesh, axes, m, s, capacity, slack,
                    use_histogram, merge_backend, pipeline_chunks,
                    wire_codec, itemsize)
    return out, dtype, None if values is None else values[0].dtype


def _results(pools, dtype, vdtype, descending, return_indices):
    keys = [_from_order_keys(pl.k, dtype, descending) for pl in pools]
    if return_indices:
        return keys, [pl.p for pl in pools]
    if vdtype is not None:
        return keys, [keycodec.from_signed(pl.v, vdtype) for pl in pools]
    return keys


def sample_sort_shards(shards: Sequence[torch.Tensor], mesh,
                       axis_name: AxisArg = "data", *,
                       values: Optional[Sequence[torch.Tensor]] = None,
                       descending: bool = False,
                       return_indices: bool = False,
                       local_method: Optional[str] = None,
                       samples_per_shard: Optional[int] = None,
                       capacity: Optional[int] = None,
                       capacity_slack: Optional[float] = None,
                       use_histogram: Optional[bool] = None,
                       merge_backend: Optional[str] = None,
                       hierarchical: Optional[bool] = None,
                       pipeline_chunks: Optional[int] = None,
                       wire_codec: Optional[str] = None):
    """The shard-level entry: one 1-D tensor per mesh entry over
    ``axis_name``, in row-major (linear) order, the global array being
    their concatenation.  Returns the globally sorted array cut into
    shards of the same lengths, each on its entry's device (with
    ``values``: ``(key shards, payload shards)``; with
    ``return_indices``: ``(key shards, global position shards)``, the
    stable permutation).  What a multi-card caller uses without gathering;
    the options are :func:`sample_sort`'s."""
    axes = _axes_tuple(mesh, axis_name)
    pools, dtype, vdtype = _sort_shards(
        list(shards), mesh, axes, None if values is None else list(values),
        descending, return_indices, local_method, samples_per_shard,
        capacity, capacity_slack, use_histogram, merge_backend,
        hierarchical, pipeline_chunks, wire_codec)
    return _results(pools, dtype, vdtype, descending, return_indices)


def sample_sort(x: torch.Tensor, mesh, axis_name: AxisArg = "data", *,
                values: Optional[torch.Tensor] = None,
                descending: bool = False,
                return_indices: bool = False,
                local_method: Optional[str] = None,
                samples_per_shard: Optional[int] = None,
                capacity: Optional[int] = None,
                capacity_slack: Optional[float] = None,
                use_histogram: Optional[bool] = None,
                merge_backend: Optional[str] = None,
                hierarchical: Optional[bool] = None,
                pipeline_chunks: Optional[int] = None,
                wire_codec: Optional[str] = None):
    """Sort a 1-D tensor globally over ``axis_name`` (one mesh axis, a
    tuple of axes, or None for the whole mesh).  The input is cut into
    ``ceil(n / D)``-element shards, one an entry; the result is the
    global sorted tensor on the mesh's first entry's device (with
    ``values``: ``(keys, values)``; with ``return_indices``: ``(keys,
    int32 permutation)``).  Ties keep ascending index order.

    On a two-axis mesh the two-level schedule runs by default
    (``hierarchical=False`` pins the flat one; both give the same bits).
    ``capacity`` overrides the flat exchange's measured capacity (raising
    if the realized buckets do not fit); ``capacity_slack`` multiplies the
    measured maxima; ``pipeline_chunks`` cuts the outer exchange into that
    many slices; ``wire_codec='int8'`` sends a float payload through the
    int8 codec on the outer tier (keys travel wide, so the order stays
    exact).  ``use_histogram`` (default: on a card) counts the buckets
    with K3's bucket histogram rather than a binary search."""
    x = torch.as_tensor(x)
    if x.dim() != 1:
        raise ValueError(f"sample_sort sorts flat 1-D arrays, got "
                         f"{tuple(x.shape)}")
    if not keycodec.supports(x.dtype):
        raise ValueError(
            f"sample_sort needs a keycodec dtype {keycodec.SUPPORTED}, "
            f"got {keycodec.dtype_name(x.dtype)!r}")
    axes = _axes_tuple(mesh, axis_name)
    n_dev = _n_dev(mesh, axes)
    n = x.shape[0]
    m = -(-n // n_dev) if n else 0
    if values is not None:
        values = torch.as_tensor(values)
        if values.shape != x.shape:
            raise ValueError(f"values shape {tuple(values.shape)} must "
                             f"match keys shape {tuple(x.shape)}")
    bounds = [min(d * m, n) for d in range(n_dev + 1)]
    shards = [x[bounds[d]:bounds[d + 1]] for d in range(n_dev)]
    vshards = None if values is None else \
        [values[bounds[d]:bounds[d + 1]] for d in range(n_dev)]
    out = sample_sort_shards(
        shards, mesh, axes, values=vshards, descending=descending,
        return_indices=return_indices, local_method=local_method,
        samples_per_shard=samples_per_shard, capacity=capacity,
        capacity_slack=capacity_slack, use_histogram=use_histogram,
        merge_backend=merge_backend, hierarchical=hierarchical,
        pipeline_chunks=pipeline_chunks, wire_codec=wire_codec)
    first = _entries(mesh, axes)[0]

    def cat(parts):
        return torch.cat([coll.copy_to(t, first) for t in parts])
    if values is not None or return_indices:
        return cat(out[0]), cat(out[1])
    return cat(out)


# ---------------------------------------------------------------------------
# distributed top-k: local select -> ONE candidate all-gather -> tiny merge
# ---------------------------------------------------------------------------

def sample_topk(x: torch.Tensor, k: int, mesh,
                axis_name: AxisArg = "data"):
    """Mesh-global top-k of a flat tensor -> ``(values, int32 indices)``,
    both ``(k,)`` on the mesh's first entry's device, bit-exact with
    ``jax.lax.top_k`` on the whole array (values descending, +0.0 above
    -0.0, ties the lowest global index first).

    Each entry selects its shard's ``min(k, m)`` candidates with K4's
    radix select (``select_topk_encoded``; the plain version on the CPU),
    ONE all-gather moves the ``D * min(k, m)`` (key, index) pairs, and
    every entry sorts that small pool by (key, index).  A shard with g
    genuine keys offers ``min(k, g)`` of them, so the global top-k is in
    the pool whenever ``n >= k``."""
    from repro_torch.kernels import radix_select as _sel
    x = torch.as_tensor(x)
    if x.dim() != 1:
        raise ValueError(f"sample_topk selects over flat 1-D arrays, "
                         f"got {tuple(x.shape)}")
    if not keycodec.supports(x.dtype):
        raise ValueError(
            f"sample_topk needs a keycodec dtype {keycodec.SUPPORTED}, "
            f"got {keycodec.dtype_name(x.dtype)!r}")
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(
            f"topk k must satisfy 1 <= k <= n (n={n}); got k={k}")
    axes = _axes_tuple(mesh, axis_name)
    n_dev = _n_dev(mesh, axes)
    devs = _entries(mesh, axes)
    m = -(-n // n_dev)
    kc = min(k, m)
    bits = keycodec.key_bits(x.dtype)
    mask = (1 << bits) - 1
    cand_bytes = 0
    if _obs.enabled():
        cand_bytes = n_dev * topk_candidate_bytes_per_device(
            n_dev, k, m, bits // 8)
        metrics.counter("samplesort.topk_candidate_bytes").inc(cand_bytes)
        if len(axes) == 2:
            coll.record_split_exchange(cand_bytes, int(mesh.shape[axes[1]]),
                                       int(mesh.shape[axes[0]]))
        else:
            coll.record_exchange("nvlink", cand_bytes)
    sp = _obs.trace("samplesort.topk", n=n, k=k, n_dev=n_dev,
                    bytes=cand_bytes)
    with sp:
        cands = []
        for d, dev in enumerate(devs):
            base = d * m
            shard = coll.copy_to(x[min(base, n):min(base + m, n)], dev)
            nv = shard.shape[0]
            enc = keycodec.encode(shard, descending=True)
            e = torch.full((m,), -1, dtype=enc.dtype, device=dev)
            e[:nv] = enc                      # pads: the maximal code
            le, li = _sel.select_topk_encoded(e[None], kc)
            gi = torch.where(li[0] < nv, base + li[0],
                             torch.full_like(li[0], n))
            comp = ((le[0].to(torch.int64) & mask) << 31) \
                | gi.to(torch.int64)
            cands.append(comp)
        pools = coll.all_gather(cands, devs)
        outs = [torch.sort(pl).values[:k] for pl in pools]
        top = outs[0]
        sp.fence(top)
    enc = top >> 31
    enc = torch.where(enc >= 1 << (bits - 1), enc - (1 << bits), enc) \
        .to(keycodec.key_dtype(x.dtype))
    idx = (top & ((1 << 31) - 1)).to(torch.int32)
    return keycodec.decode(enc, x.dtype, descending=True), idx
