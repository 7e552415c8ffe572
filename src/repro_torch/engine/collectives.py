"""Collectives: the one home of the distributed tier's exchanges.

The port of the JAX package's ``engine/collectives.py``, whose exchanges
are ``jax.lax`` collectives inside ``shard_map`` programs.  The port has
them in two forms (``core.mesh`` says which runs where):

**One process** (a :class:`~repro_torch.core.mesh.Mesh`): a host loop
over the entries of a group, every exchange a copy into a FRESH buffer on
the destination entry's device (``copy_(non_blocking=True)``), never a
view of the source: also between two entries on one card, so the bytes
the counters record are bytes that moved.

  * :func:`all_to_all` — the bucket exchange: entry j receives row j of
    every entry's send buffer.
  * :func:`chunked_all_to_all` — the same exchange as ``chunks`` separate
    exchanges over contiguous slices of every bucket, so the receiver
    merges ``p * chunks`` shorter runs.
  * :func:`all_gather` — every entry receives the concatenation.
  * :func:`redistribute` — the rank-directed rebalance: the group's
    pieces, in rank order, re-cut into given lengths on given devices.

**One program a rank** (a ``DeviceMesh``): :class:`RankGroup` runs the
same exchanges through ``torch.distributed`` on the process group of the
sort's axes: ``all_to_all_single`` (equal splits for the buckets, split
sizes for the rebalance and for odd-even's pair exchange, the
reference's ``ppermute``), ``all_gather`` and an ``all_reduce(MAX)`` of
the bucket maximum (the reference's ``_sync_max``).  Buffers travel as
byte views (``.view(torch.uint8)``): gloo carries no 16-bit or unsigned
wider integer, so every keycodec dtype and payload goes as bytes.  A
collective the backend refuses raises, naming the collective and the
backend; nothing falls back to the one-process form or to the host.
:class:`EntryGroup` gives the one-process form the same interface, so the
sample sort's schedules are written once over either.

Shared by both:

  * the int8 wire codec — per-bucket absmax scale, round to nearest,
    ``optim/grad_compress``'s scheme, for float payload buckets only
    (keys always travel wide).
  * :func:`record_exchange` / :func:`split_bytes` — per-tier byte
    counters (``collectives.nvlink_bytes``, ``collectives.network_bytes``)
    in ``repro_torch.obs``; a rank records its share
    (:meth:`RankGroup.share`), so the ranks' counts sum to the one-process
    count over the same shards.

A group is a list of flat (row-major) mesh entries; :func:`axis_groups`
cuts a mesh into the groups along some of its axes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs import metrics, trace as _obs

__all__ = [
    "AxisName", "all_to_all", "chunked_all_to_all", "all_gather",
    "copy_to", "redistribute", "pipeline_chunks", "wire_encode_int8",
    "wire_decode_int8", "wire_bytes_saved", "record_exchange",
    "record_split_exchange", "split_bytes", "axis_sizes", "axis_groups",
    "EntryGroup", "RankGroup", "DEFAULT_PIPELINE_CHUNKS", "WIRE_CODECS",
]

AxisName = Union[str, Tuple[str, ...]]

# slices the slow-tier bucket exchange is cut into by default
DEFAULT_PIPELINE_CHUNKS = 4

WIRE_CODECS = ("int8",)


def copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` copied into a fresh buffer on ``device``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def all_to_all(sends: Sequence[torch.Tensor], devices: Sequence
               ) -> List[torch.Tensor]:
    """Group of p entries, ``sends[i]`` of shape (p, ...) on entry i ->
    ``out[j]`` of shape (p, ...) on ``devices[j]``, row i being
    ``sends[i][j]``: what entry i sent entry j."""
    p = len(sends)
    outs = []
    for j in range(p):
        out = torch.empty((p,) + tuple(sends[0].shape[1:]),
                          dtype=sends[0].dtype, device=devices[j])
        for i in range(p):
            out[i].copy_(sends[i][j], non_blocking=True)
        outs.append(out)
    return outs


def pipeline_chunks(capacity: int, requested: Optional[int] = None) -> int:
    """The realizable chunk count for a bucket of ``capacity`` slots: the
    largest power of two <= ``requested`` that divides the capacity."""
    req = DEFAULT_PIPELINE_CHUNKS if requested is None else requested
    req = max(1, req)
    chunks = 1
    while chunks * 2 <= min(req, capacity) and capacity % (chunks * 2) == 0:
        chunks *= 2
    return chunks


def chunked_all_to_all(sends: Sequence[torch.Tensor], devices: Sequence, *,
                       chunks: int = 1) -> List[torch.Tensor]:
    """(p, c) send buffers -> (p, chunks, c // chunks) per entry: the
    exchange issued as ``chunks`` exchanges of contiguous bucket slices.
    ``out[j][i, q]`` is slice q of the bucket entry i sent entry j; a
    slice of a sorted bucket is sorted, so the receiver holds
    ``p * chunks`` sorted runs."""
    p, c = sends[0].shape[:2]
    if chunks <= 1:
        return [o[:, None] for o in all_to_all(sends, devices)]
    if c % chunks:
        raise ValueError(
            f"bucket capacity {c} is not divisible by chunks={chunks} "
            f"(use pipeline_chunks to pick a realizable count)")
    cp = c // chunks
    outs = [torch.empty((p, chunks, cp), dtype=sends[0].dtype, device=d)
            for d in devices]
    for q in range(chunks):
        for j in range(p):
            for i in range(p):
                outs[j][i, q].copy_(sends[i][j, q * cp:(q + 1) * cp],
                                    non_blocking=True)
    return outs


def all_gather(tensors: Sequence[torch.Tensor], devices: Sequence
               ) -> List[torch.Tensor]:
    """Every entry receives the concatenation of the group's tensors
    (along their first axis), in a fresh buffer on its device."""
    sizes = [t.shape[0] for t in tensors]
    outs = []
    for d in devices:
        out = torch.empty((sum(sizes),) + tuple(tensors[0].shape[1:]),
                          dtype=tensors[0].dtype, device=d)
        at = 0
        for t, s in zip(tensors, sizes):
            out[at:at + s].copy_(t, non_blocking=True)
            at += s
        outs.append(out)
    return outs


def redistribute(pieces: Sequence[torch.Tensor], lengths: Sequence[int],
                 devices: Sequence) -> List[torch.Tensor]:
    """The concatenation of ``pieces`` (in rank order; piece j on its own
    entry) re-cut into slices of ``lengths``, slice t a fresh buffer on
    ``devices[t]``: every overlap of a piece and a slice is one copy.
    The sample sort's rebalance, where piece j holds the global ranks
    [off_j, off_j + len_j) and slice t must hold [O_t, O_t + L_t)."""
    total = sum(int(p.shape[0]) for p in pieces)
    if total != sum(lengths):
        raise ValueError(f"redistribute: {total} elements into slices of "
                         f"{sum(lengths)}")
    outs = [torch.empty((int(n),) + tuple(pieces[0].shape[1:]),
                        dtype=pieces[0].dtype, device=d)
            for n, d in zip(lengths, devices)]
    t, at = 0, 0                       # destination slice, offset in it
    for piece in pieces:
        src = 0
        while src < piece.shape[0]:
            while at == outs[t].shape[0]:
                t, at = t + 1, 0
            take = min(piece.shape[0] - src, outs[t].shape[0] - at)
            outs[t][at:at + take].copy_(piece[src:src + take],
                                        non_blocking=True)
            src, at = src + take, at + take
    return outs


# ---------------------------------------------------------------------------
# int8 wire codec (grad_compress's scheme, on exchange buckets)
# ---------------------------------------------------------------------------

def wire_encode_int8(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, c) float buckets -> (int8 buckets, (p, 1) float32 scales):
    per-bucket absmax scale, round to nearest.  Lossy: payloads only."""
    f = v.to(torch.float32)
    a = f.abs().amax(dim=-1, keepdim=True) if f.shape[-1] else \
        torch.zeros(f.shape[:-1] + (1,), dtype=torch.float32,
                    device=f.device)
    # a full tensor divisor: torch turns a division by a Python scalar
    # into a product by its reciprocal, which rounds differently
    scale = a / torch.full_like(a, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(f / safe), -127, 127)
    return q.to(torch.int8), safe


def wire_decode_int8(q: torch.Tensor, scale: torch.Tensor,
                     dtype) -> torch.Tensor:
    """Inverse of :func:`wire_encode_int8` (up to quantisation)."""
    return (q.to(torch.float32) * scale).to(dtype)


def wire_bytes_saved(n_dev: int, capacity: int, itemsize: int) -> int:
    """Bytes the int8 codec keeps off the wire for one payload exchange:
    each slot shrinks to 1 byte plus a 4-byte scale a bucket."""
    wide = n_dev * capacity * itemsize
    narrow = n_dev * capacity * 1 + n_dev * 4
    return max(0, wide - narrow)


# ---------------------------------------------------------------------------
# per-tier movement accounting (no-ops when obs is off)
# ---------------------------------------------------------------------------

def record_exchange(tier: str, nbytes: int) -> None:
    """Count ``nbytes`` of exchange traffic against a topology tier:
    ``collectives.nvlink_bytes`` / ``collectives.network_bytes``."""
    if not _obs.enabled() or nbytes <= 0:
        return
    metrics.counter(f"collectives.{tier}_bytes").inc(int(nbytes))


def split_bytes(nbytes: int, inner: int, outer: int) -> dict:
    """One flat exchange over an ``outer x inner`` mesh by tier: with
    destinations uniform over it, ``(outer-1)/outer`` of the traffic
    crosses the network tier and the rest stays on NVLink."""
    if outer <= 1:
        return {"nvlink": int(nbytes)}
    f_net = (outer - 1) / outer
    return {"network": int(nbytes * f_net),
            "nvlink": int(nbytes * (1.0 - f_net))}


def record_split_exchange(nbytes: int, inner: int, outer: int) -> None:
    """Account one flat exchange over an ``outer x inner`` mesh
    (:func:`split_bytes`)."""
    for tier, b in split_bytes(nbytes, inner, outer).items():
        record_exchange(tier, b)


def axis_sizes(mesh, axes: Sequence[str]) -> Tuple[int, ...]:
    """Mesh axis sizes in the given order (validating membership)."""
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in mesh axes "
                             f"{tuple(mesh.axis_names)}")
    return tuple(int(mesh.shape[a]) for a in axes)


def axis_groups(mesh, axes: AxisName) -> List[List[int]]:
    """The groups of flat mesh entries that an exchange over ``axes``
    connects: the entries that differ only along ``axes``, each group in
    row-major order over ``axes`` (outer axis major), the groups in
    row-major order over the other axes."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axis_sizes(mesh, axes)
    names = list(mesh.axis_names)
    others = [a for a in names if a not in axes]
    ids = np.arange(mesh.size).reshape(mesh.devices.shape)
    perm = [names.index(a) for a in others + list(axes)]
    t = ids.transpose(perm)
    g = int(np.prod([mesh.shape[a] for a in axes]))
    return [list(map(int, row)) for row in t.reshape(-1, g)]


# ---------------------------------------------------------------------------
# groups: the one interface the sample sort's schedules run over
# ---------------------------------------------------------------------------

class EntryGroup:
    """p entries of a one-process :class:`~repro_torch.core.mesh.Mesh`,
    all held here: ``members`` are their linear indices over the sort's
    axes, ``local`` every position.  Lists passed in and out are aligned
    with ``local``."""

    def __init__(self, devices: Sequence, members: Sequence[int]):
        self.devs = list(devices)
        self.members = list(members)
        self.size = len(self.members)
        self.local = list(range(self.size))

    def dev(self, pos: int):
        return self.devs[pos]

    def sub(self, members: Sequence[int], axis: str) -> "EntryGroup":
        """The sub-group over ``members`` (positions of this group), the
        entries along ``axis``."""
        return EntryGroup([self.devs[e] for e in members],
                          [self.members[e] for e in members])

    def all_gather(self, ts):
        return all_gather(ts, self.devs)

    def all_to_all(self, sends):
        return all_to_all(sends, self.devs)

    def chunked_all_to_all(self, sends, chunks: int):
        return chunked_all_to_all(sends, self.devs, chunks=chunks)

    def table(self, counts) -> np.ndarray:
        """Each entry's (p,) count row stacked into the (size, p) host
        table."""
        return np.stack([c.cpu().numpy() for c in counts]).astype(np.int64)

    def redistribute(self, pieces, lengths):
        return redistribute(pieces, lengths, self.devs)

    def max_int(self, v: int) -> int:
        return int(v)

    def share(self, v: int) -> int:
        return int(v)


class RankGroup:
    """This rank's place in the process group of a ``DeviceMesh``'s sort
    axes.  ``members`` are the group's global ranks in linear order over
    the axes; ``local`` is this rank's position alone, so lists passed in
    and out hold one element.  Every exchange is one ``torch.distributed``
    collective of the group on byte views; a position's group rank may
    differ from it (``new_group`` orders by global rank), and the
    collectives reorder by it."""

    def __init__(self, mesh, axes: Sequence[str], device):
        import torch.distributed as dist
        from repro_torch.core.mesh import rank_group
        self.mesh, self.axes = mesh, tuple(axes)
        self.pg, self.members = rank_group(mesh, self.axes)
        self.size = len(self.members)
        self.pos = self.members.index(dist.get_rank())
        self.local = [self.pos]
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(self.pg))
        self.rank_of = [dist.get_group_rank(self.pg, g)
                        for g in self.members]
        self.in_order = self.rank_of == list(range(self.size))
        self._pos_of = [0] * self.size
        for pos, r in enumerate(self.rank_of):
            self._pos_of[r] = pos

    def dev(self, pos: int):
        return self.device

    def sub(self, members: Sequence[int], axis: str) -> Optional["RankGroup"]:
        """The group along ``axis`` if this rank is one of ``members``
        (positions of this group), else None."""
        if self.pos not in members:
            return None
        return RankGroup(self.mesh, (axis,), self.device)

    # -- the collectives ---------------------------------------------------
    def _run(self, name: str, fn, t: torch.Tensor):
        """One collective: a ``collectives.rank.<name>`` span with obs on
        (fenced, so its wall time is the exchange's), and a failure of
        the backend (a refused dtype or device, a lost peer) re-raised
        naming the collective and the backend."""
        if t.device != self.device:
            raise ValueError(f"{name}: a {t.device} tensor on a rank whose "
                             f"shard lies on {self.device}")
        with _obs.trace(f"collectives.rank.{name}", backend=self.backend,
                        size=self.size, bytes=t.numel() * t.element_size()
                        ) as sp:
            try:
                out = fn()
            except (RuntimeError, ValueError, TypeError,
                    NotImplementedError) as e:
                raise RuntimeError(
                    f"{name} failed on the {self.backend!r} backend with "
                    f"{t.device.type} tensors of {t.dtype} (the rank form "
                    f"does not fall back): {e}") from e
            sp.fence(t)
        return out

    def _a2av(self, name: str, chunks: Sequence[torch.Tensor],
              recv: Sequence[int], shape_tail, dtype) -> torch.Tensor:
        """``chunks[q]`` (1-D) goes to position q; ``recv[q]`` elements
        come from position q.  Returns the received elements in position
        order.  One ``all_to_all_single`` on byte views."""
        import torch.distributed as dist
        isz = torch.empty((), dtype=dtype).element_size()
        by_rank = [chunks[self._pos_of[r]] for r in range(self.size)]
        rin = [int(recv[self._pos_of[r]]) for r in range(self.size)]
        send = torch.cat([c.reshape(-1) for c in by_rank]) if by_rank \
            else torch.empty((0,), dtype=dtype, device=self.device)
        out = torch.empty((sum(rin),), dtype=dtype, device=self.device)
        self._run(name, lambda: dist.all_to_all_single(
            _bytes(out), _bytes(send),
            output_split_sizes=[n * isz for n in rin],
            input_split_sizes=[int(c.numel()) * isz for c in by_rank],
            group=self.pg), send)
        if not self.in_order:
            parts = list(torch.split(out, rin))
            out = torch.cat([parts[self.rank_of[q]]
                             for q in range(self.size)])
        return out.reshape((-1,) + tuple(shape_tail))

    def all_to_all(self, sends):
        """[(p, ...)] -> [(p, ...)]: row q of this rank's buffer goes to
        position q, and row i of the result came from position i."""
        import torch.distributed as dist
        (t,) = sends
        t = t.contiguous()
        if not self.in_order:
            rows = list(t)
            return [self._a2av("all_to_all", rows,
                               [rows[0].numel()] * self.size,
                               t.shape[1:], t.dtype)]
        out = torch.empty_like(t)
        self._run("all_to_all", lambda: dist.all_to_all_single(
            _bytes(out.reshape(self.size, -1)),
            _bytes(t.reshape(self.size, -1)), group=self.pg), t)
        return [out]

    def chunked_all_to_all(self, sends, chunks: int):
        """[(p, c)] -> [(p, chunks, c // chunks)]: the exchange issued as
        ``chunks`` exchanges of contiguous bucket slices."""
        (t,) = sends
        p, c = t.shape[:2]
        if chunks <= 1:
            return [self.all_to_all([t])[0][:, None]]
        if c % chunks:
            raise ValueError(
                f"bucket capacity {c} is not divisible by chunks={chunks} "
                f"(use pipeline_chunks to pick a realizable count)")
        cp = c // chunks
        parts = [self.all_to_all([t[:, q * cp:(q + 1) * cp].contiguous()])[0]
                 for q in range(chunks)]
        return [torch.stack(parts, dim=1)]

    def all_gather(self, ts):
        """[t] -> [the group's tensors concatenated in position order]
        (one ``all_gather``; every rank's ``t`` has the same shape)."""
        import torch.distributed as dist
        (t,) = ts
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._run("all_gather", lambda: dist.all_gather(
            [_bytes(o) for o in outs], _bytes(t), group=self.pg), t)
        return [torch.cat([outs[r] for r in self.rank_of])]

    def all_gather_v(self, t: torch.Tensor, lens: Sequence[int]
                     ) -> torch.Tensor:
        """The group's 1-D tensors of lengths ``lens`` (position order)
        concatenated: each padded to the longest, one ``all_gather``."""
        top = max(1, max(int(n) for n in lens))
        pad = torch.zeros((top,), dtype=t.dtype, device=self.device)
        pad[:t.shape[0]] = t
        (g,) = self.all_gather([pad])
        return torch.cat([g[q * top:q * top + int(n)]
                          for q, n in enumerate(lens)])

    def table(self, counts) -> np.ndarray:
        """This rank's (p,) count row -> the group's (size, p) host
        table."""
        (c,) = counts
        (g,) = self.all_gather([c.to(torch.int64)])
        return g.reshape(self.size, -1).cpu().numpy()

    def lengths(self, n: int) -> List[int]:
        """This rank's length -> every position's, in position order."""
        t = torch.tensor([int(n)], dtype=torch.int64, device=self.device)
        (g,) = self.all_gather([t])
        return [int(v) for v in g.cpu()]

    def max_int(self, v: int) -> int:
        """The group's maximum of ``v``: one ``all_reduce(MAX)``, so every
        rank picks the same capacity and chunk count."""
        import torch.distributed as dist
        t = torch.tensor([int(v)], dtype=torch.int64, device=self.device)
        self._run("all_reduce(MAX)", lambda: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=self.pg), t)
        return int(t.item())

    def redistribute(self, pieces, lengths):
        """[this rank's piece] -> [its slice of the group's pieces, in
        position order, re-cut into ``lengths``]: one
        ``all_to_all_single`` with split sizes (and one ``all_gather`` of
        the pieces' lengths)."""
        (piece,) = pieces
        plens = self.lengths(piece.shape[0])
        total = sum(plens)
        if total != sum(lengths):
            raise ValueError(f"redistribute: {total} elements into slices "
                             f"of {sum(lengths)}")
        poff = np.concatenate([[0], np.cumsum(plens)])
        soff = np.concatenate([[0], np.cumsum(lengths)])
        me = self.pos
        chunks, recv = [], []
        for q in range(self.size):
            lo = max(poff[me], soff[q])
            hi = min(poff[me + 1], soff[q + 1])
            chunks.append(piece[int(lo - poff[me]):
                                int(max(lo, hi) - poff[me])])
            lo = max(poff[q], soff[me])
            hi = min(poff[q + 1], soff[me + 1])
            recv.append(int(max(0, hi - lo)))
        return [self._a2av("redistribute", chunks, recv, piece.shape[1:],
                           piece.dtype)]

    def exchange_pair(self, t: torch.Tensor, partner: int
                      ) -> Optional[torch.Tensor]:
        """Odd-even's pair exchange (the reference's ``ppermute``): this
        rank's ``t`` goes to position ``partner`` and the partner's comes
        back; a rank paired with itself sends and receives nothing (None).
        One ``all_to_all_single`` with zero splits for the others."""
        n = t.shape[0]
        chunks = [t[:0]] * self.size
        recv = [0] * self.size
        if partner != self.pos:
            chunks[partner], recv[partner] = t, n
        out = self._a2av("pair exchange", chunks, recv, t.shape[1:],
                         t.dtype)
        return None if partner == self.pos else out

    def share(self, v: int) -> int:
        """This rank's part of a count the whole group made: the parts of
        the group's ranks sum to ``v``."""
        v = int(v)
        return v // self.size + (1 if self.pos < v % self.size else 0)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as its bytes (the wire form)."""
    t = t.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)
