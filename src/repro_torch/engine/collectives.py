"""Collectives: the one home of the distributed tier's exchanges.

The port of the JAX package's ``engine/collectives.py`` on a
:class:`~repro_torch.core.mesh.Mesh` in one process.  Where the reference
issues ``jax.lax`` collectives inside ``shard_map`` programs, the port
runs a host loop over the entries of a group, and every exchange is a
copy into a FRESH buffer on the destination entry's device
(``copy_(non_blocking=True)``), never a view of the source: also between
two entries on one card, so the bytes the counters record are bytes that
moved.

  * :func:`all_to_all` — the bucket exchange: entry j receives row j of
    every entry's send buffer.
  * :func:`chunked_all_to_all` — the same exchange as ``chunks`` separate
    exchanges over contiguous slices of every bucket, so the receiver
    merges ``p * chunks`` shorter runs.
  * :func:`all_gather` — every entry receives the concatenation.
  * :func:`redistribute` — the rank-directed rebalance: the group's
    pieces, in rank order, re-cut into given lengths on given devices.
  * the int8 wire codec — per-bucket absmax scale, round to nearest,
    ``optim/grad_compress``'s scheme, for float payload buckets only
    (keys always travel wide).
  * :func:`record_exchange` / :func:`record_split_exchange` — per-tier
    byte counters (``collectives.nvlink_bytes``,
    ``collectives.network_bytes``) in ``repro_torch.obs``.

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
    "record_split_exchange", "axis_sizes", "axis_groups", "DEFAULT_PIPELINE_CHUNKS", "WIRE_CODECS",
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


def record_split_exchange(nbytes: int, inner: int, outer: int) -> None:
    """Account one flat exchange over an ``outer x inner`` mesh: with
    destinations uniform over it, ``(outer-1)/outer`` of the traffic
    crosses the network tier and the rest stays on NVLink."""
    if outer <= 1:
        record_exchange("nvlink", nbytes)
        return
    f_net = (outer - 1) / outer
    record_exchange("network", int(nbytes * f_net))
    record_exchange("nvlink", int(nbytes * (1.0 - f_net)))


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
