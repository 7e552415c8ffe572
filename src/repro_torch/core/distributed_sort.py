"""Mesh-distributed sorting: the paper's partitioning scaled to devices.

The port of the JAX package's ``core/distributed_sort.py``.  §II-B
partitions one SRAM macro so its CAS blocks run concurrently and pays the
Eq. 3-4 temp-row cycles to exchange operands between partitions; on a
mesh a partition is an entry (a card, or a share of one), and the
exchange is a copy between entries (``engine.collectives``).

One entry point, three strategies (``strategy="auto"`` prices them with
``planner.choose_distributed``, on a two-axis mesh against its
``core.topology.Topology``):

  ``oddeven``  odd-even transposition: D rounds of a neighbour exchange
               and a merge-split.  Every shard moves D times; kept as the
               small-(n, D) strategy.  Ascending, evenly divisible,
               key-only, one mesh axis.
  ``sample``   the single-round sample sort (``engine/samplesort.py``):
               any length, either direction, key-value and permutations.
  ``hier``     the two-level sample sort (same module) on an (outer,
               inner) mesh.

Every strategy gives the same bits: keys are sorted in the keycodec's
order (-0.0 below +0.0), ties in ascending index order.
"""
from __future__ import annotations

from typing import Optional

import torch


def bitonic_merge_halves(lo_sorted: torch.Tensor, hi_sorted: torch.Tensor):
    """Merge two ascending tensors of length m (a power of two) and return
    the ascending (low half, high half): concat(a, reverse(b)) is bitonic,
    so only the merge substages run, each a (n/(2j), 2, j) view with
    min / max (the reference's reshape-addressed form)."""
    m = lo_sorted.shape[-1]
    z = torch.cat([lo_sorted, torch.flip(hi_sorted, [-1])], dim=-1)
    n = 2 * m
    lead = z.shape[:-1]
    j = n // 2
    while j >= 1:
        v = z.reshape(*lead, n // (2 * j), 2, j)
        lo, hi = v[..., 0, :], v[..., 1, :]
        z = torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                        dim=-2).reshape(*lead, n)
        j //= 2
    return z[..., :m], z[..., m:]


def _round_permutation(n_dev: int, even_round: bool):
    """Partner of each entry for one odd-even transposition round (an
    entry paired with itself idles: the last entry on even rounds when
    the count is odd; the edge entries on odd rounds)."""
    perm = []
    for i in range(n_dev):
        if even_round:
            partner = i ^ 1
            if partner >= n_dev:
                partner = i
        else:
            if i == 0 or (i == n_dev - 1 and n_dev % 2 == 0):
                partner = i
            else:
                partner = i + 1 if i % 2 == 1 else i - 1
        perm.append((i, partner))
    return perm


def distributed_sort(x: torch.Tensor, mesh, axis_name=None,
                     local_method: Optional[str] = None, *,
                     strategy: str = "auto", descending: bool = False,
                     values: Optional[torch.Tensor] = None,
                     return_indices: bool = False):
    """Sort a 1-D tensor globally over ``axis_name`` of ``mesh`` (one
    axis, a tuple of axes, or None for the whole mesh) -> the sorted
    tensor on the mesh's first entry's device (``(keys, values)`` with a
    payload, ``(keys, permutation)`` with ``return_indices``).

    ``strategy``: ``"auto"`` (``planner.choose_distributed``; on a
    two-axis mesh priced against the topology's tier rates),
    ``"sample"``, ``"hier"`` (two axes) or ``"oddeven"`` (one axis).  What
    odd-even cannot express (an uneven length, ``descending``, a payload,
    a permutation) routes to the sample sort under ``auto`` and raises
    when odd-even is forced.  ``local_method`` is the backend of the
    shards' local sorts (None: ``auto``)."""
    from repro_torch.core import topology as _topology
    from repro_torch.engine import planner, samplesort
    x = torch.as_tensor(x)
    axes = samplesort._axes_tuple(mesh, axis_name)
    n_dev = samplesort._n_dev(mesh, axes)
    multi = len(axes) > 1
    n = x.shape[-1]
    needs_sample = bool(descending or values is not None or return_indices
                        or n % n_dev)
    if strategy == "auto":
        topo = _topology.for_mesh(mesh, axes) if multi else None
        plan = planner.choose_distributed_cached(n, n_dev, x.dtype,
                                                 topology=topo)
        usable = {s: c for s, c in plan.costs.items()
                  if s != "oddeven" or not (needs_sample or multi)}
        strategy = min(usable, key=usable.__getitem__)
    if strategy not in ("sample", "oddeven", "hier"):
        raise ValueError(
            f"strategy must be 'auto', 'sample', 'hier' or 'oddeven', "
            f"got {strategy!r}")
    if strategy == "hier" and len(axes) != 2:
        raise ValueError(
            f"strategy='hier' needs a two-axis (outer, inner) mesh; "
            f"got axes {axes}")
    if strategy in ("sample", "hier"):
        return samplesort.sample_sort(
            x, mesh, axes, values=values, descending=descending,
            return_indices=return_indices, local_method=local_method,
            hierarchical=(strategy == "hier"))
    if multi:
        raise ValueError(
            "oddeven transposition runs over ONE mesh axis; pass a single "
            f"axis name or use strategy='sample'/'hier' (got axes {axes})")
    if needs_sample:
        raise ValueError(
            "oddeven strategy needs an evenly divisible, ascending, "
            "value-only sort (length % n_dev == 0, descending=False, "
            "values=None); use strategy='sample' or 'auto'")
    return _oddeven(x, mesh, axes, local_method)


def _oddeven(x, mesh, axes, local_method):
    """D rounds of neighbour exchange + merge-split over the entries, on
    signed-order keys (so the bits match the sample sort's).  Each round's
    merge is K2 on a card (the merge backend ``samplesort`` picks), its
    plain version elsewhere."""
    from repro_torch import engine
    from repro_torch.engine import collectives as coll
    from repro_torch.engine import samplesort as ss
    from repro_torch.engine.merge import merge_pairs
    from repro_torch.obs import metrics as _metrics, trace as _obs
    devs = ss._entries(mesh, axes)
    n_dev = len(devs)
    n = x.shape[0]
    m = n // n_dev
    coll_bytes = 0
    if _obs.enabled():
        coll_bytes = n_dev * collective_bytes_per_device(
            n_dev, m, x.element_size())
        _metrics.counter("distsort.oddeven_bytes").inc(coll_bytes)
        _metrics.counter("distsort.oddeven_sorts").inc()
        coll.record_exchange("nvlink", coll_bytes)
    sp = _obs.trace("distsort.oddeven", n=n, n_dev=n_dev, bytes=coll_bytes)
    with sp:
        xs = []
        for d, dev in enumerate(devs):
            k = ss._to_order_keys(coll.copy_to(x[d * m:(d + 1) * m], dev),
                                  False)
            xs.append(engine.sort(k, method=local_method or "auto",
                                  device=dev))
        for r in range(n_dev):
            pairs = _round_permutation(n_dev, r % 2 == 0)
            theirs = [coll.copy_to(xs[p], devs[i]) if p != i else None
                      for i, p in pairs]
            nxt = []
            for (i, p), mine, other in zip(pairs, xs, theirs):
                if p == i:
                    nxt.append(mine)
                    continue
                lo, hi = (mine, other) if i < p else (other, mine)
                merged = merge_pairs(lo[None], hi[None], backend=ss
                                     ._pick_merge_backend(m, devs[i]))[0]
                nxt.append(merged[:m] if i < p else merged[m:])
            xs = nxt
        first = devs[0]
        out = torch.cat([coll.copy_to(t, first) for t in xs])
        sp.fence(out)
    return ss._from_order_keys(out, x.dtype, False)


def distributed_topk(x: torch.Tensor, k: int, mesh, axis_name=None):
    """Mesh-global top-k -> ``(values, int32 indices)``, bit-exact with
    ``jax.lax.top_k``: local radix select a shard, ONE candidate
    all-gather, a small merge (``samplesort.sample_topk``)."""
    from repro_torch.engine import samplesort
    return samplesort.sample_topk(x, k, mesh, axis_name)


def collective_bytes_per_device(n_dev: int, local_elems: int,
                                itemsize: int) -> int:
    """Analytic exchange volume of odd-even's rounds (a device)."""
    return n_dev * local_elems * itemsize


__all__ = ["bitonic_merge_halves", "distributed_sort", "distributed_topk",
           "collective_bytes_per_device"]
