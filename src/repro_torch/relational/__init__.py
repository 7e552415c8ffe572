"""repro_torch.relational — sort-powered relational ops.

The port of the JAX package's ``repro.relational``: every op is a sort (or
a radix selection) plus an O(n) scan / searchsorted post-pass, described
by one frozen :class:`~repro_torch.relational.relspec.RelSpec` and run by
``run``::

    import repro_torch.relational as rel

    rel.unique(x, return_counts=True)          # dedup (np.unique semantics)
    rel.group_by(keys, vals, agg=("sum", "mean"))
    rel.join(left_keys, right_keys, size=64)   # sorted equi-join
    rel.run_length_encode(x)                   # sorted-column RLE
    rel.delta_encode(ids)                      # sorted-column deltas (ints)
    rel.histogram(x, num_bins=32)
    rel.quantiles(x, (0.5, 0.99))              # radix-select order statistics
    rel.group_ranks(expert_ids, num_groups=E)  # MoE dispatch primitive

Every entry point takes ``device=`` (default ``"cuda"``), moves its
inputs there and returns on it; ``device="cuda"`` without a card raises.
On a card the sorts run the kernels the planner picks
(``planner.choose_relational``: K3 for the stable sorts, K1 runs and K2
merges on the merge route) and ``quantiles`` runs K4; the post-passes are
PyTorch ops, as they are XLA ops in the JAX package.

Static-shape contract: data-dependent result sizes (unique values, groups,
join pairs, runs) come back as fixed-size padded tensors + a valid count.
``unique``, ``group_by`` and ``join`` take ``mesh``/``axis_name``: the
sort backbone goes mesh-global (``engine.samplesort``).  On a one-process
``core.mesh.Mesh`` the post-pass runs on the mesh's first entry's device,
``device`` aside.  On a ``DeviceMesh`` (one program a rank, every rank
making the call) a column is a DTensor placed ``Shard(0)`` over the
axes, or a tensor every rank holds whole, on the rank's device; the sort
is the rank sort, every rank runs the post-pass on the gathered sorted
columns, and the result is replicated on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.mesh import Mesh, is_device_mesh
from repro_torch.core.sortspec import resolve_device
from repro_torch.relational.relspec import AGGS, OPS, RelSpec  # noqa: F401
# module handles bound BEFORE the wrapper defs below shadow the submodule
# names on the package (rel.unique the function vs relational/unique.py)
from repro_torch.relational import encode as _encode_mod
from repro_torch.relational import groupby as _groupby_mod
from repro_torch.relational import join as _join_mod
from repro_torch.relational import sketch as _sketch_mod
from repro_torch.relational import unique as _unique_mod
from repro_torch.relational.encode import (  # noqa: F401
    Delta, RunLength, delta_decode, rle_decode)
from repro_torch.relational.groupby import GroupBy, GroupRanks  # noqa: F401
from repro_torch.relational.join import Join  # noqa: F401
from repro_torch.relational.sketch import (  # noqa: F401
    HistogramSketch, QuantileSketch)
from repro_torch.relational.unique import Unique  # noqa: F401

__all__ = [
    "RelSpec", "OPS", "AGGS", "run",
    "unique", "group_by", "join", "run_length_encode", "rle_decode",
    "delta_encode", "delta_decode", "histogram", "quantiles",
    "group_ranks",
    "Unique", "GroupBy", "GroupRanks", "Join", "RunLength", "Delta",
    "HistogramSketch", "QuantileSketch",
]


def _on(t, dev: torch.device) -> Optional[torch.Tensor]:
    return None if t is None else torch.as_tensor(t).to(dev)


def _whole(t, spec: RelSpec) -> Optional[torch.Tensor]:
    """A column of a ``DeviceMesh`` op, whole on this rank: a DTensor's
    shards gathered, or the tensor itself; on the rank's device, never
    moved there."""
    from torch.distributed.tensor import DTensor
    from repro_torch.engine import samplesort as _ss
    if t is None:
        return None
    axes = _ss._axes_tuple(spec.mesh, spec.axis_name)
    if isinstance(t, DTensor):
        return _ss.gather_shards(
            _ss._dtensor_local(t, spec.mesh, axes, f"relational {spec.op}"),
            spec.mesh, axes)
    t = torch.as_tensor(t)
    if t.device.type != spec.mesh.device_type:
        raise ValueError(f"relational {spec.op}: a {t.device} column on a "
                         f"{spec.mesh.device_type!r} DeviceMesh; the rank "
                         f"form moves no column")
    return t


def run(spec: RelSpec, x, values=None, *, device="cuda"):
    """Execute ``spec`` on ``device``.  ``x`` is the (key) column;
    ``values`` is the payload column (group_by) or the right key column
    (join)."""
    # a mesh op's post-pass runs where the mesh sort returns: the first
    # entry's device of a one-process Mesh, every rank of a DeviceMesh
    if isinstance(spec.mesh, Mesh):
        device = spec.mesh.devices.flat[0]
    if is_device_mesh(spec.mesh):
        x, values = (_whole(t, spec) for t in (x, values))
    else:
        dev = resolve_device(device)
        x, values = _on(x, dev), _on(values, dev)
    spec = spec.canonical(x, values)
    if spec.op == "unique":
        return _unique_mod.run(spec, x)
    if spec.op == "group_by":
        return _groupby_mod.run(spec, x, values)
    if spec.op == "join":
        return _join_mod.run(spec, x, values)
    if spec.op == "rle":
        return _encode_mod.run_rle(spec, x)
    if spec.op == "delta":
        return _encode_mod.run_delta(spec, x)
    if spec.op == "histogram":
        return _sketch_mod.run_histogram(spec, x)
    if spec.op == "quantile":
        return _sketch_mod.run_quantile(spec, x)
    return _groupby_mod.run_group_ranks(spec, x)


# ---------------------------------------------------------------------------
# wrappers: each builds a spec and runs it
# ---------------------------------------------------------------------------

def unique(x, *, return_inverse: bool = False, return_counts: bool = False,
           fill_value=None, method: Optional[str] = None, mesh=None,
           axis_name: Optional[str] = None, device="cuda") -> Unique:
    """Distinct values of a column, ascending (np.unique semantics): sort,
    adjacent-diff mask, searchsorted compaction."""
    return run(RelSpec(op="unique", return_inverse=return_inverse,
                       return_counts=return_counts, fill_value=fill_value,
                       method=method, mesh=mesh, axis_name=axis_name),
               x, device=device)


def group_by(keys, values, *, agg: Union[str, Tuple[str, ...]] = "sum",
             fill_value=None, method: Optional[str] = None, mesh=None,
             axis_name: Optional[str] = None, device="cuda") -> GroupBy:
    """Aggregate ``values`` per distinct key: stable key-value sort ->
    boundary flags -> segment reductions.  ``agg`` is one of (or a tuple
    from) ``AGGS``; results follow its order in ``.aggregates``."""
    return run(RelSpec(op="group_by", agg=agg, fill_value=fill_value,
                       method=method, mesh=mesh, axis_name=axis_name),
               keys, values, device=device)


def join(left_keys, right_keys, *, size: Optional[int] = None,
         fill_value=None, method: Optional[str] = None, mesh=None,
         axis_name: Optional[str] = None, device="cuda") -> Join:
    """Sorted equi-join -> matching (left, right) index pairs, padded to
    ``size`` (default ``n_l * n_r``; pass a real bound for large
    columns).  With ``mesh`` both columns' stable orders come from the
    mesh sort."""
    return run(RelSpec(op="join", size=size, fill_value=fill_value,
                       method=method, mesh=mesh, axis_name=axis_name),
               left_keys, right_keys, device=device)


def run_length_encode(x, *, assume_sorted: bool = False, fill_value=None,
                      method: Optional[str] = None,
                      device="cuda") -> RunLength:
    """Run-length encode the sorted column (sorts first unless
    ``assume_sorted``); ``rle_decode`` rebuilds it exactly."""
    return run(RelSpec(op="rle", assume_sorted=assume_sorted,
                       fill_value=fill_value, method=method), x,
               device=device)


def delta_encode(x, *, assume_sorted: bool = False,
                 method: Optional[str] = None, device="cuda") -> Delta:
    """Delta encode the sorted integer column (modular, bit-exact round
    trip through ``delta_decode``)."""
    return run(RelSpec(op="delta", assume_sorted=assume_sorted,
                       method=method), x, device=device)


def histogram(x, num_bins: int, *, lo=None, hi=None,
              device="cuda") -> HistogramSketch:
    """Equi-width histogram over [lo, hi] (default: the column's range):
    searchsorted over explicit float32 edges, rightmost bin closed."""
    return run(RelSpec(op="histogram", num_bins=num_bins, lo=lo, hi=hi), x,
               device=device)


def quantiles(x, qs, *, device="cuda") -> QuantileSketch:
    """Lower order statistics at fractions ``qs`` through one bottom-k
    radix selection (K4 on a card); every answer is an element of the
    column."""
    qs = (qs,) if isinstance(qs, float) else tuple(qs)
    return run(RelSpec(op="quantile", qs=qs), x, device=device)


def group_ranks(keys, num_groups: int, *, constrain=None,
                method: Optional[str] = None, device="cuda") -> GroupRanks:
    """Each element's 0-based arrival rank within its key group plus the
    group sizes: the counting-sort dispatch primitive of MoE routing.
    ``constrain`` (optional callable) is applied to the one-hot of the
    small-domain path."""
    keys = _on(keys, resolve_device(device))
    spec = RelSpec(op="group_ranks", num_groups=num_groups,
                   method=method).canonical(keys)
    return _groupby_mod.run_group_ranks(spec, keys, constrain=constrain)
