"""Shared machinery of the relational ops: the sorted post-pass
primitives, planner resolution and the obs plumbing.

Every op is (a sort through the front door) + (an O(n) scan / searchsorted
post-pass over the sorted column), as in the JAX package.  Compaction is
the cumulative-count ``searchsorted`` gather, no scatter; per-run lengths
are the differences of the run starts it finds, so counts need no atomic
adds on the card either.

``uint16``/``uint32`` columns ride the post-passes in the order-preserving
signed form of the same width (``keycodec.to_signed``): torch has no
comparison, gather or ``searchsorted`` for those dtypes on the CPU.
Equality and order are the same in that form, and ``from_signed`` gives the
bits back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.relational.relspec import RelSpec, SORT_OPS, STABLE_OPS


def boundary_mask(s: torch.Tensor) -> torch.Tensor:
    """(n,) sorted column -> (n,) bool, True where a new value starts.

    Numeric inequality, not encoded-key inequality: the key codec orders
    -0.0 below +0.0, but relationally they are one value (numpy's rule)."""
    n = s.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=s.device)
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=s.device),
                      s[1:] != s[:-1]])


def compact_sorted(s: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Gather the first element of each run of a sorted column to the front
    without a scatter -> ``(compacted, n_valid, segment_ids, lengths)``.

    ``compacted`` is (n,) with the distinct values ascending in the first
    ``n_valid`` (an int32 scalar) slots; the tail repeats the maximum, so
    the tensor stays non-decreasing (``searchsorted``-safe).
    ``segment_ids[i]`` (int32) is the run of sorted position i, and
    ``lengths`` (int32, (n,)) each run's length, 0 past ``n_valid``."""
    n = s.shape[0]
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    n_valid = csum[-1] if n else torch.zeros((), dtype=torch.int32,
                                             device=s.device)
    # slot j holds the first sorted position whose running run count
    # reaches j + 1; past the valid runs searchsorted answers n, clipped
    # to the maximum element
    src = torch.searchsorted(
        csum, torch.arange(1, n + 1, dtype=torch.int32, device=s.device),
        side="left", out_int32=True)
    compacted = s[src.clamp(0, max(n - 1, 0))]
    # a run's length is the next run's start minus its own (n past the end)
    ends = torch.cat([src[1:], src.new_full((min(n, 1),), n)])
    return compacted, n_valid, csum - 1, ends - src


def search_key(x: torch.Tensor) -> torch.Tensor:
    """The key a binary search over a column runs on, in the order of the
    JAX package's ``jnp.searchsorted``: floats as ``merge.order_key``
    (-0.0 with +0.0, every NaN one value above +inf), since
    ``torch.searchsorted`` mis-ranks keys against a NaN; other dtypes in
    their ``keycodec.to_signed`` form."""
    if x.is_floating_point():
        from repro_torch.engine.merge import order_key
        return order_key(x)
    return keycodec.to_signed(x)


def valid_mask(n_valid: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool, True at the slots below ``n_valid`` (built once an op)."""
    return torch.arange(n, dtype=torch.int32,
                        device=n_valid.device) < n_valid


def pad_tail(arr: torch.Tensor, valid: torch.Tensor, fill) -> torch.Tensor:
    """``fill`` at the slots where ``valid`` is False; ``fill`` takes
    ``arr``'s dtype, as ``jnp.asarray(fill, dtype)`` does."""
    pad = torch.tensor(fill, device=arr.device).to(arr.dtype)
    out = torch.where(valid, keycodec.to_signed(arr),
                      keycodec.to_signed(pad))
    return keycodec.from_signed(out, arr.dtype)


# ---------------------------------------------------------------------------
# planner resolution + obs
# ---------------------------------------------------------------------------

def resolve_plan(spec: RelSpec, n: int, dtype, device):
    """-> (method, plan).  Sketches, group_ranks and mesh specs (the mesh
    sort plans its own strategy) return (None, None).  An explicit method
    skips pricing; "auto" goes through the relational cost entries
    (``planner.choose_relational_cached``)."""
    if spec.mesh is not None or spec.op not in SORT_OPS:
        return None, None
    if spec.method != "auto":
        return spec.method, None
    if n == 0:
        return "torch", None
    from repro_torch.engine import planner
    plan = planner.choose_relational_cached(spec.op, n, dtype=dtype,
                                            device=device)
    return plan.method, plan


def span(spec: RelSpec, n: int):
    """Obs span of one relational op (the no-op span when obs is off),
    plus the per-op invocation counter."""
    from repro_torch.obs import trace as _obs
    sp = _obs.trace(f"relational.{spec.op}", n=n, method=spec.method,
                    distributed=spec.mesh is not None)
    if _obs.enabled():
        from repro_torch.obs import metrics as _m
        _m.counter(f"relational.{spec.op}").inc()
    return sp


def finish(sp, spec: RelSpec, plan, n: int) -> None:
    """Pair the fenced span with its relational plan: one
    ``relational_cost_observation`` event and the
    ``relational.cost_model_error`` ratio, kept apart from the sorts'
    ``planner.cost_model_error``.  No-op without a device time (obs off,
    or CPU tensors)."""
    if plan is None or sp.device_ms is None:
        return
    predicted = plan.costs.get(plan.method)
    if not predicted or predicted != predicted or predicted == float("inf"):
        return
    from repro_torch.obs import trace as _obs
    measured_ns = sp.device_ms * 1e6
    _obs.record_event("relational_cost_observation", op=spec.op, n=n,
                      method=plan.method, predicted_ns=predicted,
                      measured_ns=measured_ns,
                      error=measured_ns / predicted)
    from repro_torch.obs import metrics as _m
    _m.histogram("relational.cost_model_error").observe(
        measured_ns / predicted)


def _rank_sort(fn, x: torch.Tensor, spec, values=None):
    """A ``DeviceMesh`` op's sort backbone: the whole column ``x`` (every
    rank holds it) cut into this rank's shard as the one-process mesh
    sort cuts it, the rank sort through the front door ``fn``, and its
    result's shards gathered whole on every rank."""
    from repro_torch.engine import samplesort as ss
    mesh, axes = spec.mesh, spec.axis_name
    args = [ss.shard_of(x, mesh, axes)]
    if values is not None:
        args.append(ss.shard_of(values, mesh, axes))
    out = fn(*args, mesh=mesh, axis_name=axes)
    parts = out if isinstance(out, tuple) else (out,)
    whole = tuple(ss.gather_shards(t.to_local(), mesh, axes) for t in parts)
    return whole if isinstance(out, tuple) else whole[0]


def sorted_column(x: torch.Tensor, method: Optional[str],
                  values: Optional[torch.Tensor] = None, spec=None):
    """The op's sort backbone on the column's device: the mesh-global
    sample sort when ``spec`` has a mesh (the rank sort on a
    ``DeviceMesh``), else the planner-picked (or pinned) backend; with
    ``values`` a stable key-value sort.  A ``spill`` result (a CPU
    tensor) comes back to the column's device."""
    import repro_torch.sort as rsort
    from repro_torch.core.mesh import is_device_mesh
    if spec is not None and is_device_mesh(spec.mesh):
        return _rank_sort(rsort.sort if values is None else rsort.sort_kv,
                          x, spec, values)
    if spec is not None and spec.mesh is not None:
        if values is not None:
            return tuple(t.to(x.device) for t in rsort.sort_kv(
                x, values, mesh=spec.mesh, axis_name=spec.axis_name))
        return rsort.sort(x, mesh=spec.mesh,
                          axis_name=spec.axis_name).to(x.device)
    if values is not None:
        return tuple(t.to(x.device) for t in rsort.sort_kv(
            x, values, method=method, stable=True, device=x.device))
    return rsort.sort(x, method=method, device=x.device).to(x.device)


def stable_order(x: torch.Tensor, method: Optional[str],
                 spec=None) -> torch.Tensor:
    """Stable ascending permutation (int32) of a 1-D column through the
    front door (over the mesh when ``spec`` has one); a non-stable backend
    runs the engine's stable merge pipeline instead, as
    ``cost_model.relational_cost_ns`` prices it."""
    import repro_torch.sort as rsort
    from repro_torch.core.mesh import is_device_mesh
    if spec is not None and is_device_mesh(spec.mesh):
        return _rank_sort(rsort.argsort, x, spec)
    if spec is not None and spec.mesh is not None:
        return rsort.argsort(x, mesh=spec.mesh,
                             axis_name=spec.axis_name).to(x.device)
    return rsort.argsort(x, stable=True, method=method,
                         device=x.device).to(x.device)


__all__ = ["boundary_mask", "compact_sorted", "search_key", "valid_mask",
           "pad_tail",
           "resolve_plan",
           "span", "finish", "sorted_column", "stable_order",
           "SORT_OPS", "STABLE_OPS"]
