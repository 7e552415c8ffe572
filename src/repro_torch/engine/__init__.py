"""repro_torch.engine — the single-device sort engine.

``sort`` / ``sort_kv`` / ``argsort`` / ``topk`` accept any size: the
planner (planner.py) either hands the rows to one registered backend or
runs the hierarchy — tiled run generation (runs.py) and a tree of pairwise
merges (merge.py).  On a CUDA device the runs are sorted by the bitonic
kernel (by the radix kernels when the sort must be stable) and merged by
the merge-path kernel.  A top-k plan of the ``select`` backend runs the
radix-select kernel (K4), one of ``cuda`` the bitonic top-k kernel (K5).
Ragged and padded-row sorts (segmented.py) are two engine sorts each.
The mesh tier above them is ``samplesort.sample_sort`` (exported here with
the distributed plans, ``DistPlan`` / ``choose_distributed``), reached from
the front door through a spec's ``mesh``.

Every entry point takes ``device=`` (default ``"cuda"``), moves its input
there and returns on it; ``device="cuda"`` without a card raises.  The
exception is a sort the planner sends to the spill tier (its keys exceed
the profile's ``spill_threshold_bytes``): the plan is made from the shape
and dtype before anything moves, the input stays where it is (a host
input crosses to the card chunk by chunk) and the result is a CPU tensor.
``uint16``/``uint32`` keys ride the engine as order-preserving signed keys
of the same width (torch has no comparisons or gathers for those dtypes on
the CPU) and come back bit-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec, sortspec
from repro_torch.core.sortspec import index_rows
from repro_torch.engine import merge as merge  # noqa: F401  (re-export)
from repro_torch.engine import planner, runs
from repro_torch.engine.merge import merge_pairs, merge_runs  # noqa: F401
from repro_torch.engine.merge import kway_merge, kway_merge_kv  # noqa: F401
from repro_torch.engine.planner import (  # noqa: F401
    DistPlan, Plan, calibrate, choose, choose_cached, choose_distributed,
    choose_distributed_cached, clear_plan_cache, reset_calibration)
from repro_torch.engine.samplesort import sample_sort  # noqa: F401
from repro_torch.engine.segmented import (  # noqa: F401
    group_tokens_by_expert, segment_ids_from_row_splits, segmented_argsort,
    segmented_sort, sort_padded_rows)
from repro_torch.kernels import _build
from repro_torch.kernels.ops import _from_rows, _to_rows
from repro_torch.obs import trace as _obs


def _obs_finish(sp, op: str, plan: planner.Plan, n: int, batch: int,
                k: Optional[int] = None) -> None:
    """Pair a fenced span with its plan: a ``cost_observation`` event and
    the ``planner.cost_model_error`` ratio.  No-op when tracing is off or
    the span has no device time (CPU tensors)."""
    if sp.device_ms is None:
        return
    predicted = plan.costs.get(plan.method)
    if not predicted or predicted != predicted or predicted == float("inf"):
        return
    measured_ns = sp.device_ms * 1e6
    error = measured_ns / predicted
    _obs.record_event("cost_observation", op=op, n=n, batch=batch, k=k,
                      method=plan.method, predicted_ns=predicted,
                      measured_ns=measured_ns, error=error)
    from repro_torch.obs import metrics as _metrics
    _metrics.histogram("planner.cost_model_error").observe(error)
    # closed-loop re-probing, opt-in (REPRO_TORCH_AUTOTUNE=1): see
    # tuning.refresh_if_stale
    from repro_torch.core import tuning as _tuning
    _tuning.maybe_refresh()


_capturing = _build.capturing


def _spill_fallback(plan: planner.Plan) -> planner.Plan:
    """The spill tier is host-driven (blocking waits, data-dependent
    cursors) and cannot be captured in a CUDA graph: while one is being
    captured a spill plan degrades to the merge pipeline on the device,
    the best plan a capture can hold, at the caller's memory risk."""
    if plan.method == "spill" and _capturing():
        return dataclasses.replace(plan, method="merge")
    return plan


def _rows_planned(x, axis: int, device, method: str, run_len, k=None):
    """Plan ``x``'s rows, then move them: (x, its rows form (signed keys),
    lead dims, axis, plan).  A spill plan leaves the rows where they are."""
    dev = sortspec.resolve_device(device)
    x = torch.as_tensor(x)
    x2, lead, ax = _to_rows(x, axis)
    batch, n = x2.shape
    plan = _spill_fallback(planner.choose_cached(
        n, batch, x.dtype, requested=method, run_len=run_len, k=k,
        device=dev))
    if plan.method != "spill":
        x, x2 = x.to(dev), x2.to(dev)
    return x, keycodec.to_signed(x2), lead, ax, plan


def _backend_call(plan: planner.Plan, fn: str, *args, descending: bool,
                  device):
    """``fn`` of the plan's backend; the spill backend also takes the
    device its chunks sort on."""
    be = sortspec.get_backend(plan.method)
    extra = {"device": device} if plan.method == "spill" else {}
    return getattr(be, fn)(*args, descending=descending, plan=plan, **extra)


# ---------------------------------------------------------------------------
# merge pipeline over rows form — what the "merge" backend executes
# ---------------------------------------------------------------------------

def merge_sort_rows(x2: torch.Tensor, *, descending: bool,
                    plan: planner.Plan) -> torch.Tensor:
    """(rows, n) -> sorted rows via run generation + the merge tree, on
    the tensor's own device."""
    rg = runs.generate_runs(x2, plan.run_len, method=plan.run_method,
                            descending=descending)
    merged = merge_runs(rg, descending=descending,
                        backend=plan.merge_backend)
    return merged[:, :x2.shape[-1]]


def merge_sort_rows_kv(k2: torch.Tensor, v2: torch.Tensor, *,
                       descending: bool, plan: planner.Plan,
                       stable: bool = False, index_payload: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value merge pipeline.  ``stable=True`` sorts the runs with the
    plan's stable run method (``torch`` on the CPU, the radix kernels on
    the card), so the whole pipeline is stable (the merges are).

    ``index_payload=True`` says ``v2`` holds each key's position: the
    runs' pads (payload n) then sort behind every genuine key, also one
    equal to the pad key, under the network runs' (key, payload)
    comparator.  Any other payload rides as an index payload and is
    gathered at the end: the kernels carry int32 payloads only, and an
    arbitrary int32 payload could tie or pass the pads' n and be cut off.
    It is the same result as the stable runs': an index payload is what
    every stable path orders by."""
    run_method = plan.stable_run_method if stable else plan.run_method
    if v2.dtype != torch.int32 or not (
            index_payload or run_method in ("torch", "radix")):
        sk, order = merge_sort_rows_kv(k2, index_rows(k2),
                                       descending=descending, plan=plan,
                                       stable=stable, index_payload=True)
        return sk, v2.gather(-1, order.to(torch.int64))
    rk, rv = runs.generate_runs_kv(k2, v2, plan.run_len, method=run_method,
                                   descending=descending)
    mk, mv = merge_runs(rk, rv, descending=descending,
                        backend=plan.merge_backend)
    n = k2.shape[-1]
    return mk[:, :n], mv[:, :n]


# ---------------------------------------------------------------------------
# public entry points (any array size, planner-dispatched)
# ---------------------------------------------------------------------------

def sort(x, *, axis: int = -1, descending: bool = False,
         method: str = "auto", run_len: Optional[int] = None,
         device="cuda") -> torch.Tensor:
    """Sort along ``axis``; sizes beyond one run go through runs + merges.
    ``method`` is "auto", "merge" or any registered backend name."""
    x, x2, lead, ax, plan = _rows_planned(x, axis, device, method, run_len)
    batch, n = x2.shape
    with _obs.trace("engine.sort", n=n, batch=batch, method=plan.method) as sp:
        if plan.method == "merge":
            out = merge_sort_rows(x2, descending=descending, plan=plan)
        else:
            out = _backend_call(plan, "sort", x2, descending=descending,
                                device=device)
        sp.fence(out)
    _obs_finish(sp, "sort", plan, n, batch)
    return _from_rows(keycodec.from_signed(out, x.dtype), lead, ax)


def sort_kv(keys, values, *, axis: int = -1, descending: bool = False,
            method: str = "auto", stable: bool = False,
            run_len: Optional[int] = None, device="cuda"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``keys`` along ``axis`` carrying ``values`` with them;
    ``stable=True`` forces a stable pipeline."""
    keys, k2, lead, ax, plan = _rows_planned(keys, axis, device, method,
                                             run_len)
    values = torch.as_tensor(values)
    if plan.method != "spill":
        values = values.to(k2.device)
    v2 = keycodec.to_signed(_to_rows(values, axis)[0])
    batch, n = k2.shape
    with _obs.trace("engine.sort_kv", n=n, batch=batch,
                    method=plan.method) as sp:
        sk = sv = None
        if plan.method != "merge":
            be = sortspec.get_backend(plan.method)
            if not stable or be.capabilities.stable:
                sk, sv = _backend_call(plan, "sort_kv", k2, v2,
                                       descending=descending, device=device)
        if sk is None:
            sk, sv = merge_sort_rows_kv(k2, v2, descending=descending,
                                        plan=plan, stable=stable)
        sp.fence((sk, sv))
    _obs_finish(sp, "sort_kv", plan, n, batch)
    return (_from_rows(keycodec.from_signed(sk, keys.dtype), lead, ax),
            _from_rows(keycodec.from_signed(sv, values.dtype), lead, ax))


def argsort(x, *, axis: int = -1, descending: bool = False,
            method: str = "auto", stable: bool = False,
            run_len: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Sorting permutation along ``axis`` (int32); ties keep ascending
    index order in both directions on every backend."""
    x, x2, lead, ax, plan = _rows_planned(x, axis, device, method, run_len)
    batch, n = x2.shape
    with _obs.trace("engine.argsort", n=n, batch=batch,
                    method=plan.method) as sp:
        order = None
        if plan.method != "merge":
            be = sortspec.get_backend(plan.method)
            if not stable or be.capabilities.stable:
                order = _backend_call(plan, "argsort", x2,
                                      descending=descending, device=device)
        if order is None:
            _, order = merge_sort_rows_kv(x2, index_rows(x2),
                                          descending=descending, plan=plan,
                                          stable=stable, index_payload=True)
        sp.fence(order)
    _obs_finish(sp, "argsort", plan, n, batch)
    return _from_rows(order, lead, ax)


def topk(x, k: int, *, method: str = "auto", run_len: Optional[int] = None,
         device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis -> (values, int32 indices), descending;
    the lower index first among equal keys.  Engine path: per-run top-k
    candidates (only a run's first k can reach the top k), then a
    key-value merge tree over the k-prefixes."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(
            f"topk k must satisfy 1 <= k <= n (n={n}); got k={k}")
    x, x2, lead, _, plan = _rows_planned(x, -1, device, method, run_len, k=k)
    batch = x2.shape[0]
    with _obs.trace("engine.topk", n=n, batch=batch, k=k,
                    method=plan.method) as sp:
        if plan.method != "merge":
            v, i = sortspec.get_backend(plan.method).topk(x2, k, plan=plan)
        else:
            rk, rv = runs.generate_runs_kv(x2, index_rows(x2), plan.run_len,
                                           method=plan.run_method,
                                           descending=True)
            kk = runs.next_pow2(min(k, rk.shape[-1]))
            mk, mv = merge_runs(rk[..., :kk], rv[..., :kk], descending=True,
                                backend=plan.merge_backend)
            v, i = mk[:, :k], mv[:, :k]
        sp.fence((v, i))
    _obs_finish(sp, "topk", plan, n, batch, k)
    v = keycodec.from_signed(v.contiguous(), x.dtype)
    return v.reshape(*lead, k), i.reshape(*lead, k)
