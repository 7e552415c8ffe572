"""Cost-model dispatch — picks the sorting backend from (n, batch, dtype).

Prices every auto-dispatchable registered backend with its
``SortBackend.cost_ns`` (the analytic model of ``core/cost_model.py`` by
default) and returns the cheapest eligible one as an executable
:class:`Plan`.  Eligibility is a pure capability query against the
registry.  On a CUDA device the engine sorts runs with the bitonic kernel
(the radix kernels when the sort must be stable) and merges with the
merge-path kernel, and the run length is capped at what the bitonic
kernel holds in shared memory; on the CPU it runs ``torch.sort`` runs and
the plain rank merge, as the JAX package does off the TPU.

Resolved plans are cached per (n, batch, dtype, requested, run_len, k,
device type) and invalidated on profile or registry changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import keycodec, sortspec
from repro_torch.core import tuning as _tuning
from repro_torch.core.sortspec import NOT_PORTED
from repro_torch.kernels.bitonic_sort import MAX_N as MAX_CUDA_N


@dataclasses.dataclass(frozen=True)
class Plan:
    """Executable dispatch decision for one (n, batch, dtype) workload."""
    method: str                  # any auto-dispatchable registered backend
    run_len: int                 # engine run length (merge method only)
    run_method: str              # "torch" | "cuda": what sorts each run
    merge_backend: str           # "torch" | "cuda": the merge primitive
    costs: Dict[str, float]      # estimated ns per candidate
    stable_run_method: str = "torch"  # "torch" | "radix": runs of a stable sort


def on_cuda(device) -> bool:
    """Does work on ``device`` run the CUDA kernels?"""
    return torch.device(device).type == "cuda"


def _auto_candidates() -> Dict[str, sortspec.SortBackend]:
    return {name: be for name, be in sortspec.registered_backends().items()
            if be.capabilities.auto_dispatch}


def choose(n: int, batch: int = 1, dtype=torch.float32, *,
           requested: str = "auto", run_len: Optional[int] = None,
           k: Optional[int] = None, device="cuda") -> Plan:
    """Resolve ``requested`` ("auto" or a concrete method) into a Plan.

    With ``k`` set the workload is a top-k and candidates are priced with
    ``SortBackend.topk_cost_ns``: the selection model for a selection
    backend (``select``), sort-prefix for every sort backend.  ``auto``
    skips selection backends below the profile's ``select_min_n``, where
    the counting passes never beat a small sort.
    An ``auto`` sort above the profile's ``spill_threshold_bytes`` of keys
    belongs to the spill tier, which is not ported: it raises rather than
    run a plan that does not fit.
    """
    prof = _tuning.active()
    rl = run_len or prof.run_len
    cuda = on_cuda(device)
    if cuda:
        # a run is one row of the bitonic kernel: no longer than it holds
        rl = min(sortspec.next_pow2(rl), MAX_CUDA_N)
    consts = prof.constants
    plain = not cuda
    candidates = _auto_candidates()
    costs = {
        name: (be.topk_cost_ns(n, k, batch, dtype, run_len=rl,
                               consts=consts, plain=plain)
               if k is not None
               else be.cost_ns(n, batch, dtype, run_len=rl, consts=consts,
                               plain=plain))
        for name, be in candidates.items()
    }
    itemsize = torch.empty((), dtype=dtype).element_size()
    if requested == "auto":
        if k is None and n * batch * itemsize > prof.spill_threshold_bytes:
            raise NotImplementedError(
                f"{n * batch * itemsize} bytes of keys exceed the spill "
                f"threshold ({prof.spill_threshold_bytes}); the spill tier "
                f"is not ported yet: {NOT_PORTED['spill']}")

        def _valid(name: str) -> bool:
            caps = candidates[name].capabilities
            if not candidates[name].eligible(n, dtype, rl):
                return False
            if k is not None and caps.selection and n < prof.select_min_n:
                return False
            return caps.supports_topk if k is not None \
                else caps.supports_sort
        method = min((m for m in costs if _valid(m)),
                     key=costs.__getitem__)
    else:
        method = requested
    # on the card every run and merge is a kernel: K1 runs (K3 when the
    # sort must be stable, K1 is not) and K2 merges; a top-k plan of the
    # select or cuda backend runs K4 or K5 and orders its candidates with
    # K1 (K1 runs and K2 merges past K1's cap)
    plan = Plan(method=method, run_len=rl,
                run_method="cuda" if cuda else "torch",
                merge_backend="cuda" if cuda else "torch", costs=costs,
                stable_run_method="radix" if cuda else "torch")
    _record_decision(plan, n=n, batch=batch, dtype=dtype,
                     requested=requested, k=k, device=device)
    return plan


def _record_decision(plan: Plan, *, n: int, batch: int, dtype,
                     requested: str, k: Optional[int], device) -> None:
    """One structured event per resolved plan (cache misses only)."""
    from repro_torch.obs import trace as _obs
    if not _obs.enabled():
        return
    _obs.record_event(
        "plan_decision", n=n, batch=batch, dtype=keycodec.dtype_name(dtype),
        requested=requested, k=k, method=plan.method,
        predicted_ns=plan.costs.get(plan.method), costs=dict(plan.costs),
        run_len=plan.run_len, device=torch.device(device).type)
    from repro_torch.obs import metrics as _m
    _m.counter("planner.decisions").inc()


_PLAN_CACHE: Dict[tuple, Plan] = {}


def choose_cached(n: int, batch: int = 1, dtype=torch.float32, *,
                  requested: str = "auto", run_len: Optional[int] = None,
                  k: Optional[int] = None, device="cuda") -> Plan:
    """``choose`` memoized; keyed on the tuning and registry generations
    and the device type, so a profile swap or a new backend re-plans."""
    key = (n, batch, keycodec.dtype_name(dtype), requested, run_len, k,
           torch.device(device).type, _tuning.generation(),
           sortspec.registry_generation())
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = choose(n, batch, dtype, requested=requested, run_len=run_len,
                      k=k, device=device)
        _PLAN_CACHE[key] = plan
    else:
        from repro_torch.obs import trace as _obs
        if _obs.enabled():
            from repro_torch.obs import metrics as _m
            _m.counter("planner.plan_cache_hits").inc()
    return plan


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
