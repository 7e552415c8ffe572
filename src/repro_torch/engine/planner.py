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

A sort whose keys exceed the profile's ``spill_threshold_bytes`` is routed
to the spill tier by feasibility, not price.

``choose_relational`` picks the sort backbone of a relational op
(``repro_torch.relational``) the same way, with the relational cost
entries.  Resolved plans are cached per (n, batch, dtype, requested,
run_len, k, device type) and invalidated on profile or registry changes.

``calibrate`` measures the profile's constants and knobs on the running
device (probes of every registered backend, sweeps of the discrete knobs)
and installs it; ``reset_calibration`` goes back to the seeds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import BACKEND_NAMES
from repro_torch.core import cost_model, keycodec, sortspec
from repro_torch.core import tuning as _tuning
from repro_torch.core.backends import (  # noqa: F401
    MAX_BITONIC_N, MAX_CUDA_N)

# the backends the port registers itself: calibrate lets none of them fail
BUILT_IN_BACKENDS = frozenset(BACKEND_NAMES.values()) | {
    "select", "distributed", "spill"}


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


def constants() -> cost_model.DeviceSortConstants:
    """The cost constants every plan is priced with: the active tuning
    profile's (the seeds until ``calibrate()`` measures real ones or a
    persisted profile matches the device fingerprint)."""
    return _tuning.active().constants


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
    goes to the spill tier: the device backends' working set (input, runs,
    merge ping-pong) does not fit there, so it is the only honest plan,
    and below the threshold it is never a candidate.  Top-k stays on the
    device paths.
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
    oversized = (k is None
                 and n * batch * itemsize > prof.spill_threshold_bytes
                 and sortspec.get_backend("spill").eligible(n, dtype, rl))
    if k is None and (oversized or requested == "spill"):
        costs["spill"] = cost_model.spill_sort_cost_ns(
            n, batch, itemsize, consts=consts, plain=plain)
    if requested == "auto" and oversized:
        method = "spill"
    elif requested == "auto":

        def _valid(name: str) -> bool:
            be = candidates[name]
            caps = be.capabilities
            if not (be.eligible(n, dtype, rl) if k is None
                    else be.topk_eligible(n, k, dtype, rl)):
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


def choose_method(n: int, batch: int = 1, dtype=torch.float32, *,
                  device="cuda") -> str:
    """Just the backend name: what the public "auto" resolves to."""
    return choose(n, batch, dtype, device=device).method


_PLAN_CACHE: Dict[tuple, Plan] = {}


# ---------------------------------------------------------------------------
# relational dispatch: which sorting backend carries each relational op
# ---------------------------------------------------------------------------

def choose_relational(op: str, n: int, batch: int = 1, dtype=torch.float32,
                      *, requested: str = "auto", device="cuda") -> Plan:
    """Resolve the sort backbone of a sort-backed relational op
    (``repro_torch.relational``).

    Prices every auto-dispatchable sort backend with
    ``cost_model.relational_cost_ns``.  The order-sensitive ops
    (``STABLE_OPS``: join's pair order, group-by's summation order, group
    ranks) run the engine's stable pipeline, and a non-stable backend is
    replaced there by the stable merge fallback (its runs on K3 on a card,
    ``stable_run_method="radix"``), so such a candidate is priced at the
    ``merge`` cost, what picking it really runs."""
    from repro_torch.relational.relspec import SORT_OPS, STABLE_OPS
    if op not in SORT_OPS:
        raise ValueError(
            f"choose_relational plans the sort-backed ops "
            f"{tuple(sorted(SORT_OPS))}, got {op!r}")
    prof = _tuning.active()
    rl = prof.run_len
    cuda = on_cuda(device)
    if cuda:
        rl = min(sortspec.next_pow2(rl), MAX_CUDA_N)
    kb = keycodec.key_bits(dtype) if keycodec.supports(dtype) else 32
    candidates = {name: be for name, be in _auto_candidates().items()
                  if be.capabilities.supports_sort}
    costs: Dict[str, float] = {}
    for name, be in candidates.items():
        effective = name
        if op in STABLE_OPS and not be.capabilities.stable \
                and name != "merge":
            effective = "merge"
        try:
            costs[name] = cost_model.relational_cost_ns(
                op, effective, n, batch, run_len=rl, key_bits=kb,
                consts=prof.constants, plain=not cuda)
        except ValueError:
            costs[name] = float("inf")   # unknown backend: never auto-picked
    if requested == "auto":
        valid = [m for m in costs
                 if candidates[m].eligible(n, dtype, rl)
                 and costs[m] != float("inf")]
        method = min(valid, key=costs.__getitem__)
    else:
        method = requested
    plan = Plan(method=method, run_len=rl,
                run_method="cuda" if cuda else "torch",
                merge_backend="cuda" if cuda else "torch", costs=costs,
                stable_run_method="radix" if cuda else "torch")
    from repro_torch.obs import trace as _obs
    if _obs.enabled():
        _obs.record_event(
            "relational_plan_decision", op=op, n=n, batch=batch,
            dtype=keycodec.dtype_name(dtype), requested=requested,
            method=plan.method, predicted_ns=plan.costs.get(plan.method),
            costs=dict(plan.costs), device=torch.device(device).type)
        from repro_torch.obs import metrics as _m
        _m.counter("planner.relational_decisions").inc()
    return plan


def choose_relational_cached(op: str, n: int, batch: int = 1,
                             dtype=torch.float32, *,
                             requested: str = "auto", device="cuda") -> Plan:
    """``choose_relational`` memoized in the shared plan cache, with the
    same invalidation (tuning and registry generations, device type)."""
    key = ("rel", op, n, batch, keycodec.dtype_name(dtype), requested,
           torch.device(device).type, _tuning.generation(),
           sortspec.registry_generation())
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = choose_relational(op, n, batch, dtype, requested=requested,
                                 device=device)
        _PLAN_CACHE[key] = plan
    else:
        from repro_torch.obs import trace as _obs
        if _obs.enabled():
            from repro_torch.obs import metrics as _m
            _m.counter("planner.plan_cache_hits").inc()
    return plan


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


# ---------------------------------------------------------------------------
# distributed dispatch: sample sort vs odd-even vs the two-level sort
# ---------------------------------------------------------------------------

DIST_STRATEGIES = ("sample", "oddeven")


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Dispatch decision for a mesh sort of n keys over n_dev entries."""
    strategy: str                # "sample" | "oddeven" | "hier"
    n_dev: int
    costs: Dict[str, float]      # estimated ns per strategy


def choose_distributed(n: int, n_dev: int, dtype=torch.float32, *,
                       topology=None) -> DistPlan:
    """Price the distributed strategies and return the cheapest.

    Odd-even pays D exchange launches and a bitonic merge box a round;
    the sample sort two capacity-padded all-to-alls and one merge tree.
    With a two-tier ``topology`` (``core.topology.Topology``) the
    two-level sample sort joins, priced per tier
    (``cost_model.hierarchical_sort_cost_ns``), while the flat strategies
    pay the traffic-weighted blend of the two tiers' rates
    (``cost_model.flat_collective_rates``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    consts = _tuning.active().constants
    hier = topology is not None and topology.is_hierarchical \
        and len(topology.axes) >= 2
    if not hier:
        costs = {
            s: cost_model.distributed_sort_cost_ns(s, n, n_dev, itemsize,
                                                   consts=consts)
            for s in DIST_STRATEGIES
        }
        return DistPlan(strategy=min(costs, key=costs.__getitem__),
                        n_dev=n_dev, costs=costs)
    if topology.n_devices != n_dev:
        raise ValueError(
            f"topology spans {topology.n_devices} devices, the sort "
            f"plans for {n_dev}")
    outer = topology.axes[0]
    innermost = topology.axes[-1]
    inner_size = n_dev // outer.size
    ia, ib = innermost.latency_ns, innermost.per_byte_ns
    da, db = outer.latency_ns, outer.per_byte_ns
    fa, fb = cost_model.flat_collective_rates(
        inner_size, outer.size, ici_alpha=ia, ici_per_byte=ib,
        dcn_alpha=da, dcn_per_byte=db)
    costs = {
        s: cost_model.distributed_sort_cost_ns(s, n, n_dev, itemsize,
                                               consts=consts,
                                               alpha=fa, per_byte=fb)
        for s in DIST_STRATEGIES
    }
    costs["hier"] = cost_model.hierarchical_sort_cost_ns(
        n, inner_size, outer.size, itemsize, consts=consts,
        ici_alpha=ia, ici_per_byte=ib, dcn_alpha=da, dcn_per_byte=db)
    return DistPlan(strategy=min(costs, key=costs.__getitem__),
                    n_dev=n_dev, costs=costs)


def choose_distributed_cached(n: int, n_dev: int, dtype=torch.float32, *,
                              topology=None, mesh=None) -> DistPlan:
    """``choose_distributed`` memoized beside the single-device plans,
    keyed also on the topology generation, every axis's tier and rates
    and the mesh's layout (``core.mesh.mesh_key``: a one-process mesh's
    devices, a ``DeviceMesh``'s ranks): a calibration, a swapped topology
    or another mesh re-plans."""
    from repro_torch.core import mesh as _mesh
    from repro_torch.core import topology as _topo
    tsig = None if topology is None else tuple(
        (a.name, a.size, a.tier, a.bandwidth_bytes_per_s, a.latency_ns)
        for a in topology.axes)
    mkey = None if mesh is None else _mesh.mesh_key(mesh)
    key = ("dist", n, n_dev, keycodec.dtype_name(dtype), tsig, mkey,
           _topo.generation(), _tuning.generation(),
           sortspec.registry_generation())
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = choose_distributed(n, n_dev, dtype, topology=topology)
        _PLAN_CACHE[key] = plan
    return plan


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# calibration: probe every registered backend, sweep the knobs, fit the
# constants, install (and persist) the profile
# ---------------------------------------------------------------------------

# knobs calibrate leaves at their seeds, and why
NOT_SWEPT = {
    "radix_tile": "K3 runs fixed 4096-key tiles and K4 a grid sized to the "
                  "card: the knob tunes only the plain versions",
    "capacity_slack": "sample-sort bucket slack of the distributed tier: "
                      "one device has no exchange to size",
}


def _time_ns(fn: Callable, reps: int = 3, device="cpu") -> float:
    """ns a call of ``fn`` after one warm-up call: on a card the stream's
    time over ``reps`` queued calls (CUDA events, so asynchronous launches
    are timed where they run), else the host clock."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e9


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _probe_registered(x: torch.Tensor, sel_k: int, reps: int,
                      include_kernels: bool) -> Dict[str, float]:
    """One warm sort (and top-k, where supported) timing per registered
    auto-dispatchable backend at the calibration shape -> {probe: ns},
    the audit table a profile carries (``probe_ns``).  Without
    ``include_kernels`` the kernel backends (``cuda``, ``radix``) are not
    timed: their plain versions say nothing of the kernels.  A third-party
    backend that fails is left out of the table; a built-in one's failure
    (a kernel that does not build or launch) raises, naming it."""
    n = x.shape[-1]
    skip = () if include_kernels else ("cuda", "radix")
    table: Dict[str, float] = {}
    for name, be in sortspec.registered_backends().items():
        caps = be.capabilities
        if not caps.auto_dispatch or name in skip:
            continue
        try:
            if caps.supports_sort:
                table[f"{name}.sort.n{n}"] = _time_ns(
                    lambda b=be: b.sort(x), reps, x.device)
            if caps.supports_topk and sel_k <= n:
                table[f"{name}.topk.n{n}.k{sel_k}"] = _time_ns(
                    lambda b=be: b.topk(x, sel_k), reps, x.device)
        except Exception as e:  # a broken third-party backend must not
            if name in BUILT_IN_BACKENDS:   # sink the whole calibration
                raise RuntimeError(f"calibrate: the built-in {name!r} "
                                   f"backend failed its probe") from e
    return table


def _sweep_digit_bits(x: torch.Tensor, reps: int
                      ) -> Tuple[int, Dict[str, float]]:
    """K3 at each digit width it takes in {4, 8}: fewer passes against a
    wider histogram; the fastest wins."""
    from repro_torch.kernels import radix_sort as _rs
    enc = keycodec.encode(x)
    table = {f"digit_bits={d}": _time_ns(
        lambda d=d: _rs.sort_blocks(enc, digit_bits=d), reps, x.device)
        for d in (4, 8)}
    return min((4, 8), key=lambda d: table[f"digit_bits={d}"]), table


def _sweep_merge_fanin(tile_n: int, reps: int, device
                       ) -> Tuple[int, Dict[str, float]]:
    """The spill tier's grouped merge tournament (K2 on a card) over 16
    runs of ``tile_n`` keys at each width in {2, 4, 8, 16}: a wide
    tournament merges in one round but pads every run to the widest,
    narrow rounds launch more merges and move the data log_f(R) times."""
    from repro_torch.engine.spill import _grouped_kway_kv
    gen = _generator(device, 3)
    runs = [torch.sort(torch.randn(tile_n, generator=gen, device=device)
                       ).values for _ in range(16)]
    vals = [torch.arange(tile_n, dtype=torch.int32, device=device)
            for _ in range(16)]
    backend = "cuda" if on_cuda(device) else "torch"
    grid = (2, 4, 8, 16)
    table = {f"merge_fanin={f}": _time_ns(
        lambda f=f: _grouped_kway_kv(list(runs), list(vals), f,
                                     descending=False, backend=backend),
        reps, device) for f in grid}
    return min(grid, key=lambda f: table[f"merge_fanin={f}"]), table


def _sweep_run_len(tile_n: int, batch: int, reps: int, device
                   ) -> Tuple[Optional[int], Dict[str, float]]:
    """The merge pipeline (run generation + merge tree, the device's run
    and merge methods) over a run-length grid at an 8-tile probe size:
    longer runs trade cheap run sorts for fewer merge levels."""
    from repro_torch.engine import merge as _merge
    from repro_torch.engine import runs as _runs
    n_probe = 8 * tile_n
    cuda = on_cuda(device)
    v = torch.randn((max(1, batch // 8), n_probe),
                    generator=_generator(device, 1), device=device)
    cap = MAX_CUDA_N if cuda else n_probe // 2
    grid = sorted({rl for rl in (tile_n // 2, tile_n, 2 * tile_n,
                                 4 * tile_n)
                   if 256 <= rl <= min(n_probe // 2, cap)})
    if not grid:
        return None, {}
    method = "cuda" if cuda else "torch"
    table = {f"run_len={rl}": _time_ns(
        lambda rl=rl: _merge.merge_runs(
            _runs.generate_runs(v, rl, method=method), backend=method),
        reps, device) for rl in grid}
    return min(grid, key=lambda r: table[f"run_len={r}"]), table


def _fit_select_min_n(consts: _tuning.DeviceSortConstants,
                      digit_bits: int, cuda: bool) -> int:
    """The smallest power-of-two n at which the measured selection price
    beats the cheapest other top-k (k=64, float32): the ``torch`` sort,
    and off the card its native top-k, on the card K5's one pass."""
    k = 64
    for exp in range(7, 21):
        n = 1 << exp
        sel = cost_model.selection_cost_ns(n, k, 32, consts=consts,
                                           digit_bits=digit_bits)
        alt = cost_model.device_sort_cost_ns("torch", n, consts=consts,
                                             plain=not cuda)
        other = (cost_model.cuda_topk_cost_ns(n, k, consts=consts) if cuda
                 else cost_model.native_topk_cost_ns(n, k, consts=consts))
        if sel < min(alt, other):
            return n
    return _tuning.DEFAULT_SELECT_MIN_N


def calibrate(tile_n: int = 2048, batch: int = 64, reps: int = 3, *,
              include_kernels: Optional[bool] = None,
              sweep_params: bool = True, persist: bool = False,
              path=None, device="cuda") -> _tuning.TuningProfile:
    """Measure this machine's profile and install it (the JAX package's
    ``calibrate``, under the port's names).

      1. probe — one warm timing per registered auto-dispatchable backend
         (sort and top-k) on a ``(batch, tile_n)`` float32 probe drawn
         from a seeded ``torch.Generator``: the profile's ``probe_ns``.
      2. sweep (``sweep_params``) — ``digit_bits`` in {4, 8} (K3, kernels
         only), the engine ``run_len`` grid and the spill tier's
         ``merge_fanin`` in {2, 4, 8, 16}, each sweep's timings kept in
         ``sweeps``; ``select_min_n`` fitted from the measured constants.
         ``radix_tile`` and ``capacity_slack`` keep their seeds
         (:data:`NOT_SWEPT` says why).
      3. fit — the leading constants (torch, on the card torch_card too,
         bitonic, cuda, merge, radix, select, the torch backend's top-k)
         from the probes; the link and
         host-merge constants keep their seeds.
      4. install — ``tuning.set_active`` (every cached plan dies);
         ``persist=True`` writes it (``path``, else this fingerprint's
         file in the profile cache), for the next process to resolve.

    ``device`` is the one measured, and must be this machine's: the card
    where there is one (CUDA events time it), else the CPU — the profile
    is keyed by the machine's fingerprint.  ``include_kernels`` (default:
    on the card) times the kernel backends; off the card their plain
    versions would say nothing of the kernels, and they keep the seeds."""
    dev = sortspec.resolve_device(device)
    cuda = on_cuda(dev)
    if cuda != torch.cuda.is_available():
        raise ValueError(
            f"calibrate measures the device this machine's fingerprint "
            f"names (the card where there is one, else the CPU); got "
            f"device={device!r}")
    if include_kernels is None:
        include_kernels = cuda
    from repro_torch.engine import merge as _merge
    from repro_torch.engine import runs as _runs
    be = sortspec.get_backend
    x = torch.randn((batch, tile_n), generator=_generator(dev, 0),
                    device=dev)
    elems = batch * tile_n
    lg = cost_model._log2(tile_n)
    method = "cuda" if cuda else "torch"

    torch_ns = _time_ns(lambda: be("torch").sort(x), reps, dev)
    bit_ns = _time_ns(lambda: be("bitonic").sort(x), reps, dev)
    run_ns = _time_ns(lambda: _runs.generate_runs(x, tile_n, method=method),
                      reps, dev)
    half = tile_n // 2
    a = torch.sort(x[:, :half]).values
    b = torch.sort(x[:, half:]).values
    mrg_ns = _time_ns(lambda: _merge.merge_pairs(a, b, backend=method),
                      reps, dev)

    # the sweeps run before the fit, so the radix/select constants are
    # normalised by the pass count the tuned digit width implies
    defaults = _tuning.default_profile()
    digit_bits, run_len = defaults.digit_bits, defaults.run_len
    merge_fanin = defaults.merge_fanin
    sweeps: Dict[str, Dict[str, float]] = {}
    if sweep_params:
        if include_kernels:
            digit_bits, sweeps["digit_bits"] = _sweep_digit_bits(x, reps)
        rl, tbl = _sweep_run_len(tile_n, batch, reps, dev)
        if rl is not None:
            run_len, sweeps["run_len"] = rl, tbl
        merge_fanin, sweeps["merge_fanin"] = _sweep_merge_fanin(
            tile_n, reps, dev)

    sel_k = min(64, tile_n)
    sel_ns = _time_ns(lambda: be("select").topk(x, sel_k), reps, dev)
    sel_passes = -(-keycodec.key_bits(x.dtype) // digit_bits)
    # strip the modelled O(k log k) ordering term at the measured torch
    # constant (selection_cost_ns adds it back); at least 10% of the
    # measurement stays, so a noisy probe never makes selection free
    sel_kterm = (torch_ns / (elems * lg)) * batch \
        * sel_k * cost_model._log2(sel_k)
    sel_c = max(sel_ns - sel_kterm, 0.1 * sel_ns) / (elems * sel_passes)
    # the torch backend's top-k: its off-card price (on the card it is
    # priced at sort-prefix, and the probe is only recorded)
    ttk_ns = _time_ns(lambda: be("torch").topk(x, sel_k), reps, dev)
    ttk_c = max(ttk_ns - sel_kterm, 0.1 * ttk_ns) / elems

    dc = defaults.constants
    cuda_c, rad_c = dc.cuda, dc.radix
    if include_kernels:
        from repro_torch.kernels import radix_sort as _rs
        cuda_ns = _time_ns(lambda: be("cuda").sort(x), reps, dev)
        cuda_c = cuda_ns / (elems * lg * lg)
        enc = keycodec.encode(x)
        rad_ns = _time_ns(lambda: _rs.sort_blocks(enc, digit_bits=digit_bits),
                          reps, dev)
        rad_c = rad_ns / (elems * sel_passes)
        if not cuda:    # the plain versions: fold into constant x penalty
            cuda_c /= dc.cuda_plain_penalty
            rad_c /= dc.cuda_plain_penalty
    # on the card torch.sort is a radix sort: its own constant a key and
    # 8-bit pass (the CPU's keeps the n log2 n form)
    torch_card = torch_ns / (elems * -(-keycodec.key_bits(x.dtype) // 8)) \
        if cuda else dc.torch_card
    consts = dataclasses.replace(
        dc, torch=torch_ns / (elems * lg), torch_card=torch_card,
        bitonic=bit_ns / (elems * lg * lg),
        cuda=cuda_c, radix=rad_c, select=sel_c, torch_topk=ttk_c,
        merge_run=run_ns / (elems * lg), merge_level=mrg_ns / elems)
    select_min_n = _fit_select_min_n(consts, digit_bits, cuda) \
        if sweep_params else defaults.select_min_n

    probe_ns = _probe_registered(x, sel_k, reps, include_kernels)
    probe_ns["torch.merge_pairs"] = mrg_ns
    profile = dataclasses.replace(
        defaults, constants=consts, digit_bits=digit_bits, run_len=run_len,
        select_min_n=select_min_n, merge_fanin=merge_fanin,
        source="calibrated", probe_ns=probe_ns, sweeps=sweeps or None)
    if persist:
        _tuning.save(profile, path)
    _tuning.set_active(profile)
    clear_plan_cache()
    return profile


def reset_calibration() -> None:
    """Back to the built-in seeds and re-plan: the inverse of
    ``calibrate``, ignoring any persisted profile."""
    _tuning.set_active(_tuning.default_profile())
    clear_plan_cache()
