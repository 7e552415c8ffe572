"""The cost analysis of one step: its aten op graph, seen as it runs.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``,
which parses the post-SPMD HLO of a compiled step.  PyTorch runs eagerly
and has no HLO, so this module is a ``TorchDispatchMode`` (``OpTrace``)
that sees every aten op of the step as it is dispatched.  The dry run
runs the step under ``FakeTensorMode`` inside it, so nothing is allocated.
``analyze`` reports, with the reference's keys:

  * flops        -- ``torch.utils.flop_counter``'s count (2*M*N*K a
                    product; attention and convolution products likewise),
                    the remat recompute included, elementwise ops not;
  * hbm_bytes    -- operands + result bytes of every aten op that makes
                    a tensor (views, ``empty`` and ``detach`` move none): the
                    reference's "non-fused op sites" model with each eager
                    op a site; pessimistic for a kernel that fuses, but
                    consistent;
  * collective_* -- the collectives of one rank's program on a device
                    mesh, by kind (``all-gather``, ``reduce-scatter``,
                    ``all-reduce``, ``all-to-all``, ``broadcast``): counts
                    and bytes with the reference's wire convention (an
                    all-reduce counts 2x its tensor, the others 1x their
                    result); empty on one card;
  * n_ops        -- the aten ops dispatched.

On DTensors (a sharded step on a device mesh) the trace sees rank 0's
local program: an op on DTensors is handed back to DTensor
(``NotImplemented``, as ``torch.distributed.tensor.debug.CommDebugMode``
does), which runs it as local ops and the collectives of its
redistributions, each of which the trace then sees on local tensors.  So
bytes, flops (``OpTrace.flops``: ``torch.utils.flop_counter``'s formulas
on the local ops), memory and collectives are one device's.  DTensor also
runs each new op once on fake tensors of the global shape to learn its
output's shape (``ShardingPropagator``'s tensor-meta propagation); the
trace mutes itself for that, which computes nothing on any device.

The same pass keeps the bytes of the storages alive after each op
(``OpTrace.timeline``, by forward, backward and update phase) and their
most (``OpTrace.peak``): the dry run's memory.  ``top_tensors`` lists the
largest results.
"""
from __future__ import annotations

import heapq
import weakref
from typing import Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_TOP_MIN_BYTES = 8 << 20          # the reference's triage threshold
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "detach",
                         "lift_fresh", "alias", "_local_scalar_dense"})


# the collectives of torch's functional c10d ops, by the reference's kinds
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_reduce": "all-reduce", "all_reduce_coalesced":
               "all-reduce", "all_to_all_single": "all-to-all",
               "broadcast": "broadcast"}
_COMM_NAMESPACES = frozenset({"_c10d_functional", "c10d_functional",
                              "_c10d_functional_autograd"})


def _local(t):
    """A DTensor's local tensor; any tensor itself."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> List[torch.Tensor]:
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def phase(outer: str = None) -> str:
    """The part of a step an op runs in: ``backward`` inside an autograd
    node (a remat recompute too), ``forward`` while autograd records,
    ``update`` else (the optimizer and the parameter refresh run under
    ``no_grad``).  DTensor runs an op's local ops below autograd: there
    ``outer``, the phase of the DTensor op, decides."""
    if torch._C._current_autograd_node() is not None:
        return "backward"
    if torch.is_grad_enabled():
        return "forward"
    return outer or "update"


class _GradModeSpy(TorchFunctionMode):
    """Records, at each torch call, whether autograd records (the phase of
    the ops DTensor then runs below autograd, where grad mode reads off)."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.trace._outer = ("forward" if torch.is_grad_enabled()
                             else "update")
        return func(*args, **(kwargs or {}))


class OpTrace(TorchDispatchMode):
    """Counts every aten op dispatched inside it: the bytes it reads and
    writes, and the bytes of the storages alive (``current``; its most,
    ``peak``; (op, bytes) after each op that makes a tensor, by ``phase``,
    in ``timeline``).  Tensors made
    before the trace count once ``hold`` is given them.  A storage counts
    from the op that makes it until its last tensor dies."""

    def __init__(self, top: int = 20, local: bool = False):
        """``local``: the traced step runs on DTensors (a mesh): count
        flops op by op (``flops``) and take the phase from a torch-function
        spy; one card's trace needs neither."""
        super().__init__()
        self.local = local
        self.hbm_bytes = 0.0
        self.flops = 0.0
        self.collective_counts: Dict[str, int] = {}
        self.collective_bytes: Dict[str, int] = {}
        self.n_ops = 0
        self.current = 0
        self.peak = 0
        self.timeline: Dict[str, List[Tuple[str, int]]] = {}
        self._live: Dict[int, weakref.ref] = {}
        self._muted = 0
        self._saved = {}
        self._outer = None            # the phase of the last torch call
        self._top: List[Tuple[int, int, str, str]] = []
        self._n_top = top

    def __enter__(self):
        self._spy = None
        if self.local:
            self._mute_propagation()
            self._spy = _GradModeSpy(self)
            self._spy.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._spy is not None:
                self._spy.__exit__(*exc)
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            for name, fn in self._saved.items():
                setattr(ShardingPropagator, name, fn)
            self._saved = {}

    def _mute_propagation(self):
        """Wrap DTensor's tensor-meta propagation so that the ops it runs
        at global shapes are not counted."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            fn = ShardingPropagator.__dict__.get(name)
            if fn is None or name in self._saved:
                continue
            self._saved[name] = fn

            def muted(*a, _fn=fn, **k):
                self._muted += 1
                try:
                    return _fn(*a, **k)
                finally:
                    self._muted -= 1

            setattr(ShardingPropagator, name, muted)

    def hold(self, *trees) -> int:
        """Count the storages of ``trees`` as alive; returns the bytes of
        those new to the trace."""
        return sum(self._add(t) for t in _tensors(trees))

    def _add(self, t: torch.Tensor) -> int:
        if t.device.type == "meta":
            return 0               # a layout, no memory
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        nbytes = st.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self.current -= nbytes

        self._live[key] = weakref.ref(st, freed)
        self.current += nbytes
        self.peak = max(self.peak, self.current)
        return nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it as local ops
        out = func(*args, **(kwargs or {}))
        if self._muted:
            return out                 # DTensor's shape propagation
        self.n_ops += 1
        name = func.overloadpacket.__name__
        if func.namespace in _COMM_NAMESPACES:
            kind = COLLECTIVES.get(name)
            if kind is not None:
                src = _tensors((args, kwargs)) if kind == "all-reduce" \
                    else _tensors(out)
                b = sum(_nbytes(t) for t in src) * (
                    2 if kind == "all-reduce" else 1)
                self.collective_counts[kind] = \
                    self.collective_counts.get(kind, 0) + 1
                self.collective_bytes[kind] = \
                    self.collective_bytes.get(kind, 0) + b
            for t in _tensors(out):
                self._add(t)
            return out                 # link traffic, not HBM bytes
        if self.local:
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **(kwargs or {}), out_val=out)
        results = _tensors(out)
        if not results:        # a query (``prim.device``, sizes): no data
            return out
        for t in results:
            self._add(t)
        self.timeline.setdefault(phase(self._outer), []).append(
            (name, self.current))
        if not (func.is_view or name in _NO_TRAFFIC):
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            moved += sum(_nbytes(t) for t in results)
            self.hbm_bytes += moved
            for t in results:
                b = _nbytes(t)
                if b > _TOP_MIN_BYTES:
                    row = (b, self.n_ops, name,
                           f"{str(t.dtype).replace('torch.', '')}"
                           f"{list(t.shape)}")
                    if len(self._top) < self._n_top:
                        heapq.heappush(self._top, row)
                    else:
                        heapq.heappushpop(self._top, row)
        return out


def analyze(flops: float, hbm_bytes: float, n_ops: float,
            collective_counts=None, collective_bytes=None) -> dict:
    """The reference's analysis keys of a step: ``flops`` (the flop
    counter's total), ``hbm_bytes`` and ``n_ops`` (an ``OpTrace``'s, or
    the dry run's extrapolation of them) and the collectives by kind
    (none on one device)."""
    counts = {k: int(round(v)) for k, v in (collective_counts or {}).items()}
    nbytes = {k: float(v) for k, v in (collective_bytes or {}).items()}
    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm_bytes),
        "collective_counts": counts,
        "collective_bytes": nbytes,
        "collective_total_bytes": float(sum(nbytes.values())),
        "n_ops": int(round(n_ops)),
    }


def top_tensors(trace: OpTrace, n: int = 20):
    """The largest results of the traced step (memory triage): rows of
    (bytes, op index, aten op, dtype[shape]), largest first."""
    return sorted(trace._top, reverse=True)[:n]
