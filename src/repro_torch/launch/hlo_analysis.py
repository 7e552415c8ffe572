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
  * collective_* -- empty: one device runs no collective (ROADMAP item
                    12c brings the mesh);
  * n_ops        -- the aten ops dispatched.

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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_TOP_MIN_BYTES = 8 << 20          # the reference's triage threshold
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "detach",
                         "lift_fresh", "alias", "_local_scalar_dense"})


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def phase() -> str:
    """The part of a step an op runs in: ``backward`` inside an autograd
    node (a remat recompute too), ``forward`` while autograd records,
    ``update`` else (the optimizer and the parameter refresh run under
    ``no_grad``)."""
    if torch._C._current_autograd_node() is not None:
        return "backward"
    return "forward" if torch.is_grad_enabled() else "update"


class OpTrace(TorchDispatchMode):
    """Counts every aten op dispatched inside it: the bytes it reads and
    writes, and the bytes of the storages alive (``current``; its most,
    ``peak``; (op, bytes) after each op that makes a tensor, by ``phase``,
    in ``timeline``).  Tensors made
    before the trace count once ``hold`` is given them.  A storage counts
    from the op that makes it until its last tensor dies."""

    def __init__(self, top: int = 20):
        super().__init__()
        self.hbm_bytes = 0.0
        self.n_ops = 0
        self.current = 0
        self.peak = 0
        self.timeline: Dict[str, List[Tuple[str, int]]] = {}
        self._live: Dict[int, weakref.ref] = {}
        self._top: List[Tuple[int, int, str, str]] = []
        self._n_top = top

    def hold(self, *trees) -> int:
        """Count the storages of ``trees`` as alive; returns the bytes of
        those new to the trace."""
        return sum(self._add(t) for t in _tensors(trees))

    def _add(self, t: torch.Tensor) -> int:
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
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        name = func.overloadpacket.__name__
        results = _tensors(out)
        if not results:        # a query (``prim.device``, sizes): no data
            return out
        for t in results:
            self._add(t)
        self.timeline.setdefault(phase(), []).append((name, self.current))
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


def analyze(flops: float, hbm_bytes: float, n_ops: float) -> dict:
    """The reference's analysis keys of a step: ``flops`` (the flop
    counter's total), ``hbm_bytes`` and ``n_ops`` (an ``OpTrace``'s, or
    the dry run's extrapolation of them) and the collectives (none on one
    device)."""
    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm_bytes),
        "collective_counts": {},
        "collective_bytes": {},
        "collective_total_bytes": 0.0,
        "n_ops": int(round(n_ops)),
    }


def top_tensors(trace: OpTrace, n: int = 20):
    """The largest results of the traced step (memory triage): rows of
    (bytes, op index, aten op, dtype[shape]), largest first."""
    return sorted(trace._top, reverse=True)[:n]
