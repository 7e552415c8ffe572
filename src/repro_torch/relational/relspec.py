"""RelSpec — the one front-door contract for every relational op.

The port of the JAX package's ``relational/relspec.py``: a relational
problem (dedup, group-by, join, run-length/delta encoding, histogram and
quantile sketches, group ranks) is one frozen :class:`RelSpec`, and
``canonical()`` is the one place every front-door error is raised, with
the JAX package's messages.  Every op is a sort (or a radix selection)
plus an O(n) post-pass; ``method`` names the sorting backend the op rides
(the port's names: ``torch`` where the JAX package says ``xla``, ``cuda``
where it says ``pallas``), and ``"auto"`` resolves through
``planner.choose_relational``.

Static-shape contract, as in the JAX package: results whose true size
depends on the data (unique values, groups, join pairs, runs) come back as
fixed-size padded tensors plus a valid count.

``mesh``/``axis_name`` run an op over a device mesh
(``core.mesh.Mesh``): the op's sort backbone is the mesh-global sample
sort and the post-pass runs on the mesh's first entry's device.  The JAX
package composes unique and group_by over a mesh; the port also runs
join there, whose backbone is a stable permutation, which the port's mesh
sort gives (the reference's is not stable).  The Pallas ``interpret``
knob has no counterpart (the caller picks the device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import NOT_PORTED, backend_names

__all__ = ["RelSpec", "OPS", "AGGS", "SORT_OPS", "STABLE_OPS", "SKETCH_OPS",
           "MESH_OPS"]

# every relational op the subsystem executes
OPS = ("unique", "group_by", "join", "rle", "delta", "histogram",
       "quantile", "group_ranks")

# ops whose backbone is a full sort (planner-priced backend choice);
# the sketches ride the radix-select / searchsorted machinery and take no
# backend override
SORT_OPS = frozenset({"unique", "group_by", "join", "rle", "delta"})
SKETCH_OPS = frozenset({"histogram", "quantile"})

# ops that need a stable order pipeline (join's duplicate-pair order,
# group-by's summation order, arrival ranks): the planner prices
# non-stable backends at the stable merge fallback the engine runs
STABLE_OPS = frozenset({"group_by", "join", "group_ranks"})

# group-by reductions (mean is the float32 sum over the count)
AGGS = ("sum", "min", "max", "count", "mean")

# ops that compose over a device mesh (the JAX package: unique, group_by;
# the port adds join, see the module docstring)
MESH_OPS = frozenset({"unique", "group_by", "join"})


def is_integer(dtype) -> bool:
    """``jnp.issubdtype(dtype, jnp.integer)`` for a torch dtype."""
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


@dataclasses.dataclass(frozen=True, eq=False)
class RelSpec:
    """One relational problem.  Field groups:

      op                      which relational op
      agg                     group_by reductions (name or tuple of names)
      return_inverse/counts   unique extras (np.unique-style)
      size                    join output capacity (default n_l * n_r)
      fill_value              what pads invalid tail slots (op-specific
                              default when None, see each op)
      assume_sorted           rle/delta: the input is sorted already
      num_bins / lo / hi      histogram shape
      qs                      quantile fractions in [0, 1]
      num_groups              group_ranks key domain (0 <= key < num_groups)
      mesh / axis_name        run over a ``core.mesh.Mesh`` (unique,
                              group_by, join; see the module docstring)
      method                  sorting backend (None -> "auto")
    """
    op: str = "unique"
    agg: Union[str, Tuple[str, ...]] = ("sum",)
    return_inverse: bool = False
    return_counts: bool = False
    size: Optional[int] = None
    fill_value: Any = None
    assume_sorted: bool = False
    num_bins: Optional[int] = None
    lo: Any = None
    hi: Any = None
    qs: Optional[Tuple[float, ...]] = None
    num_groups: Optional[int] = None
    mesh: Any = None
    axis_name: Optional[str] = None
    method: Optional[str] = None

    # -- validation + canonicalization (the one place it happens) -----------
    def canonical(self, x: torch.Tensor,
                  values: Optional[torch.Tensor] = None) -> "RelSpec":
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        op = self.op

        # ---- shape: every column op is 1-D; group_ranks allows batch dims
        if op == "group_ranks":
            if x.dim() < 1:
                raise ValueError("group_ranks expects (..., n) keys")
            if self.num_groups is None or int(self.num_groups) < 1:
                raise ValueError(
                    f"group_ranks needs num_groups >= 1, "
                    f"got {self.num_groups}")
            if not is_integer(x.dtype):
                raise ValueError(
                    f"group_ranks keys must be integers, "
                    f"got {keycodec.dtype_name(x.dtype)}")
        elif x.dim() != 1:
            raise ValueError(
                f"relational op {op!r} works on flat 1-D columns; "
                f"got a {x.dim()}-d input")

        # ---- method: a registered sorting backend or auto; sketches ride
        # the selection / searchsorted machinery and take no override
        method = self.method if self.method is not None else "auto"
        if op in SKETCH_OPS:
            if method != "auto":
                raise ValueError(
                    f"{op} rides the radix-select backend; method must be "
                    f"'auto', got {method!r}")
        else:
            if method in NOT_PORTED:
                raise NotImplementedError(
                    f"method={method!r} is not ported yet: "
                    f"{NOT_PORTED[method]}")
            names = backend_names() + ("auto",)
            if method not in names:
                raise ValueError(
                    f"method must be one of {names}, got {method!r}")

        # ---- mesh: only the ops where local op == global op compose
        axis_name = self.axis_name
        if axis_name is not None and self.mesh is None:
            raise ValueError("axis_name requires a mesh")
        if self.mesh is not None:
            if op not in MESH_OPS:
                raise ValueError(
                    f"distributed relational variants exist for "
                    f"{tuple(sorted(MESH_OPS))}; op {op!r} has none")
            from repro_torch.core.mesh import Mesh
            from repro_torch.engine.samplesort import _axes_tuple
            if not isinstance(self.mesh, Mesh):
                raise TypeError(
                    f"mesh must be a repro_torch.core.mesh.Mesh, got "
                    f"{type(self.mesh).__name__}")
            axis_name = _axes_tuple(self.mesh, axis_name)
            if method not in ("auto", "distributed"):
                raise ValueError(
                    "mesh-distributed relational ops run the 'distributed' "
                    f"sort; method must be 'auto' or 'distributed', "
                    f"got {method!r}")
            if not keycodec.supports(x.dtype):
                raise ValueError(
                    f"distributed {op} needs a keycodec dtype "
                    f"({keycodec.SUPPORTED}), got "
                    f"{keycodec.dtype_name(x.dtype)}")

        # ---- per-op field combos
        if (self.return_inverse or self.return_counts) and op != "unique":
            raise ValueError(
                "return_inverse/return_counts are unique-only fields")
        if self.size is not None:
            if op != "join":
                raise ValueError("size is a join-only field (static output "
                                 "capacity for the expanded pairs)")
            if int(self.size) < 1:
                raise ValueError(f"join size must be >= 1, got {self.size}")
        if self.assume_sorted and op not in ("rle", "delta"):
            raise ValueError("assume_sorted applies to the sorted-column "
                             "encoders (rle/delta) only")
        if op == "delta" and not is_integer(x.dtype):
            raise ValueError(
                f"delta encoding round-trips exactly for integer columns "
                f"only (modular cumsum); got {keycodec.dtype_name(x.dtype)}")
        if op == "group_by":
            agg = (self.agg,) if isinstance(self.agg, str) else \
                tuple(self.agg)
            if not agg:
                raise ValueError("group_by needs at least one aggregate")
            bad = [a for a in agg if a not in AGGS]
            if bad:
                raise ValueError(
                    f"unknown aggregates {bad}; supported: {AGGS}")
            if values is None:
                raise ValueError("group_by needs a values column")
            if values.shape != x.shape:
                raise ValueError(
                    f"group_by values shape {tuple(values.shape)} must "
                    f"match keys shape {tuple(x.shape)}")
        else:
            agg = self.agg if isinstance(self.agg, tuple) else (self.agg,)
        if op == "join":
            if values is None:
                raise ValueError("join needs a right key column")
            if values.dim() != 1:
                raise ValueError(
                    f"join keys are flat 1-D columns; right side is "
                    f"{values.dim()}-d")
            if values.dtype != x.dtype:
                raise ValueError(
                    f"join key dtypes must match: left "
                    f"{keycodec.dtype_name(x.dtype)}, right "
                    f"{keycodec.dtype_name(values.dtype)}")
        if op == "histogram":
            if self.num_bins is None or int(self.num_bins) < 1:
                raise ValueError(
                    f"histogram needs num_bins >= 1, got {self.num_bins}")
        elif self.num_bins is not None:
            raise ValueError("num_bins is a histogram-only field")
        qs = self.qs
        if op == "quantile":
            if qs is None:
                raise ValueError("quantile needs qs (fractions in [0, 1])")
            qs = (qs,) if isinstance(qs, float) else tuple(float(q)
                                                           for q in qs)
            if not qs or any(not 0.0 <= q <= 1.0 for q in qs):
                raise ValueError(
                    f"quantile fractions must lie in [0, 1], got {qs}")
            if not keycodec.supports(x.dtype):
                raise ValueError(
                    f"quantile sketches ride the radix-select backend and "
                    f"need a keycodec dtype ({keycodec.SUPPORTED}), "
                    f"got {keycodec.dtype_name(x.dtype)}")
            if x.shape[0] == 0:
                raise ValueError("quantiles of an empty column are "
                                 "undefined")
        elif qs is not None:
            raise ValueError("qs is a quantile-only field")

        return dataclasses.replace(
            self, op=op, agg=agg, method=method, axis_name=axis_name, qs=qs,
            size=None if self.size is None else int(self.size),
            num_bins=None if self.num_bins is None else int(self.num_bins),
            num_groups=None if self.num_groups is None
            else int(self.num_groups))

    def static_key(self, shape, dtype) -> tuple:
        """Hashable reduction to the statics an external cache may key on
        (mirrors the JAX package's ``RelSpec.static_key``)."""
        mesh_key = None if self.mesh is None else self.mesh.key()
        return (self.op, self.agg, self.return_inverse, self.return_counts,
                self.size, self.fill_value, self.assume_sorted,
                self.num_bins, self.lo, self.hi, self.qs, self.num_groups,
                mesh_key, self.axis_name, self.method, tuple(shape),
                keycodec.dtype_name(dtype))
