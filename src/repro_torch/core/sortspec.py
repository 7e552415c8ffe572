"""Unified sort problem description + pluggable backend registry.

The port's front-door contract, as in the JAX package: every sort is one
frozen :class:`SortSpec`, and every engine that can run one is a
:class:`SortBackend` declaring what it can do in a :class:`Capabilities`
record.  The planner derives eligibility from those records alone.

A spec with a ``mesh`` (a :class:`~repro_torch.core.mesh.Mesh`) is a
mesh-global sort of a flat tensor, run by the ``distributed`` backend.
A backend of the JAX package without a port would stand in
``NOT_PORTED`` and fail here, loudly, with its ROADMAP item; every one is
ported now.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, FrozenSet, Optional, Tuple

import torch

from repro_torch.core import keycodec

__all__ = [
    "Capabilities", "SortSpec", "SortBackend", "register_backend",
    "unregister_backend", "get_backend", "registered_backends",
    "backend_names", "registry_generation", "sort_defaults", "default",
    "resolve_device",
]

# JAX backends without a port yet -> where the ROADMAP schedules them
NOT_PORTED: Dict[str, str] = {}


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device) -> torch.device:
    """The device a public entry point runs on.  ``"cuda"`` without a card
    raises: the port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    return dev


# ---------------------------------------------------------------------------
# capabilities
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend declares it can do; the planner trusts this record.

    ``dtypes`` is the set of dtype names the backend sorts correctly
    (``None``: any comparable dtype).  ``max_n`` caps the power-of-two
    padded row the planner may hand it under ``method="auto"``.
    ``substrate`` says where it runs: ``"host"`` (PyTorch ops),
    ``"cuda"`` (hand-written kernels), ``"hierarchy"`` (the engine),
    ``"sram"`` (the paper's gate program on the simulated IMC array, K7
    on a card) or ``"mesh"`` (the distributed tier).

    ``selection=True`` declares an O(n·passes) top-k selection engine: its
    top-k is priced with ``cost_model.selection_cost_ns``, not as a full
    sort.  ``supports_sort=False`` marks a selection-only engine: the spec
    layer refuses it plain sorts and the planner never hands it one.
    """
    dtypes: Optional[FrozenSet[str]] = None
    stable: bool = False
    max_n: Optional[int] = None
    supports_kv: bool = True
    supports_topk: bool = True
    supports_segments: bool = True
    supports_sort: bool = True
    selection: bool = False
    auto_dispatch: bool = True
    substrate: str = "host"   # "host" | "cuda" | "hierarchy" | "sram" | "mesh"


# ---------------------------------------------------------------------------
# backend protocol + registry
# ---------------------------------------------------------------------------

class SortBackend:
    """Base class every sorting engine plugs in through.  Methods take
    *rows form*: a 2-D ``(rows, n)`` tensor sorted along the last axis, on
    the device the caller chose; results stay on that device."""

    name: str = "?"
    capabilities: Capabilities = Capabilities()

    def eligible(self, n: int, dtype, run_len: Optional[int] = None) -> bool:
        caps = self.capabilities
        if caps.dtypes is not None \
                and keycodec.dtype_name(dtype) not in caps.dtypes:
            return False
        if caps.max_n is not None and next_pow2(n) > caps.max_n:
            return False
        return True

    def topk_eligible(self, n: int, k: int, dtype,
                      run_len: Optional[int] = None) -> bool:
        """May ``auto`` hand a top-k of (n, k, dtype) to this backend?  By
        default what :meth:`eligible` says of a sort of n."""
        return self.eligible(n, dtype, run_len)

    def cost_ns(self, n: int, batch: int, dtype, *, run_len: int,
                consts=None, plain: bool = False) -> float:
        """Estimated ns for (batch, n): the analytic model, +inf for a
        backend it does not know."""
        from repro_torch.core import cost_model
        kb = keycodec.key_bits(dtype) if keycodec.supports(dtype) else 32
        try:
            return cost_model.device_sort_cost_ns(
                self.name, n, batch, run_len=run_len, consts=consts,
                plain=plain, key_bits=kb)
        except ValueError:
            return float("inf")

    def topk_cost_ns(self, n: int, k: int, batch: int, dtype, *,
                     run_len: int, consts=None, plain: bool = False) -> float:
        """A selection engine's top-k is priced by the O(n·passes)
        selection model; a sort backend's is sort-prefix: its full sort
        cost."""
        if self.capabilities.selection:
            from repro_torch.core import cost_model
            kb = keycodec.key_bits(dtype) if keycodec.supports(dtype) else 32
            return cost_model.selection_cost_ns(n, k, kb, batch,
                                                consts=consts)
        return self.cost_ns(n, batch, dtype, run_len=run_len, consts=consts,
                            plain=plain)

    def sort(self, rows: torch.Tensor, *, descending: bool = False,
             plan=None) -> torch.Tensor:
        raise NotImplementedError(f"{self.name} backend implements no sort")

    def sort_kv(self, keys: torch.Tensor, values: torch.Tensor, *,
                descending: bool = False, plan=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError(
            f"{self.name} backend has no key-value path "
            f"(capabilities.supports_kv={self.capabilities.supports_kv})")

    def argsort(self, rows: torch.Tensor, *, descending: bool = False,
                plan=None) -> torch.Tensor:
        _, order = self.sort_kv(rows, index_rows(rows),
                                descending=descending, plan=plan)
        return order

    def topk(self, rows: torch.Tensor, k: int, *, plan=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        sk, sv = self.sort_kv(rows, index_rows(rows), descending=True,
                              plan=plan)
        return sk[..., :k], sv[..., :k]

    def check_dtype(self, dtype) -> None:
        caps = self.capabilities
        name = keycodec.dtype_name(dtype)
        if caps.dtypes is not None and name not in caps.dtypes:
            raise ValueError(
                f"{self.name} method supports {tuple(sorted(caps.dtypes))}, "
                f"got {name!r}")


def index_rows(rows: torch.Tensor) -> torch.Tensor:
    """int32 positions 0..n-1 in every row (the argsort payload)."""
    n = rows.shape[-1]
    return torch.arange(n, dtype=torch.int32, device=rows.device) \
        .expand(rows.shape).contiguous()


_REGISTRY: Dict[str, SortBackend] = {}
_GENERATION: int = 0


def register_backend(cls):
    """Class decorator: instantiate ``cls`` and register it under
    ``cls.name``; re-registering a name replaces the backend and
    invalidates cached plans."""
    global _GENERATION
    backend = cls() if isinstance(cls, type) else cls
    if not backend.name or backend.name in ("?", "auto"):
        raise ValueError(f"backend needs a usable name, got {backend.name!r}")
    _REGISTRY[backend.name] = backend
    _GENERATION += 1
    return cls


def unregister_backend(name: str) -> None:
    global _GENERATION
    _REGISTRY.pop(name, None)
    _GENERATION += 1


_builtins_loaded = False


def _bootstrap() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        _builtins_loaded = True
        from repro_torch.core import backends  # noqa: F401  (registers)


def registered_backends() -> Dict[str, SortBackend]:
    _bootstrap()
    return dict(_REGISTRY)


def backend_names() -> Tuple[str, ...]:
    _bootstrap()
    return tuple(_REGISTRY)


def get_backend(name: str) -> SortBackend:
    _bootstrap()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"method must be one of {backend_names() + ('auto',)}, "
            f"got {name!r}") from None


def registry_generation() -> int:
    """Bumped on every (un)registration — plan caches key on this."""
    return _GENERATION


# ---------------------------------------------------------------------------
# ambient defaults
# ---------------------------------------------------------------------------

_DEFAULT_KEYS = ("method", "run_len")
_DEFAULTS: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "repro_torch_sort_defaults", default={"method": "auto"})


@contextlib.contextmanager
def sort_defaults(**overrides):
    """Ambient configuration for specs that leave fields unset, scoped to
    the current thread/context::

        with sort_defaults(method="merge", run_len=4096):
            repro_torch.sort.sort(x)
    """
    unknown = set(overrides) - set(_DEFAULT_KEYS)
    if unknown:
        raise ValueError(
            f"sort_defaults accepts {_DEFAULT_KEYS}, got {sorted(unknown)}")
    token = _DEFAULTS.set({**_DEFAULTS.get(), **overrides})
    try:
        yield
    finally:
        _DEFAULTS.reset(token)


def default(key: str):
    """Current ambient default for ``key`` (None if unset)."""
    return _DEFAULTS.get().get(key)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SortSpec:
    """The full sort problem in one value (the JAX package's fields; the
    Pallas ``interpret`` knob has no counterpart — the device is chosen by
    the caller of ``repro_torch.sort.run``).

    ``segment_ids``/``row_splits`` sort within ragged groups of a row;
    ``valid_lengths`` sorts each row's valid prefix of a padded batch and
    writes ``fill_value`` over the tail.  ``mesh``/``axis_name`` sort a
    flat tensor globally over a mesh axis (one name, a tuple, or None for
    the whole mesh): plain, key-value, the permutation (``indices``; the
    port's mesh sort is stable, so ``stable`` is accepted) and top-k."""
    axis: int = -1
    descending: bool = False
    stable: bool = False
    k: Optional[int] = None
    values: Optional[torch.Tensor] = None
    indices: bool = False
    segment_ids: Optional[torch.Tensor] = None
    row_splits: Optional[torch.Tensor] = None
    valid_lengths: Optional[torch.Tensor] = None
    fill_value: Any = 0
    mesh: Any = None
    axis_name: Optional[str] = None
    method: Optional[str] = None
    run_len: Optional[int] = None

    def canonical(self, x: torch.Tensor) -> "SortSpec":
        """Resolve ambient defaults, normalise the axis and validate the
        whole problem against ``x``; every front-door error is raised
        here."""
        ndim = x.dim()
        if ndim == 0:
            raise ValueError("cannot sort a 0-d array")
        if not -ndim <= self.axis < ndim:
            raise ValueError(
                f"axis {self.axis} out of range for {ndim}-d input")
        axis = self.axis % ndim
        method = self.method if self.method is not None else default("method")
        if method in NOT_PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet: {NOT_PORTED[method]}")
        names = backend_names() + ("auto",)
        if method not in names:
            raise ValueError(
                f"method must be one of {names}, got {method!r}")
        axis_name = self.axis_name
        if axis_name is not None and self.mesh is None:
            raise ValueError("axis_name requires a mesh")
        if self.mesh is not None:
            from repro_torch.core.mesh import Mesh
            from repro_torch.engine.samplesort import _axes_tuple
            if not isinstance(self.mesh, Mesh):
                raise TypeError(
                    f"mesh must be a repro_torch.core.mesh.Mesh, got "
                    f"{type(self.mesh).__name__}")
            axis_name = _axes_tuple(self.mesh, axis_name)
            if ndim != 1:
                raise ValueError(
                    "mesh-distributed specs sort flat 1-D arrays; "
                    f"got a {ndim}-d input")
            if (self.segment_ids is not None or self.row_splits is not None
                    or self.valid_lengths is not None):
                raise ValueError(
                    "mesh-distributed specs support plain, key-value and "
                    "permutation sorts plus top-k selection (no segments/"
                    "valid_lengths)")
            if method not in ("auto", "distributed"):
                raise ValueError(
                    f"mesh-distributed specs run the 'distributed' "
                    f"backend; method must be 'auto' or 'distributed', "
                    f"got {method!r}")
            method = "distributed"
        k = self.k
        n = x.shape[axis]
        if k is not None:
            k = int(k)
            if not 1 <= k <= n:
                raise ValueError(
                    f"topk k must satisfy 1 <= k <= n (n={n}); got k={k}")
        if self.segment_ids is not None and self.row_splits is not None:
            raise ValueError("pass segment_ids or row_splits, not both")
        ragged = self.segment_ids is not None or self.row_splits is not None
        if self.valid_lengths is not None and ragged:
            raise ValueError(
                "valid_lengths (padded rows) and segment_ids/row_splits "
                "(ragged) are mutually exclusive")
        if k is not None and (ragged or self.valid_lengths is not None):
            raise ValueError("top-k over segmented/padded specs is not "
                             "supported; sort then slice per segment")
        if k is not None and (self.values is not None or self.indices
                              or self.stable):
            raise ValueError("top-k specs return (values, indices) on their "
                             "own; values/indices/stable do not combine "
                             "with k")
        if self.values is not None and self.indices:
            raise ValueError("indices=True builds its own index payload; "
                             "pass either values or indices, not both")
        if self.values is not None and self.values.shape != x.shape:
            raise ValueError(
                f"values shape {tuple(self.values.shape)} must match keys "
                f"shape {tuple(x.shape)}")
        if method != "auto":
            caps = get_backend(method).capabilities
            if k is not None and not caps.supports_topk:
                raise ValueError(
                    f"{method} backend does not support top-k "
                    f"(capabilities.supports_topk=False)")
            if k is None and not caps.supports_sort:
                raise ValueError(
                    f"{method} backend is selection-only "
                    f"(capabilities.supports_sort=False); it runs top-k "
                    f"specs (k=...), not full sorts")
            if self.values is not None and not caps.supports_kv:
                raise ValueError(
                    f"{method} backend does not support key-value payloads "
                    f"(capabilities.supports_kv=False)")
            if ragged and not caps.supports_segments:
                raise ValueError(
                    f"{method} backend does not support segmented sorts "
                    f"(capabilities.supports_segments=False)")
        run_len = self.run_len if self.run_len is not None \
            else default("run_len")
        # top-k is inherently a descending selection (largest k)
        descending = True if k is not None else self.descending
        return dataclasses.replace(self, axis=axis, method=method, k=k,
                                   descending=descending, run_len=run_len,
                                   axis_name=axis_name)

    def static_key(self, shape, dtype) -> tuple:
        """Hashable reduction of the spec to its statics and the operand's
        (shape, dtype): array fields count by presence; a mesh by its axis
        layout and device list (``Mesh.key``), so two same-shaped meshes
        over other devices differ."""
        mesh_key = None if self.mesh is None else self.mesh.key()
        return (self.axis, self.descending, self.stable, self.k,
                self.values is not None, self.indices,
                self.segment_ids is not None, self.row_splits is not None,
                self.valid_lengths is not None, self.fill_value, self.method,
                mesh_key, self.axis_name, self.run_len, tuple(shape),
                keycodec.dtype_name(dtype))
