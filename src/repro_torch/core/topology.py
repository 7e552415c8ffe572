"""Interconnect topology: the tiered link structure under a device mesh.

The port of the JAX package's ``core/topology.py``.  A :class:`Topology`
is a frozen, schema-versioned record of one mesh's axes, each with the
link tier its exchanges cross, a bandwidth and a launch latency, keyed by
the device fingerprint and the mesh signature and JSON-persistable like a
``TuningProfile``.  The tiers are the card's:

  ``nvlink``   between the cards of one node (the reference's ICI)
  ``network``  between nodes (the reference's DCN)
  ``local``    entries that share one device: an exchange is a copy
               inside that device's memory.  Only :func:`calibrate`
               records it, when it finds every entry of an axis on one
               device, so a rate measured inside one card's memory never
               stands as an NVLink rate.

* ``from_mesh`` / ``for_mesh`` derive the default topology of a mesh
  or resolve the active / persisted one matching its signature.  On a
  one-process ``Mesh`` the outermost axis of a multi-axis mesh is
  ``network`` and the rest ``nvlink``.  On a ``DeviceMesh`` (one program
  a rank) an axis's tier is where its ranks are, from one gather of
  every rank's host name and device: ``local`` where the ranks of each
  of its groups share one device (gloo ranks on one card or on the CPU),
  ``nvlink`` on distinct cards of one host, ``network`` across hosts.
* ``calibrate`` times a two-size all-to-all over each axis and fits
  (latency, bandwidth) per axis; on a ``DeviceMesh`` the exchange is the
  axis group's ``all_to_all_single`` and every rank keeps the slowest
  rank's times, so all ranks plan alike.
* The active topology and its generation counter feed the planner's
  distributed plan-cache keys, so swapping topologies re-plans.

The default rates come from the active tuning profile's ``links`` (seeded
from the H100's NVLink 4 and a 400 Gb/s network port, specifications,
not measurements).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import tuning as _tuning

__all__ = [
    "SCHEMA", "TIER_NVLINK", "TIER_NETWORK", "TIER_LOCAL", "TopologyAxis",
    "Topology", "TopologyError", "from_mesh", "for_mesh", "calibrate",
    "active", "set_active", "generation", "save", "load", "load_for_mesh",
    "persisted_path", "topology_path", "search_dirs", "cache_dir",
]

SCHEMA = "repro_torch.topology/v1"

TOPOLOGY_DIR_ENV = "REPRO_TORCH_TOPOLOGY_DIR"   # highest-priority dir

TIER_NVLINK = "nvlink"      # between the cards of a node (JAX: "ici")
TIER_NETWORK = "network"    # between nodes (JAX: "dcn")
TIER_LOCAL = "local"        # entries sharing one device: an on-device copy
_VALID_TIERS = (TIER_NVLINK, TIER_NETWORK, TIER_LOCAL)


class TopologyError(ValueError):
    """A topology that cannot be trusted: wrong schema version, malformed
    JSON, or axis values outside the validated ranges."""


@dataclasses.dataclass(frozen=True)
class TopologyAxis:
    """One mesh axis and the link tier its exchanges run over."""
    name: str
    size: int
    tier: str
    bandwidth_bytes_per_s: float
    latency_ns: float

    def __post_init__(self):
        if not self.name:
            raise TopologyError("axis name must be non-empty")
        if self.size < 1:
            raise TopologyError(f"axis {self.name!r} size must be >= 1, "
                                f"got {self.size}")
        if self.tier not in _VALID_TIERS:
            raise TopologyError(f"axis {self.name!r} tier must be one of "
                                f"{_VALID_TIERS}, got {self.tier!r}")
        if not self.bandwidth_bytes_per_s > 0:
            raise TopologyError(f"axis {self.name!r} bandwidth must be > 0, "
                                f"got {self.bandwidth_bytes_per_s}")
        if self.latency_ns < 0:
            raise TopologyError(f"axis {self.name!r} latency must be >= 0, "
                                f"got {self.latency_ns}")

    @property
    def per_byte_ns(self) -> float:
        """The cost-model form of the bandwidth: ns per byte moved."""
        return 1e9 / self.bandwidth_bytes_per_s


@dataclasses.dataclass(frozen=True)
class Topology:
    """The tiered link structure of one mesh.  ``axes`` are outermost
    first, in the mesh's axis order; ``source`` is ``"default"`` /
    ``"calibrated"`` / ``"persisted"`` / ``"converted"``; ``probe_ns``
    keeps the raw timings a calibration was fitted from."""
    fingerprint: str
    axes: Tuple[TopologyAxis, ...]
    source: str = "default"
    probe_ns: Optional[Dict[str, float]] = None
    schema: str = SCHEMA

    def __post_init__(self):
        if self.schema != SCHEMA:
            raise TopologyError(
                f"unknown topology schema {self.schema!r} "
                f"(expected {SCHEMA!r})")
        axes = tuple(a if isinstance(a, TopologyAxis) else TopologyAxis(**a)
                     for a in self.axes)
        object.__setattr__(self, "axes", axes)
        if not axes:
            raise TopologyError("topology must have at least one axis")
        names = [a.name for a in axes]
        if len(set(names)) != len(names):
            raise TopologyError(f"duplicate axis names: {names}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def is_hierarchical(self) -> bool:
        """True when >= 2 axes have more than one entry: a second
        splitter round across the outer tier is expressible."""
        return sum(1 for a in self.axes if a.size > 1) >= 2

    def axis(self, name: str) -> TopologyAxis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"no axis {name!r} in topology {self.axis_names}")

    def signature(self) -> Tuple[Tuple[str, int], ...]:
        """The (name, size) shape a mesh must match to use this topology."""
        return tuple((a.name, a.size) for a in self.axes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        if not isinstance(d, dict):
            raise TopologyError(f"topology document must be an object, "
                                f"got {type(d).__name__}")
        if d.get("schema") != SCHEMA:
            raise TopologyError(f"unknown topology schema "
                                f"{d.get('schema')!r} (expected {SCHEMA!r})")
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TopologyError(f"unknown topology fields {sorted(unknown)} "
                                f"(schema {SCHEMA})")
        if not isinstance(d.get("fingerprint"), str):
            raise TopologyError("topology is missing its device fingerprint")
        axes = d.get("axes")
        if not isinstance(axes, (list, tuple)):
            raise TopologyError("topology axes must be a list")
        afields = {f.name for f in dataclasses.fields(TopologyAxis)}
        built = []
        for a in axes:
            if not isinstance(a, dict):
                raise TopologyError("each topology axis must be an object")
            bad = set(a) - afields
            if bad:
                raise TopologyError(
                    f"unknown axis fields {sorted(bad)} (schema {SCHEMA})")
            try:
                built.append(TopologyAxis(**a))
            except TypeError as e:
                raise TopologyError(f"malformed topology axis: {e}") from e
        d = dict(d, axes=tuple(built))
        try:
            return cls(**d)
        except TypeError as e:
            raise TopologyError(f"malformed topology: {e}") from e


# ---------------------------------------------------------------------------
# mesh derivation
# ---------------------------------------------------------------------------

def _default_rates(tier: str) -> Tuple[float, float]:
    """(bandwidth B/s, latency ns) of a tier from the active profile's
    link constants (``local`` is priced as ``nvlink`` until measured)."""
    lk = _tuning.active().links
    if tier == TIER_NETWORK:
        return 1e9 / lk.network_per_byte, lk.network_alpha
    return 1e9 / lk.collective_per_byte, lk.collective_alpha


def _mesh_signature(mesh, axis_names=None) -> Tuple[Tuple[str, int], ...]:
    from repro_torch.core import mesh as _mesh
    all_names = _mesh.axis_names(mesh)
    names = tuple(axis_names) if axis_names is not None else all_names
    for nm in names:
        if nm not in all_names:
            raise TopologyError(f"axis {nm!r} not in mesh axes "
                                f"{all_names}")
    return tuple((nm, _mesh.axis_size(mesh, nm)) for nm in names)


_PLACES: Dict[tuple, list] = {}


def _rank_places(mesh) -> list:
    """(host name, device) of every global rank of a ``DeviceMesh``: one
    ``all_gather_object`` over the default group, made once a mesh
    layout."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.core import mesh as _mesh
    key = (_mesh.mesh_key(mesh), id(dist.group.WORLD))
    hit = _PLACES.get(key)
    if hit is None:
        dev = f"cuda:{torch.cuda.current_device()}" \
            if mesh.device_type == "cuda" else mesh.device_type
        hit = [None] * dist.get_world_size()
        dist.all_gather_object(hit, (socket.gethostname(), dev))
        _PLACES[key] = hit
    return hit


def _rank_tier(mesh, name: str) -> str:
    """The tier of axis ``name`` of a ``DeviceMesh`` from where the ranks
    of each of its groups are."""
    from repro_torch.core import mesh as _mesh
    places = _rank_places(mesh)
    groups = _mesh._rank_layout(mesh, (name,))
    if all(len({places[r] for r in g}) == 1 for g in groups):
        return TIER_LOCAL
    if all(len({places[r][0] for r in g}) == 1 for g in groups):
        return TIER_NVLINK
    return TIER_NETWORK


def from_mesh(mesh, axis_names: Optional[Sequence[str]] = None,
              *, fingerprint: Optional[str] = None) -> Topology:
    """The default topology of ``mesh``.  A one-process ``Mesh``: the
    outermost axis is the network tier when the mesh has several axes,
    every inner axis NVLink; a one-axis mesh is NVLink.  A ``DeviceMesh``:
    each axis's tier is where its ranks are (``local`` / ``nvlink`` /
    ``network``; a collective call of every rank).  ``axis_names``
    restricts / reorders to a subset of the mesh's axes (outer first)."""
    from repro_torch.core import mesh as _mesh
    sig = _mesh_signature(mesh, axis_names)
    ranks = _mesh.is_device_mesh(mesh)
    axes = []
    for i, (nm, size) in enumerate(sig):
        if ranks:
            tier = _rank_tier(mesh, nm)
        else:
            tier = TIER_NETWORK if (i == 0 and len(sig) > 1) \
                else TIER_NVLINK
        bw, lat = _default_rates(tier)
        axes.append(TopologyAxis(name=nm, size=size, tier=tier,
                                 bandwidth_bytes_per_s=bw, latency_ns=lat))
    return Topology(fingerprint=fingerprint or _tuning.device_fingerprint(),
                    axes=tuple(axes), source="default")


def for_mesh(mesh, axis_names: Optional[Sequence[str]] = None) -> Topology:
    """The topology to price ``mesh`` with: the active one when its
    signature matches, else a persisted file keyed by (fingerprint,
    signature), else the ``from_mesh`` default."""
    from repro_torch.core import mesh as _mesh
    sig = _mesh_signature(mesh, axis_names)
    if _mesh.is_device_mesh(mesh):
        _rank_places(mesh)      # the gather every rank makes, whatever hits
    act = active()
    if act is not None and act.signature() == sig:
        return act
    persisted = load_for_mesh(sig)
    if persisted is not None:
        return persisted
    return from_mesh(mesh, axis_names)


# ---------------------------------------------------------------------------
# persistence: env dir -> user cache -> the package's directory
# ---------------------------------------------------------------------------

def _package_topology_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1] / "profiles" \
        / "topologies"


def cache_dir() -> pathlib.Path:
    env = os.environ.get(TOPOLOGY_DIR_ENV)
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = pathlib.Path(xdg) if xdg else pathlib.Path.home() / ".cache"
    return base / "repro_torch" / "topologies"


def search_dirs() -> Tuple[pathlib.Path, ...]:
    return (cache_dir(), _package_topology_dir())


def _filename(fingerprint: str,
              signature: Tuple[Tuple[str, int], ...]) -> str:
    shape = "-".join(f"{nm}{sz}" for nm, sz in signature)
    return re.sub(r"[^A-Za-z0-9._-]+", "_", f"{fingerprint}.{shape}") \
        + ".json"


def topology_path(topology: Topology,
                  directory: Optional[os.PathLike] = None) -> pathlib.Path:
    d = pathlib.Path(directory) if directory is not None else cache_dir()
    return d / _filename(topology.fingerprint, topology.signature())


def save(topology: Topology,
         path: Optional[os.PathLike] = None) -> pathlib.Path:
    """Persist ``topology`` as schema-versioned JSON; returns the path."""
    p = pathlib.Path(path) if path is not None else topology_path(topology)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(topology.to_dict(), indent=2, allow_nan=False,
                            sort_keys=True) + "\n")
    return p


def load(path: os.PathLike) -> Topology:
    """Load one topology file; :class:`TopologyError` on a bad one."""
    try:
        doc = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError) as e:
        raise TopologyError(f"cannot read topology {path}: {e}") from e
    return Topology.from_dict(doc)


def persisted_path(signature: Tuple[Tuple[str, int], ...],
                   fingerprint: Optional[str] = None
                   ) -> Optional[pathlib.Path]:
    fp = fingerprint or _tuning.device_fingerprint()
    for d in search_dirs():
        p = d / _filename(fp, tuple(signature))
        if not p.is_file():
            continue
        try:
            t = load(p)
            if t.fingerprint == fp and t.signature() == tuple(signature):
                return p
        except TopologyError:
            continue
    return None


def load_for_mesh(signature: Tuple[Tuple[str, int], ...],
                  fingerprint: Optional[str] = None) -> Optional[Topology]:
    """The persisted topology matching (fingerprint, signature), or None;
    a file whose stored identity differs is passed over."""
    p = persisted_path(tuple(signature), fingerprint)
    if p is None:
        return None
    return dataclasses.replace(load(p), source="persisted")


# ---------------------------------------------------------------------------
# the active topology (its generation feeds the distributed plan cache)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_active: Optional[Topology] = None
_generation = 0


def active() -> Optional[Topology]:
    """The ambient topology, or None (resolution is per mesh:
    :func:`for_mesh`)."""
    return _active


def set_active(topology: Optional[Topology]) -> None:
    """Swap the ambient topology (None forgets it); bumps the generation
    the planner folds into its distributed plan keys."""
    global _active, _generation
    with _LOCK:
        _active = topology
        _generation += 1


def generation() -> int:
    return _generation


# ---------------------------------------------------------------------------
# calibration: a two-size all-to-all over each axis
# ---------------------------------------------------------------------------

def _time_ns(fn, devices, reps: int) -> float:
    """Best of ``reps`` runs of ``fn`` (one warm run first), synchronising
    every card the mesh uses around each run."""
    import torch
    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)
    fn()
    sync()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e9


def calibrate(mesh, axis_names: Optional[Sequence[str]] = None, *,
              small_bytes: int = 1 << 10, large_bytes: int = 1 << 20,
              reps: int = 3, persist: bool = False,
              set_as_active: bool = True) -> Topology:
    """Time an all-to-all over each mesh axis of more than one entry at
    a small and a large payload an entry, and fit (latency, bandwidth)
    per axis from the two points: the slope is ns a byte, the intercept
    the launch latency.  On a one-process ``Mesh`` the exchange is
    ``collectives.all_to_all`` over every group of entries along the axis
    (the other axes fixed), as the sample sort runs it, and an axis whose
    entries all share one device is recorded as tier ``local``: its
    copies stay inside that device's memory.  On a ``DeviceMesh`` it is
    the axis group's ``all_to_all_single`` (a collective call of every
    rank), the tier is ``from_mesh``'s and every rank keeps the slowest
    rank's times.  Size-1 axes keep the defaults; ``probe_ns`` keeps the
    raw timings."""
    import torch
    from repro_torch.core import mesh as _mesh
    from repro_torch.engine import collectives as coll
    base = from_mesh(mesh, axis_names)
    ranks = _mesh.is_device_mesh(mesh)
    if ranks:
        dev = torch.device(f"cuda:{torch.cuda.current_device()}"
                           if mesh.device_type == "cuda" else "cpu")
        world = coll.RankGroup(mesh, _mesh.axis_names(mesh), dev)
    probe: Dict[str, float] = {}
    axes_out = []
    for ax in base.axes:
        if ax.size <= 1:
            axes_out.append(ax)
            continue
        if ranks:
            grp = coll.RankGroup(mesh, (ax.name,), dev)

            def probe_bytes(nbytes: int, size=ax.size, grp=grp):
                per_row = max(1, nbytes // (4 * size))
                send = torch.zeros((size, per_row), dtype=torch.float32,
                                   device=dev)
                t = _time_ns(lambda: grp.all_to_all([send]), [dev], reps)
                return float(world.max_int(int(round(t)))), \
                    4 * size * per_row
            local = ax.tier == TIER_LOCAL
        else:
            groups = coll.axis_groups(mesh, ax.name)
            local = all(len({str(mesh.devices.flat[i]) for i in g}) == 1
                        for g in groups)

            def probe_bytes(nbytes: int, size=ax.size, groups=groups):
                per_row = max(1, nbytes // (4 * size))
                sends = [[torch.zeros((size, per_row), dtype=torch.float32,
                                      device=mesh.devices.flat[i])
                          for i in g] for g in groups]

                def run():
                    for g, s in zip(groups, sends):
                        coll.all_to_all(s, [mesh.devices.flat[i] for i in g])
                return _time_ns(run, list(mesh.devices.flat), reps), \
                    4 * size * per_row

        (t0, b0), (t1, b1) = probe_bytes(small_bytes), \
            probe_bytes(large_bytes)
        probe[f"{ax.name}.alltoall_{b0}B_ns"] = t0
        probe[f"{ax.name}.alltoall_{b1}B_ns"] = t1
        if b1 > b0 and t1 > t0:
            per_byte = (t1 - t0) / (b1 - b0)
            lat = max(0.0, t0 - per_byte * b0)
        else:                           # degenerate fit: keep defaults
            per_byte, lat = ax.per_byte_ns, ax.latency_ns
        axes_out.append(dataclasses.replace(
            ax, tier=TIER_LOCAL if local else ax.tier,
            bandwidth_bytes_per_s=1e9 / per_byte, latency_ns=lat))
    topo = dataclasses.replace(base, axes=tuple(axes_out),
                               source="calibrated", probe_ns=probe or None)
    if persist:
        import torch.distributed as dist
        if not ranks or dist.get_rank() == 0:    # one writer a topology
            save(topo)
    if set_as_active:
        set_active(topo)
    return topo
