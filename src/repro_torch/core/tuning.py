"""Per-device tuning profiles — cost constants + kernel knobs.

The port's copy of the JAX package's tuning layer: one frozen
:class:`TuningProfile` holding the planner's per-element cost constants
and the kernel shape parameters (radix ``digit_bits``, radix tile, engine
``run_len``, the selection switch-over ``select_min_n``, the spill tier's
``merge_fanin`` and ``spill_threshold_bytes``) and the distributed tier's
link constants (``links``), keyed by a device
fingerprint and schema-versioned for JSON.  Every consumer (cost model,
radix kernels, run generation, planner, spill tier) reads the *active*
profile; :func:`set_active` bumps a generation counter the planner folds
into its plan-cache keys, so swapping profiles re-plans.

* ``active()`` resolves lazily: a persisted profile whose fingerprint
  matches this machine wins, the built-in seeds otherwise.  The search
  path is ``$REPRO_TORCH_TUNING_DIR`` (else the user cache,
  ``~/.cache/repro_torch/profiles``), then the port's own
  ``repro_torch/profiles/`` directory, which ships empty: a profile is a
  measurement of one machine, made there by ``planner.calibrate``.
* :func:`refresh_if_stale` re-probes (``planner.calibrate``) when the
  ``planner.cost_model_error`` histogram's p90 leaves the trust band, at
  most once a cooldown; :func:`maybe_refresh`, the engine's hook, does it
  only under ``REPRO_TORCH_AUTOTUNE=1``.

The seeds are the JAX package's, renamed with the backends (``xla`` ->
``torch``, ``pallas`` -> ``cuda``): none was measured on a CUDA card until
``calibrate`` runs there.  The CUDA kernel knobs are chosen from the
kernels' design (see ``default_profile``).

This module imports nothing from the rest of the package at module level.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import threading
import time
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "SCHEMA", "DeviceSortConstants", "LinkConstants", "TuningProfile",
    "ProfileError",
    "device_fingerprint", "default_profile", "active", "set_active",
    "generation", "profile_path", "save", "load", "load_for_device",
    "persisted_path", "search_dirs", "cache_dir", "refresh_if_stale",
    "maybe_refresh",
]

SCHEMA = "repro_torch.tuning.profile/v1"

PROFILE_DIR_ENV = "REPRO_TORCH_TUNING_DIR"   # highest-priority profile dir
AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE"        # "1" => maybe_refresh() is live

DEFAULT_DIGIT_BITS = 8          # radix 256: 4 passes for 32-bit keys
DEFAULT_RADIX_TILE = 256        # elements per histogram tile (CPU)
DEFAULT_CPU_RUN_LEN = 8192      # host tile (the JAX package's CPU default)
# CUDA knobs.  run_len: the bitonic kernel holds a whole run in shared
# memory (16 KB of float32 keys, 32 KB with the payload), small enough for
# several CTAs per SM; a 2^28-key sort then takes 16 merge levels.
# radix_tile: the tile of the plain radix histograms (the reference's); the
# card's K3 runs fixed 4096-key tiles and K4 a grid sized to the card, so
# neither follows it there.
CUDA_RUN_LEN = 4096
CUDA_RADIX_TILE = 4096
DEFAULT_CAPACITY_SLACK = 1.0    # sample-sort bucket capacity (multi-device)
DEFAULT_SELECT_MIN_N = 1024     # auto never picks selection below this n
# runs one k-way merge tournament of the spill tier consumes at a time
DEFAULT_MERGE_FANIN = 16
# auto plans above this many key bytes belong to the spill tier
DEFAULT_SPILL_THRESHOLD_BYTES = 4 << 30
MIN_SPILL_THRESHOLD_BYTES = 64

_VALID_DIGIT_BITS = (1, 2, 4, 8)

# drift band: re-probe when cost_model_error's p90 leaves
# [1/threshold, threshold] after at least min-observations samples, at most
# once a cooldown
REFRESH_P90_THRESHOLD = 4.0
REFRESH_MIN_OBSERVATIONS = 32
REFRESH_COOLDOWN_S = 300.0


@dataclasses.dataclass(frozen=True)
class DeviceSortConstants:
    """ns-per-element leading constants of each backend's cost model.

    The JAX package's default seeds, renamed with the backends (``xla`` ->
    ``torch``, ``pallas`` -> ``cuda``, ``xla_topk`` -> ``torch_topk``);
    ``planner.calibrate`` measures them.  ``cuda_plain_penalty`` is the
    multiplier the planner applies to the kernel backends off the card,
    where their plain versions run.  ``pcie_per_byte`` (ns a byte over the
    host link, ~16 GB/s) and ``host_merge_level`` (one host cursor
    partition + block merge, a key) price the spill tier."""
    torch: float = 6.0           # comparison sort: c * n log2 n
    # torch.sort on the card, a radix sort: c * n * passes of 8 bits (the
    # seed: the radix seed x torch/radix ms of a 2^28 float32 sort on an
    # H100, 13.34 / 15.01)
    torch_card: float = 10.7
    bitonic: float = 1.2         # plain network: c * n log2^2 n
    cuda: float = 0.25           # shared-memory network: c * n log2^2 n
    merge_run: float = 6.0       # run generation: c * n log2 run_len
    merge_level: float = 12.0    # one merge level: c * n
    radix: float = 12.0          # LSD digit pass: c * n * passes
    select: float = 15.0         # MSD select: c * n * passes (+ k log k)
    torch_topk: float = 3.5      # torch backend's top-k off the card: c * n
    cuda_plain_penalty: float = 300.0
    pcie_per_byte: float = 0.0625
    host_merge_level: float = 8.0


# NVLink 4 on an H100 SXM: 450 GB/s a direction (NVIDIA's data sheet,
# 900 GB/s both ways); a seed from the specification, not a measurement
NVLINK_BYTES_PER_S = 450e9
# between nodes: one 400 Gb/s InfiniBand NDR port a card, 50 GB/s (the
# specification's rate)
NETWORK_BYTES_PER_S = 50e9


@dataclasses.dataclass(frozen=True)
class LinkConstants:
    """What one collective round costs on each link tier: ``alpha`` ns a
    launch plus ``per_byte`` ns a byte a device moves.  The JAX package
    keeps these among its cost constants (``collective_*``, ``dcn_*``,
    priced for a TPU's ICI and DCN); the port seeds them from the H100's
    links, NVLink inside a node and the network between nodes, and
    ``topology.calibrate`` measures them per mesh axis."""
    collective_alpha: float = 2_000.0                  # ns a launch
    collective_per_byte: float = 1e9 / NVLINK_BYTES_PER_S
    network_alpha: float = 2_000.0 * NVLINK_BYTES_PER_S / NETWORK_BYTES_PER_S
    network_per_byte: float = 1e9 / NETWORK_BYTES_PER_S


class ProfileError(ValueError):
    """A profile document that cannot be trusted: wrong schema version,
    malformed JSON, or field values outside the validated ranges."""


@dataclasses.dataclass(frozen=True)
class TuningProfile:
    """One device's cost constants + kernel parameters.  ``source`` records
    provenance: ``"default"``, ``"calibrated"`` (``planner.calibrate`` in
    this process), ``"persisted"`` (resolved from the search path),
    ``"converted"`` (from a JAX profile, ``repro_torch.convert``) or
    ``"loaded"`` (:func:`load`).  ``probe_ns`` and ``sweeps`` keep the raw
    timings a calibration derived its values from.  ``capacity_slack``
    and ``links`` belong to the distributed tier: carried and validated,
    never swept by ``planner.calibrate`` (``topology.calibrate`` measures
    links)."""
    fingerprint: str
    constants: DeviceSortConstants = DeviceSortConstants()
    links: LinkConstants = LinkConstants()
    digit_bits: int = DEFAULT_DIGIT_BITS
    radix_tile: int = DEFAULT_RADIX_TILE
    run_len: int = DEFAULT_CPU_RUN_LEN
    capacity_slack: float = DEFAULT_CAPACITY_SLACK
    select_min_n: int = DEFAULT_SELECT_MIN_N
    merge_fanin: int = DEFAULT_MERGE_FANIN
    spill_threshold_bytes: int = DEFAULT_SPILL_THRESHOLD_BYTES
    source: str = "default"
    probe_ns: Optional[Dict[str, float]] = None
    sweeps: Optional[Dict[str, Dict[str, float]]] = None
    schema: str = SCHEMA

    def __post_init__(self):
        if self.schema != SCHEMA:
            raise ProfileError(
                f"unknown profile schema {self.schema!r} (expected {SCHEMA!r})")
        if self.digit_bits not in _VALID_DIGIT_BITS:
            raise ProfileError(
                f"digit_bits must be one of {_VALID_DIGIT_BITS}, "
                f"got {self.digit_bits}")
        if self.radix_tile < 8:
            raise ProfileError(f"radix_tile too small: {self.radix_tile}")
        if self.run_len < 2:
            raise ProfileError(f"run_len too small: {self.run_len}")
        if self.capacity_slack < 1.0:
            raise ProfileError(
                f"capacity_slack must be >= 1.0, got {self.capacity_slack}")
        lk = self.links
        if not (lk.collective_per_byte > 0 and lk.network_per_byte > 0
                and lk.collective_alpha >= 0 and lk.network_alpha >= 0):
            raise ProfileError(f"link constants must be positive, got {lk}")
        if self.select_min_n < 0:
            raise ProfileError(
                f"select_min_n must be >= 0, got {self.select_min_n}")
        if self.merge_fanin < 2:
            raise ProfileError(
                f"merge_fanin must be >= 2, got {self.merge_fanin}")
        if self.spill_threshold_bytes < MIN_SPILL_THRESHOLD_BYTES:
            raise ProfileError(
                f"spill_threshold_bytes must be >= "
                f"{MIN_SPILL_THRESHOLD_BYTES}, "
                f"got {self.spill_threshold_bytes}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuningProfile":
        if not isinstance(d, dict):
            raise ProfileError(f"profile document must be an object, "
                               f"got {type(d).__name__}")
        if d.get("schema") != SCHEMA:
            raise ProfileError(f"unknown profile schema {d.get('schema')!r} "
                               f"(expected {SCHEMA!r})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ProfileError(
                f"unknown profile fields {sorted(unknown)} (schema {SCHEMA})")
        if not isinstance(d.get("fingerprint"), str):
            raise ProfileError("profile is missing its device fingerprint")
        d = dict(d)
        consts = d.get("constants")
        if consts is not None:
            if not isinstance(consts, dict):
                raise ProfileError("profile constants must be an object")
            cfields = {f.name for f in dataclasses.fields(DeviceSortConstants)}
            bad = set(consts) - cfields
            if bad:
                raise ProfileError(
                    f"unknown cost constants {sorted(bad)} (schema {SCHEMA})")
            d["constants"] = DeviceSortConstants(
                **{k: float(v) for k, v in consts.items()})
        links = d.get("links")
        if links is not None:
            if not isinstance(links, dict):
                raise ProfileError("profile links must be an object")
            bad = set(links) - {f.name for f in
                                dataclasses.fields(LinkConstants)}
            if bad:
                raise ProfileError(
                    f"unknown link constants {sorted(bad)} (schema {SCHEMA})")
            d["links"] = LinkConstants(
                **{k: float(v) for k, v in links.items()})
        try:
            return cls(**d)
        except TypeError as e:
            raise ProfileError(f"malformed profile: {e}") from e


def device_fingerprint() -> str:
    """``cuda/<device name>/sm_<cc>/torch-<version>`` on a machine with a
    card, ``cpu/<machine>/torch-<version>`` otherwise — the key a profile
    is trusted under."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        fp = (f"cuda/{torch.cuda.get_device_name(0)}/sm_{major}{minor}/"
              f"torch-{torch.__version__}")
    else:
        fp = f"cpu/{os.uname().machine}/torch-{torch.__version__}"
    return fp.replace(" ", "-")


def default_profile() -> TuningProfile:
    """The built-in seeds for the running machine."""
    if torch.cuda.is_available():
        return TuningProfile(fingerprint=device_fingerprint(),
                             run_len=CUDA_RUN_LEN,
                             radix_tile=CUDA_RADIX_TILE, source="default")
    return TuningProfile(fingerprint=device_fingerprint(), source="default")


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _repo_profile_dir() -> pathlib.Path:
    """``repro_torch/profiles/``: baselines committed with the package (it
    ships empty)."""
    return pathlib.Path(__file__).resolve().parents[1] / "profiles"


def cache_dir() -> pathlib.Path:
    """Where ``calibrate(persist=True)`` writes by default:
    ``$REPRO_TORCH_TUNING_DIR`` when set, else
    ``$XDG_CACHE_HOME/repro_torch/profiles`` (``~/.cache`` by default)."""
    env = os.environ.get(PROFILE_DIR_ENV)
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = pathlib.Path(xdg) if xdg else pathlib.Path.home() / ".cache"
    return base / "repro_torch" / "profiles"


def search_dirs() -> Tuple[pathlib.Path, ...]:
    """Profile lookup order: the env override (else the user cache), then
    the package's own directory."""
    return (cache_dir(), _repo_profile_dir())


def profile_path(directory: Optional[os.PathLike] = None,
                 fingerprint: Optional[str] = None) -> pathlib.Path:
    """The file of a fingerprint's profile (default: this machine's) in
    ``directory`` (default: :func:`cache_dir`), named as the JAX package
    names it."""
    fp = fingerprint or device_fingerprint()
    d = pathlib.Path(directory) if directory is not None else cache_dir()
    return d / (re.sub(r"[^A-Za-z0-9._-]+", "_", fp) + ".json")


def save(profile: TuningProfile,
         path: Optional[os.PathLike] = None) -> pathlib.Path:
    """Write ``profile`` as schema-versioned JSON (default: its
    fingerprint's file in :func:`cache_dir`); returns the path."""
    p = pathlib.Path(path) if path is not None \
        else profile_path(fingerprint=profile.fingerprint)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(profile.to_dict(), indent=2, allow_nan=False,
                            sort_keys=True) + "\n")
    return p


def load(path: os.PathLike) -> TuningProfile:
    """Read one profile file; :class:`ProfileError` on a bad document."""
    try:
        doc = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError) as e:
        raise ProfileError(f"cannot read profile {path}: {e}") from e
    return dataclasses.replace(TuningProfile.from_dict(doc), source="loaded")


def persisted_path(fingerprint: Optional[str] = None
                   ) -> Optional[pathlib.Path]:
    """The first file in the search order holding a valid profile whose
    stored fingerprint matches, or None."""
    fp = fingerprint or device_fingerprint()
    for d in search_dirs():
        p = profile_path(d, fp)
        if not p.is_file():
            continue
        try:
            if load(p).fingerprint == fp:
                return p
        except ProfileError:
            continue
    return None


def load_for_device(fingerprint: Optional[str] = None
                    ) -> Optional[TuningProfile]:
    """This machine's persisted profile, or None.  A file whose stored
    fingerprint differs (copied from another machine) or that does not
    parse is passed over: the seeds beat a mispriced plan."""
    p = persisted_path(fingerprint)
    if p is None:
        return None
    return dataclasses.replace(load(p), source="persisted")


# ---------------------------------------------------------------------------
# active-profile ambient
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_active: Optional[TuningProfile] = None
_generation = 0
# monotonic stamp of the last drift-triggered calibrate (None = never)
_last_refresh_t: Optional[float] = None


def _set(profile: Optional[TuningProfile]) -> None:
    global _active, _generation, _last_refresh_t
    _active = profile
    _generation += 1
    # a new profile starts a new refresh epoch: the cooldown of a refresh
    # belongs to the profile it installed (refresh_if_stale stamps after
    # its calibrate returns)
    _last_refresh_t = None


def active() -> TuningProfile:
    """The profile the stack runs on: resolved on first use — a persisted
    profile matching this machine's fingerprint, else the seeds."""
    if _active is None:
        with _LOCK:
            if _active is None:
                prof = load_for_device()
                _set(prof if prof is not None else default_profile())
    return _active


def set_active(profile: Optional[TuningProfile]) -> None:
    """Swap the active profile (``None`` = forget it and resolve again on
    next use).  Bumps the generation, so cached plans die."""
    with _LOCK:
        _set(profile)


def generation() -> int:
    """Monotonic counter for cache keys (forces resolution first)."""
    active()
    return _generation


# ---------------------------------------------------------------------------
# drift refresh
# ---------------------------------------------------------------------------

def refresh_if_stale(threshold: float = REFRESH_P90_THRESHOLD,
                     min_count: int = REFRESH_MIN_OBSERVATIONS, *,
                     persist: bool = True,
                     cooldown_s: float = REFRESH_COOLDOWN_S,
                     now_fn=None,
                     **calibrate_kwargs) -> Optional[TuningProfile]:
    """Re-run ``planner.calibrate`` when the measured/predicted ratios of
    the ``planner.cost_model_error`` histogram (one a fenced engine call)
    say the active constants no longer describe this device: at least
    ``min_count`` observations with a p90 outside ``[1/threshold,
    threshold]``.  The calibration installs (and by default persists) a
    fresh profile; the histogram is then cleared.  Returns the profile, or
    None when the constants hold or the signal is too thin.

    After a refresh, triggers within ``cooldown_s`` (``now_fn``, a
    monotonic clock by default) return None and keep the histogram, so
    the refresh fires once the cooldown lapses; each such refusal counts
    on ``tuning.refreshes_rate_limited``.  ``cooldown_s=0`` disables it."""
    global _last_refresh_t
    from repro_torch.obs import metrics
    h = metrics.histogram("planner.cost_model_error")
    if h.count < min_count:
        return None
    p90 = h.percentile(90)
    if p90 is None or (1.0 / threshold) <= p90 <= threshold:
        return None
    now = (now_fn or time.monotonic)()
    if _last_refresh_t is not None and cooldown_s > 0 \
            and now - _last_refresh_t < cooldown_s:
        metrics.counter("tuning.refreshes_rate_limited").inc()
        return None
    from repro_torch.engine import planner
    prof = planner.calibrate(persist=persist, **calibrate_kwargs)
    _last_refresh_t = now
    h.clear()
    metrics.counter("tuning.refreshes").inc()
    from repro_torch.obs import trace
    trace.record_event("tuning_refresh", p90=p90, threshold=threshold,
                       fingerprint=prof.fingerprint, source=prof.source)
    return prof


_autotune_live: Optional[bool] = None


def maybe_refresh() -> None:
    """The engine's hook after every cost observation: a no-op unless
    ``REPRO_TORCH_AUTOTUNE=1`` opts the process into re-probing (a
    calibration mid-serve is a decision, never a surprise)."""
    global _autotune_live
    if _autotune_live is None:
        _autotune_live = os.environ.get(AUTOTUNE_ENV) == "1"
    if _autotune_live:
        refresh_if_stale()
