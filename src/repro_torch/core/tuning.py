"""Per-device tuning profiles — cost constants + kernel knobs.

The port's copy of the JAX package's tuning layer: one frozen
:class:`TuningProfile` holding the planner's per-element cost constants
and the kernel shape parameters (radix ``digit_bits``, radix tile, engine
``run_len``, the selection switch-over ``select_min_n``), keyed by a
device fingerprint and schema-versioned for JSON.  Every consumer (cost
model, radix kernels, run generation, planner) reads the *active*
profile; :func:`set_active` bumps a generation counter the planner folds
into its plan-cache keys, so swapping profiles re-plans.

Not carried yet: calibration (``calibrate``/``maybe_refresh``, ROADMAP
Queue 1 item 7) and the persisted-profile search path.  Until then the
constants are the JAX package's default seeds, copied unchanged — none of
them was measured on a CUDA card — and the CUDA kernel knobs are
placeholders chosen from the kernels' design (see ``default_profile``).

This module imports nothing from the rest of the package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import threading
from typing import Optional

import torch

__all__ = [
    "SCHEMA", "DeviceSortConstants", "TuningProfile", "ProfileError",
    "device_fingerprint", "default_profile", "active", "set_active",
    "generation", "profile_path", "save", "load",
]

SCHEMA = "repro_torch.tuning.profile/v1"

DEFAULT_DIGIT_BITS = 8          # radix 256: 4 passes for 32-bit keys
DEFAULT_RADIX_TILE = 256        # elements per histogram tile (CPU)
DEFAULT_CPU_RUN_LEN = 8192      # host tile (the JAX package's CPU default)
# CUDA placeholders until calibration measures them.  run_len: the bitonic
# kernel holds a whole run in shared memory (16 KB of float32 keys, 32 KB
# with the payload), small enough for several CTAs per SM; a 2^28-key sort
# then takes 16 merge levels.  radix_tile: the tile of the plain radix
# histograms (the reference's); the card's K3 runs fixed 4096-key tiles and
# K4 a grid sized to the card, so neither follows it there.
CUDA_RUN_LEN = 4096
CUDA_RADIX_TILE = 4096
DEFAULT_SELECT_MIN_N = 1024     # auto never picks selection below this n
# auto plans above this many key bytes belong to the spill tier (not ported)
DEFAULT_SPILL_THRESHOLD_BYTES = 4 << 30
MIN_SPILL_THRESHOLD_BYTES = 64

_VALID_DIGIT_BITS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class DeviceSortConstants:
    """ns-per-element leading constants of each backend's cost model.

    The JAX package's default seeds, renamed with the backends (``xla`` ->
    ``torch``, ``pallas`` -> ``cuda``); not measured on any card.
    ``cuda_plain_penalty`` is the multiplier the planner applies to the
    kernel backends off the card, where their plain versions run."""
    torch: float = 6.0           # comparison sort: c * n log2 n
    bitonic: float = 1.2         # plain network: c * n log2^2 n
    cuda: float = 0.25           # shared-memory network: c * n log2^2 n
    merge_run: float = 6.0       # run generation: c * n log2 run_len
    merge_level: float = 12.0    # one merge level: c * n
    radix: float = 12.0          # LSD digit pass: c * n * passes
    select: float = 15.0         # MSD select: c * n * passes (+ k log k)
    cuda_plain_penalty: float = 300.0


class ProfileError(ValueError):
    """A profile document that cannot be trusted: wrong schema version,
    malformed JSON, or field values outside the validated ranges."""


@dataclasses.dataclass(frozen=True)
class TuningProfile:
    """One device's cost constants + kernel parameters.  ``source`` records
    provenance: ``"default"``, ``"converted"`` (from a JAX profile,
    ``repro_torch.convert``) or ``"loaded"``."""
    fingerprint: str
    constants: DeviceSortConstants = DeviceSortConstants()
    digit_bits: int = DEFAULT_DIGIT_BITS
    radix_tile: int = DEFAULT_RADIX_TILE
    run_len: int = DEFAULT_CPU_RUN_LEN
    spill_threshold_bytes: int = DEFAULT_SPILL_THRESHOLD_BYTES
    select_min_n: int = DEFAULT_SELECT_MIN_N
    source: str = "default"
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
        if self.spill_threshold_bytes < MIN_SPILL_THRESHOLD_BYTES:
            raise ProfileError(
                f"spill_threshold_bytes must be >= "
                f"{MIN_SPILL_THRESHOLD_BYTES}, "
                f"got {self.spill_threshold_bytes}")
        if self.select_min_n < 0:
            raise ProfileError(
                f"select_min_n must be >= 0, got {self.select_min_n}")

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


def profile_path(directory: os.PathLike,
                 fingerprint: Optional[str] = None) -> pathlib.Path:
    """The file of a fingerprint's profile (default: this machine's) in
    ``directory``, named as the JAX package names it."""
    fp = fingerprint or device_fingerprint()
    return pathlib.Path(directory) / (re.sub(r"[^A-Za-z0-9._-]+", "_", fp)
                                      + ".json")


def save(profile: TuningProfile, path: os.PathLike) -> pathlib.Path:
    """Write ``profile`` as schema-versioned JSON."""
    p = pathlib.Path(path)
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


_LOCK = threading.Lock()
_active: Optional[TuningProfile] = None
_generation = 0


def active() -> TuningProfile:
    """The profile the stack runs on (the defaults until one is set)."""
    global _active, _generation
    if _active is None:
        with _LOCK:
            if _active is None:
                _active = default_profile()
                _generation += 1
    return _active


def set_active(profile: Optional[TuningProfile]) -> None:
    """Swap the active profile (``None`` = back to the defaults, resolved
    lazily).  Bumps the generation, so cached plans die."""
    global _active, _generation
    with _LOCK:
        _active = profile
        _generation += 1


def generation() -> int:
    """Monotonic counter for cache keys (forces resolution first)."""
    active()
    return _generation
