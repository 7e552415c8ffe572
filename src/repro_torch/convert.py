"""State carried across from the JAX package.

A sort has no weights: what decides both packages' bits is the tuning
profile — ``run_len`` sets the run boundaries (and so the bits of every
unstable path, e.g. the -0.0/+0.0 order of a key-only bitonic run), while
``digit_bits``/``radix_tile`` set the radix passes.  ``profile_from_jax``
takes a JAX ``TuningProfile.to_dict()`` (plain JSON, no JAX import) and
returns the port's profile with the same knobs and the cost constants
under the port's backend names.
"""
from __future__ import annotations

from repro_torch.core import tuning

JAX_SCHEMA = "repro.tuning.profile/v1"

# JAX constant name -> the port's (backends renamed: xla -> torch,
# pallas -> cuda); constants of backends the port lacks are dropped
_CONSTANTS = {
    "xla": "torch", "bitonic": "bitonic", "pallas": "cuda",
    "merge_run": "merge_run", "merge_level": "merge_level",
    "radix": "radix", "select": "select",
    "pallas_interpret_penalty": "cuda_plain_penalty",
}


def profile_from_jax(d: dict) -> tuning.TuningProfile:
    """The port's :class:`~repro_torch.core.tuning.TuningProfile` with the
    knobs of a JAX profile document."""
    if not isinstance(d, dict) or d.get("schema") != JAX_SCHEMA:
        raise tuning.ProfileError(
            f"not a JAX tuning profile (schema {JAX_SCHEMA!r}): "
            f"{d.get('schema') if isinstance(d, dict) else type(d).__name__}")
    consts = d.get("constants") or {}
    return tuning.TuningProfile(
        fingerprint=str(d["fingerprint"]),
        constants=tuning.DeviceSortConstants(
            **{ours: float(consts[theirs])
               for theirs, ours in _CONSTANTS.items() if theirs in consts}),
        digit_bits=int(d["digit_bits"]),
        radix_tile=int(d["radix_tile"]),
        run_len=int(d["run_len"]),
        spill_threshold_bytes=int(d["spill_threshold_bytes"]),
        select_min_n=int(d.get("select_min_n",
                               tuning.DEFAULT_SELECT_MIN_N)),
        source="converted")
