"""State carried across from the JAX package.

Model weights: :func:`params_from_jax` takes the JAX package's parameter
tree (nested dicts and lists of numpy arrays, ``np.asarray`` of each JAX
leaf) and returns the port's tree on a given device and dtype.  The two
layouts are the same leaf for leaf — matmul weights ``(d_in, d_out)``
applied as ``x @ w``, the stacked ``body`` leaves with their leading layer
axis — so no leaf is transposed.

A sort has no weights: what decides both packages' bits is the tuning
profile — ``run_len`` sets the run boundaries (and so the bits of every
unstable path, e.g. the -0.0/+0.0 order of a key-only bitonic run), while
``digit_bits``/``radix_tile`` set the radix passes, and
``spill_threshold_bytes``/``merge_fanin`` the spill tier's chunks and
merge width.  ``profile_from_jax`` takes a JAX ``TuningProfile.to_dict()``
(plain JSON, no JAX import) and returns the port's profile with the same
knobs and the cost constants under the port's backend names.

A mesh's link picture: ``topology_from_jax`` turns a JAX ``Topology``
document into the port's, with the tiers renamed (``ici`` -> ``nvlink``,
``dcn`` -> ``network``) and every axis's size and rates as recorded.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import topology, tuning
from repro_torch.core.sortspec import resolve_device

JAX_SCHEMA = "repro.tuning.profile/v1"
JAX_TOPOLOGY_SCHEMA = "repro.topology/v1"

# JAX tier -> the port's
TIERS = {"ici": topology.TIER_NVLINK, "dcn": topology.TIER_NETWORK}

# JAX constant name -> the port's (backends renamed: xla -> torch,
# pallas -> cuda).  The link constants (collective_*, dcn_*) are dropped:
# they price a TPU's ICI and DCN, and the port's ``links`` keep the
# H100's seeds
_CONSTANTS = {
    "xla": "torch", "bitonic": "bitonic", "pallas": "cuda",
    "merge_run": "merge_run", "merge_level": "merge_level",
    "radix": "radix", "select": "select", "xla_topk": "torch_topk",
    "pallas_interpret_penalty": "cuda_plain_penalty",
    "pcie_per_byte": "pcie_per_byte",
    "host_merge_level": "host_merge_level",
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
        merge_fanin=int(d.get("merge_fanin", tuning.DEFAULT_MERGE_FANIN)),
        capacity_slack=float(d.get("capacity_slack",
                                   tuning.DEFAULT_CAPACITY_SLACK)),
        source="converted")


def topology_from_jax(d: dict) -> topology.Topology:
    """The port's :class:`~repro_torch.core.topology.Topology` of a JAX
    ``Topology.to_dict()`` document: the same axes, sizes, rates and
    probes, the tiers renamed (:data:`TIERS`), ``source="converted"``."""
    if not isinstance(d, dict) or d.get("schema") != JAX_TOPOLOGY_SCHEMA:
        raise topology.TopologyError(
            f"not a JAX topology (schema {JAX_TOPOLOGY_SCHEMA!r}): "
            f"{d.get('schema') if isinstance(d, dict) else type(d).__name__}")
    axes = []
    for a in d.get("axes") or ():
        if a.get("tier") not in TIERS:
            raise topology.TopologyError(f"unknown JAX tier {a.get('tier')!r}")
        axes.append(dict(a, tier=TIERS[a["tier"]]))
    return topology.Topology.from_dict(dict(
        d, schema=topology.SCHEMA, axes=axes, source="converted"))


def _leaf(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))           # a writable copy
    return t.to(device=device, dtype=dtype)


# the leaves the reference keeps float32 in every model dtype: a MoE
# layer's router, the SSM's decay, skip and step bias, the RG-LRU's gate
# biases and decay parameter
FLOAT32_LEAVES = ("router", "a_log", "d_skip", "dt_bias", "b_a", "b_i",
                  "lam")


def params_from_jax(params: Any, cfg: ModelConfig, *, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The port's parameter tree for ``cfg`` from the JAX package's (nested
    dicts/lists of numpy arrays, ``prefix`` lists and stacked ``body``
    leaves alike): every leaf a tensor of ``dtype`` (default
    ``cfg.param_dtype()``) on ``device`` (default ``"cuda"``), but the
    leaves of :data:`FLOAT32_LEAVES`, which stay float32 as the reference
    keeps them."""
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype()

    def conv(tree, key=None):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return _leaf(tree, torch.float32 if key in FLOAT32_LEAVES else dtype,
                     dev)

    return conv(params)
