"""Tiled run generation — rung one of the sort engine.

A (batched) array is cut into power-of-two runs, each sorted independently
by one of the run methods; the merge tree (engine/merge.py) then combines
them.  Runs are padded to ``n_tiles * run_len`` with ``n_tiles`` a power of
two (a complete merge tree); the padding carries the direction's sentinel,
falls to the far end and is sliced off after the merge.

Run methods: ``torch`` (stable ``torch.sort``), ``bitonic`` (the plain
network), ``cuda`` (the bitonic kernel, K1) and ``radix`` (the LSD radix
kernels, K3; stable).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.core import tuning as _tuning
from repro_torch.core.sortspec import next_pow2
from repro_torch.kernels.ops import pad_rows, sentinel as sort_sentinel

RUN_METHODS = ("torch", "bitonic", "cuda", "radix")


def run_layout(n: int, run_len: int) -> Tuple[int, int]:
    """(n_tiles, padded_n) for sorting ``n`` elements in ``run_len`` runs;
    ``run_len`` is rounded up to a power of two."""
    run_len = min(next_pow2(run_len), next_pow2(n))
    n_tiles = next_pow2(-(-n // run_len))
    return n_tiles, n_tiles * run_len


def _sort_tiles(tiles: torch.Tensor, method: str,
                descending: bool) -> torch.Tensor:
    """Sort each row of (rows*n_tiles, run_len) with the chosen method."""
    if method == "torch":
        out = torch.sort(tiles, dim=-1, stable=True).values
        return out.flip(-1) if descending else out
    if method == "bitonic":
        from repro_torch.kernels import bitonic_sort as _bs
        return _bs.apply_network(tiles, descending)
    if method == "cuda":
        from repro_torch.kernels import bitonic_sort as _bs
        return _bs.sort_blocks(tiles, descending=descending)
    if method == "radix":
        from repro_torch.kernels import radix_sort as _rs
        enc = keycodec.encode(tiles, descending=descending)
        return keycodec.decode(_rs.sort_blocks(enc), tiles.dtype,
                               descending=descending)
    raise ValueError(f"run method must be one of {RUN_METHODS}, got {method!r}")


def _sort_tiles_kv(keys: torch.Tensor, vals: torch.Tensor, method: str,
                   descending: bool):
    if method == "torch":
        # stable in both directions: ties keep ascending index order
        order = torch.sort(keys, dim=-1, stable=True,
                           descending=descending).indices
        return keys.gather(-1, order), vals.gather(-1, order)
    if method == "bitonic":
        from repro_torch.kernels import bitonic_sort as _bs
        return _bs.apply_network_kv(keys, vals, descending)
    if method == "cuda":
        from repro_torch.kernels import bitonic_sort as _bs
        return _bs.sort_kv_blocks(keys, vals, descending=descending)
    if method == "radix":
        from repro_torch.kernels import radix_sort as _rs
        enc = keycodec.encode(keys, descending=descending)
        sk, sv = _rs.sort_kv_blocks(enc, vals)
        return keycodec.decode(sk, keys.dtype, descending=descending), sv
    raise ValueError(f"run method must be one of {RUN_METHODS}, got {method!r}")


def generate_runs(x: torch.Tensor, run_len: Optional[int] = None, *,
                  method: str = "torch",
                  descending: bool = False) -> torch.Tensor:
    """(rows, n) -> (rows, n_tiles, run_len) independently sorted runs;
    ``run_len=None`` takes the active tuning profile's."""
    if run_len is None:
        run_len = _tuning.active().run_len
    rows, n = x.shape
    n_tiles, m = run_layout(n, run_len)
    x = pad_rows(x, m, sort_sentinel(x.dtype, descending)).contiguous()
    out = _sort_tiles(x.view(rows * n_tiles, m // n_tiles), method,
                      descending)
    return out.reshape(rows, n_tiles, m // n_tiles)


def generate_runs_kv(keys: torch.Tensor, vals: torch.Tensor,
                     run_len: Optional[int] = None, *, method: str = "torch",
                     descending: bool = False):
    """Key-value run generation: payloads follow their keys into the runs,
    pads carry the out-of-range position ``n``."""
    if run_len is None:
        run_len = _tuning.active().run_len
    rows, n = keys.shape
    n_tiles, m = run_layout(n, run_len)
    keys = pad_rows(keys, m, sort_sentinel(keys.dtype, descending))
    vals = pad_rows(vals, m, n)
    shape = (rows * n_tiles, m // n_tiles)
    sk, sv = _sort_tiles_kv(keys.contiguous().view(shape),
                            vals.contiguous().view(shape), method, descending)
    return (sk.reshape(rows, n_tiles, m // n_tiles),
            sv.reshape(rows, n_tiles, m // n_tiles))
