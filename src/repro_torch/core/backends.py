"""The built-in SortBackend implementations of the port.

Backend names follow the JAX package except where a name says which
substrate runs it: ``xla`` is ``torch`` here (``torch.sort``, the reference
backend) and ``pallas`` is ``cuda`` (the hand-written whole-row bitonic
kernel).  ``bitonic``, ``imc``, ``merge``, ``radix`` and ``select`` keep
their names.  Each
``Capabilities`` states exactly what its code takes; the planner derives
all auto-dispatch eligibility from them.  Kernel modules are imported
inside the methods so importing the registry stays cheap.
"""
from __future__ import annotations

import torch

from repro_torch.core import keycodec as _keycodec
from repro_torch.core.sortspec import (Capabilities, SortBackend,
                                       next_pow2, register_backend)
from repro_torch.kernels.bitonic_sort import MAX_N as MAX_CUDA_N

# the plain network's cap under auto (its work grows as n log^2 n)
MAX_BITONIC_N = 1 << 14

# dtypes every comparison backend handles (NaN-free floats assumed)
COMPARABLE_DTYPES = frozenset({
    "float32", "bfloat16", "float16", "int32", "uint32",
    "int16", "uint16", "int8", "uint8"})

_INT_DTYPES = frozenset({"int8", "int16", "int32",
                         "uint8", "uint16", "uint32"})


def _gather_kv(keys, values, order):
    """(sorted keys, permuted payload) from an argsort permutation.  The
    network backends sort (key, index) and gather both sides: an arbitrary
    payload could tie or exceed the pad marker of the network."""
    order = order.to(torch.int64)
    return keys.gather(-1, order), values.gather(-1, order)


# ---------------------------------------------------------------------------
# torch — the library reference (the JAX package's ``xla``)
# ---------------------------------------------------------------------------

@register_backend
class TorchBackend(SortBackend):
    """``torch.sort(stable=True)`` with the JAX reference's exact bits:

    * ``sort`` descending is the flip of the ascending stable sort, as
      ``_xla_sort`` is (equal keys of different bits, -0.0 and +0.0, come
      out in the reverse of their input order);
    * ``argsort``/``sort_kv`` keep ascending index order on ties in both
      directions (``jnp.argsort(stable=True, descending=...)``);
    * ``topk`` is a stable descending sort on the IEEE total order plus a
      slice: ``lax.top_k`` ranks +0.0 above -0.0 and takes the lower index
      first among equal keys.  ``torch.topk`` breaks ties otherwise and is
      never used.
    """
    name = "torch"
    capabilities = Capabilities(dtypes=None, stable=True, substrate="host")

    def sort(self, rows, *, descending=False, plan=None):
        out = torch.sort(rows, dim=-1, stable=True).values
        return out.flip(-1) if descending else out

    def argsort(self, rows, *, descending=False, plan=None):
        return torch.sort(rows, dim=-1, stable=True,
                          descending=descending).indices.to(torch.int32)

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        return _gather_kv(keys, values,
                          self.argsort(keys, descending=descending))

    def topk(self, rows, k, *, plan=None):
        order = torch.sort(_keycodec.total_order_key(rows), dim=-1,
                           stable=True, descending=True).indices[..., :k]
        return rows.gather(-1, order), order.to(torch.int32)


# ---------------------------------------------------------------------------
# bitonic — the paper's network, in plain PyTorch
# ---------------------------------------------------------------------------

@register_backend
class BitonicBackend(SortBackend):
    """The network of K1 in plain PyTorch ops on any device (the JAX
    package's word-parallel jnp network); differentiable, with XLA's
    min/max gradient."""
    name = "bitonic"
    capabilities = Capabilities(dtypes=COMPARABLE_DTYPES, stable=False,
                                max_n=MAX_BITONIC_N, substrate="host")

    def sort(self, rows, *, descending=False, plan=None):
        from repro_torch.kernels import bitonic_sort as _bs
        from repro_torch.kernels.ops import pad_rows, sentinel
        n = rows.shape[-1]
        x = pad_rows(rows, next_pow2(n), sentinel(rows.dtype, descending))
        return _bs.apply_network(x, descending)[:, :n]

    def argsort(self, rows, *, descending=False, plan=None):
        from repro_torch.kernels import bitonic_sort as _bs
        from repro_torch.kernels.ops import pad_rows, sentinel
        n = rows.shape[-1]
        m = next_pow2(n)
        x = pad_rows(rows, m, sentinel(rows.dtype, descending))
        # pad payload n: pad keys can tie genuine extreme keys, and the
        # comparator breaks ties on ascending payload
        idx = pad_rows(torch.arange(n, dtype=torch.int32, device=rows.device)
                       .expand(rows.shape), m, n)
        return _bs.apply_network_kv(x, idx, descending)[1][:, :n]

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        return _gather_kv(keys, values,
                          self.argsort(keys, descending=descending))


# ---------------------------------------------------------------------------
# cuda — the whole row in shared memory (the JAX package's ``pallas``)
# ---------------------------------------------------------------------------

@register_backend
class CudaBackend(SortBackend):
    """K1 through ``kernels/ops.py``: the key-value kernel with an index
    payload, then a gather.  Top-k is K5 per row (per 2048-key chunk and
    an ordering of the candidates for longer rows), at any n when asked
    for by name; ``max_n`` caps only what ``auto`` hands it.  Keys compare
    numerically: -0.0 and +0.0 tie and keep index order, as in the
    reference's ``pallas`` top-k.  On a CPU tensor the plain versions
    run."""
    name = "cuda"
    capabilities = Capabilities(dtypes=COMPARABLE_DTYPES, stable=False,
                                max_n=MAX_CUDA_N, substrate="cuda")

    def sort(self, rows, *, descending=False, plan=None):
        from repro_torch.kernels import ops
        return ops.bitonic_sort(rows, -1, descending)

    def argsort(self, rows, *, descending=False, plan=None):
        from repro_torch.kernels import ops
        return ops.bitonic_argsort(rows, -1, descending)

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        return _gather_kv(keys, values,
                          self.argsort(keys, descending=descending))

    def topk(self, rows, k, *, plan=None):
        from repro_torch.kernels import ops
        return ops.bitonic_topk(rows, k)


# ---------------------------------------------------------------------------
# imc — the paper's bit-serial gate program
# ---------------------------------------------------------------------------

@register_backend
class ImcBackend(SortBackend):
    """The 28-cycle gate program of the 6T SRAM array: the cycle-accurate
    simulator on the CPU, one K7 launch per network stage on a card.
    Validation and benchmarking only (never auto-dispatched); keys go
    through the order-preserving codec so signed ints sort correctly.
    Rows must be a power of two long (the network is not padded)."""
    name = "imc"
    capabilities = Capabilities(dtypes=_INT_DTYPES, stable=False,
                                supports_kv=False, supports_topk=False,
                                supports_segments=False, auto_dispatch=False,
                                substrate="sram")

    def sort(self, rows, *, descending=False, plan=None):
        from repro_torch.core import sorter
        self.check_dtype(rows.dtype)
        bits = _keycodec.key_bits(rows.dtype)
        res = sorter.sort_in_memory(_keycodec.encode(rows), width=bits,
                                    device=rows.device)
        # the W-bit words (in [0, 2^W)) back into the same-width carrier,
        # flipped there: torch has no flip for uint16/uint32 on the CPU
        enc = res.values
        if bits < 32:
            sign = 1 << (bits - 1)
            enc = (enc ^ sign) - sign
        enc = enc.to(_keycodec.key_dtype(rows.dtype))
        if descending:
            enc = enc.flip(-1)
        return _keycodec.decode(enc, rows.dtype)

    def argsort(self, rows, *, descending=False, plan=None):
        """Argsort on the bit-serial sorter via
        ``keycodec.argsort_composite``: unique composites give the
        (unstable) network the engine's tie convention — ties keep
        ascending index order in both directions."""
        from repro_torch.core import sorter
        self.check_dtype(rows.dtype)
        comp, idx_bits = _keycodec.argsort_composite(rows,
                                                     descending=descending)
        # the CAS gate program is built for power-of-two word widths
        width = next_pow2(_keycodec.key_bits(rows.dtype) + idx_bits)
        res = sorter.sort_in_memory(comp, width=width, device=rows.device)
        return res.values & ((1 << idx_bits) - 1)


# ---------------------------------------------------------------------------
# merge — the run + merge-tree engine
# ---------------------------------------------------------------------------

@register_backend
class MergeBackend(SortBackend):
    """Tiled run generation + merge-path merge tree (repro_torch.engine)."""
    name = "merge"
    capabilities = Capabilities(dtypes=COMPARABLE_DTYPES, stable=False,
                                substrate="hierarchy")

    def eligible(self, n, dtype, run_len=None):
        # a single run degenerates to "sort one tile and merge nothing"
        if run_len is not None and n <= run_len:
            return False
        return super().eligible(n, dtype, run_len)

    def _plan(self, rows, plan):
        if plan is not None:
            return plan
        from repro_torch.engine import planner
        return planner.choose_cached(rows.shape[-1], rows.shape[0],
                                     rows.dtype, requested="merge",
                                     device=rows.device)

    def sort(self, rows, *, descending=False, plan=None):
        from repro_torch import engine
        return engine.merge_sort_rows(rows, descending=descending,
                                      plan=self._plan(rows, plan))

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        from repro_torch import engine
        return engine.merge_sort_rows_kv(keys, values, descending=descending,
                                         plan=self._plan(keys, plan))


# ---------------------------------------------------------------------------
# radix — digit-serial LSD radix sort over encoded keys
# ---------------------------------------------------------------------------

@register_backend
class RadixBackend(SortBackend):
    """Stable LSD radix sort (K3) through the key codec; ``descending``
    complements the encoded key, so ties keep ascending index order both
    ways."""
    name = "radix"
    capabilities = Capabilities(dtypes=frozenset(_keycodec.SUPPORTED),
                                stable=True, substrate="cuda")

    def sort(self, rows, *, descending=False, plan=None):
        return self.sort_kv(rows, None, descending=descending)[0]

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        from repro_torch.kernels import radix_sort as _rs
        from repro_torch.obs import trace as _obs
        self.check_dtype(keys.dtype)
        if values is not None and values.dtype != torch.int32:
            # the kernels carry int32 payloads; a stable sort's order is its
            # index order, so an index payload and a gather give the same
            return _gather_kv(keys, values,
                              self.argsort(keys, descending=descending))
        n = keys.shape[-1]
        passes, tiles = _rs.pass_tile_counts(n, keys.dtype)
        with _obs.trace("radix.sort_kv", n=n, passes=passes,
                        tiles=tiles) as sp:
            enc = _keycodec.encode(keys, descending=descending)
            sk, sv = _rs.sort_kv_blocks(enc, values)
            sk = _keycodec.decode(sk, keys.dtype, descending=descending)
            sp.fence((sk, sv))
        return sk, sv


# ---------------------------------------------------------------------------
# select — MSD radix select, the O(n) partial-sort mode
# ---------------------------------------------------------------------------

@register_backend
class SelectBackend(SortBackend):
    """MSD radix select (K4, ``kernels/radix_select.py``): top-k from
    digit histograms and a threshold refinement, never a sort of the row.
    Selection-only (``supports_sort=False``); the planner prices its top-k
    with ``cost_model.selection_cost_ns`` and ``auto`` takes it from
    ``select_min_n`` up where it is the cheapest.  Exact-k with
    ``lax.top_k``'s rule: ties keep ascending index, +0.0 above -0.0."""
    name = "select"
    capabilities = Capabilities(dtypes=frozenset(_keycodec.SUPPORTED),
                                stable=False, supports_kv=False,
                                supports_segments=False, supports_sort=False,
                                selection=True, substrate="cuda")

    def topk(self, rows, k, *, plan=None):
        from repro_torch.kernels import radix_select as _sel
        from repro_torch.obs import trace as _obs
        self.check_dtype(rows.dtype)
        n = rows.shape[-1]
        passes, tiles = _sel.pass_tile_counts(n, rows.dtype)
        with _obs.trace("select.topk", n=n, k=k, passes=passes,
                        tiles=tiles) as sp:
            out = _sel.select_topk(rows, k)
            sp.fence(out)
        return out
