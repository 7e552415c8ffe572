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


def _gather_bits(t, order):
    """``t.gather(-1, order)`` through the bits of float tensors: torch's
    CPU gather of float16 rows quiets a signalling NaN."""
    if t.is_floating_point():
        carrier = _keycodec.key_dtype(t.dtype)
        return t.view(carrier).gather(-1, order).view(t.dtype)
    return t.gather(-1, order)


def _gather_kv(keys, values, order):
    """(sorted keys, permuted payload) from an argsort permutation.  The
    network backends sort (key, index) and gather both sides: an arbitrary
    payload could tie or exceed the pad marker of the network."""
    order = order.to(torch.int64)
    return _gather_bits(keys, order), _gather_bits(values, order)


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
    * ``topk`` ranks on the IEEE total order (``lax.top_k`` ranks +0.0
      above -0.0) and takes the lower index first among equal keys: one
      ``torch.topk`` pass over the total-order key finds the k-th key (its
      own tie order is never used), the keys above it and the first equal
      ones in index order are kept, and only those k are sorted.  Off the
      card it is priced as that O(n) selection
      (``cost_model.native_topk_cost_ns``), as the reference prices
      ``lax.top_k`` off the TPU; on the card at sort-prefix.
    """
    name = "torch"
    capabilities = Capabilities(dtypes=None, stable=True, substrate="host")

    def topk_cost_ns(self, n, k, batch, dtype, *, run_len, consts=None,
                     plain=False):
        if not plain:
            return super().topk_cost_ns(n, k, batch, dtype, run_len=run_len,
                                        consts=consts, plain=plain)
        from repro_torch.core import cost_model
        return cost_model.native_topk_cost_ns(n, k, batch, consts=consts)

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
        if rows.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the 'torch' backend's top-k reads its row counts back to "
                "the host (nonzero) and cannot run inside a CUDA graph "
                "capture; plan 'cuda' (K5) or 'select' (K4) for a "
                "captured step")
        key = _keycodec.total_order_key(rows)
        kth = torch.topk(key, k, dim=-1, sorted=False).values \
            .amin(-1, keepdim=True)
        above = key > kth
        tie = key == kth
        room = k - above.sum(-1, keepdim=True)
        take = above | (tie & (tie.cumsum(-1) <= room))
        # exactly k a row, in ascending index order
        idx = take.nonzero()[:, 1].view(rows.shape[0], k)
        order = torch.sort(key.gather(-1, idx), dim=-1, stable=True,
                           descending=True).indices
        idx = idx.gather(-1, order)
        return rows.gather(-1, idx), idx.to(torch.int32)


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

    def topk(self, rows, k, *, plan=None):
        """Sort-prefix; on rows that require grad the values are gathered
        from the rows by index (the same values, and the gradient the
        reference's differentiable network gives)."""
        v, i = super().topk(rows, k, plan=plan)
        if rows.requires_grad:
            v = rows.gather(-1, i.to(torch.int64))
        return v, i


# ---------------------------------------------------------------------------
# cuda — the whole row in shared memory (the JAX package's ``pallas``)
# ---------------------------------------------------------------------------

@register_backend
class CudaBackend(SortBackend):
    """K1 through ``kernels/ops.py``: the key-value kernel with an index
    payload, then a gather.  Top-k is K5 per row: for k <= 256 its one
    pass over rows of any length, which ``auto`` may pick at any n
    (``topk_eligible``); past 256 the network per 2048-key chunk and an
    ordering of the candidates, capped by ``max_n`` as a sort is.  Keys compare
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

    def topk_eligible(self, n, k, dtype, run_len=None):
        """K5's one pass takes rows of any length for k <= 256; past it
        the network route is capped as a sort is."""
        from repro_torch.kernels.bitonic_topk import MAX_K
        if k <= MAX_K:
            return _keycodec.dtype_name(dtype) in self.capabilities.dtypes
        return self.eligible(n, dtype, run_len)

    def topk_cost_ns(self, n, k, batch, dtype, *, run_len, consts=None,
                     plain=False):
        """K5's price: one pass for k <= 256, the sort past it."""
        from repro_torch.core import cost_model
        return cost_model.cuda_topk_cost_ns(n, k, batch, consts=consts,
                                            plain=plain)

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


# ---------------------------------------------------------------------------
# distributed — mesh-global sorting (sample sort, odd-even, two-level)
# ---------------------------------------------------------------------------

@register_backend
class DistributedBackend(SortBackend):
    """Mesh-global sorting behind the registry: the sample sort
    (``engine/samplesort.py``: flat, or the two-level schedule on a
    two-axis mesh) with odd-even transposition for small single-axis
    sorts, the strategy priced by ``planner.choose_distributed`` against
    the active ``core.topology``.

    The natural entry is a spec with mesh fields (``SortSpec(mesh=...)``
    through ``repro_torch.sort``), which lands on :meth:`sort_mesh`,
    :meth:`argsort_mesh` or :meth:`topk_mesh`.  The rows form sorts each
    row over the host mesh of the rows' device: every card of the machine
    (``launch.mesh.make_host_mesh``) for a CUDA tensor, one CPU entry
    otherwise.  Never auto-dispatched by the single-device planner.
    Stable: the port's sample sort keeps ties in index order."""
    name = "distributed"
    capabilities = Capabilities(dtypes=frozenset(_keycodec.SUPPORTED),
                                stable=True, supports_segments=False,
                                selection=True, auto_dispatch=False,
                                substrate="mesh")

    @staticmethod
    def _host_mesh(device):
        from repro_torch.core.mesh import make_mesh
        if torch.device(device).type == "cuda":
            from repro_torch.launch.mesh import make_host_mesh
            return make_host_mesh()
        return make_mesh((1,), ("data",), "cpu")

    # -- mesh execution (what SortSpec.mesh routes to) ---------------------
    def sort_mesh(self, x, mesh, axis_name, *, values=None,
                  descending=False, local_method=None):
        from repro_torch.core import distributed_sort as _ds
        return _ds.distributed_sort(x, mesh, axis_name,
                                    local_method=local_method,
                                    strategy="auto", descending=descending,
                                    values=values)

    def argsort_mesh(self, x, mesh, axis_name, *, descending=False,
                     local_method=None):
        """The stable permutation of a mesh-global sort (int32 global
        positions, ties in ascending index order in both directions)."""
        from repro_torch.core import distributed_sort as _ds
        return _ds.distributed_sort(x, mesh, axis_name,
                                    local_method=local_method,
                                    strategy="auto", descending=descending,
                                    return_indices=True)[1]

    def topk_mesh(self, x, k, mesh, axis_name):
        """Mesh-global top-k: local radix select a shard, ONE candidate
        all-gather, a small merge; no full sort."""
        from repro_torch.core import distributed_sort as _ds
        return _ds.distributed_topk(x, k, mesh, axis_name)

    # -- rows form ---------------------------------------------------------
    def sort(self, rows, *, descending=False, plan=None):
        from repro_torch.engine import samplesort
        self.check_dtype(rows.dtype)
        mesh = self._host_mesh(rows.device)
        return torch.stack([
            samplesort.sample_sort(r, mesh, "data", descending=descending)
            .to(rows.device) for r in rows])

    def sort_kv(self, keys, values, *, descending=False, plan=None):
        from repro_torch.engine import samplesort
        self.check_dtype(keys.dtype)
        mesh = self._host_mesh(keys.device)
        outs = [samplesort.sample_sort(k, mesh, "data", values=v,
                                       descending=descending)
                for k, v in zip(keys, values)]
        return (torch.stack([k.to(keys.device) for k, _ in outs]),
                torch.stack([v.to(keys.device) for _, v in outs]))

    def argsort(self, rows, *, descending=False, plan=None):
        from repro_torch.engine import samplesort
        self.check_dtype(rows.dtype)
        mesh = self._host_mesh(rows.device)
        return torch.stack([
            samplesort.sample_sort(r, mesh, "data", descending=descending,
                                   return_indices=True)[1].to(rows.device)
            for r in rows])

    def topk(self, rows, k, *, plan=None):
        from repro_torch.engine import samplesort
        self.check_dtype(rows.dtype)
        mesh = self._host_mesh(rows.device)
        outs = [samplesort.sample_topk(r, k, mesh, "data") for r in rows]
        return (torch.stack([v.to(rows.device) for v, _ in outs]),
                torch.stack([i.to(rows.device) for _, i in outs]))


# ---------------------------------------------------------------------------
# spill — out-of-core: chunked device sorts + host k-way merge
# ---------------------------------------------------------------------------

@register_backend
class SpillBackend(SortBackend):
    """The spill-to-host tier (``repro_torch.engine.spill``): chunks of
    ``spill_threshold_bytes`` sorted on the device through the engine,
    their runs streamed to host memory, and a k-way merge-path over the
    host runs, block by block on the device.

    Never auto-priced (``auto_dispatch=False``): the planner routes to it
    by feasibility — key bytes above the profile's threshold spill,
    nothing below does.  Host-driven (blocking waits, data-dependent
    cursors): while a CUDA graph is being captured the engine falls back
    to the merge pipeline.  Stable (stable chunk sorts, run-index ties in
    both merges); no top-k or segmented path.  Results are CPU tensors:
    the sorted array does not fit the card.  bfloat16 rides the pipeline
    as its order-embedding code, so every comparable dtype is honest."""
    name = "spill"
    capabilities = Capabilities(dtypes=COMPARABLE_DTYPES, stable=True,
                                supports_kv=True, supports_topk=False,
                                supports_segments=False, auto_dispatch=False,
                                substrate="host")

    def sort(self, rows, *, descending=False, plan=None, device=None):
        from repro_torch.engine import spill
        self.check_dtype(rows.dtype)
        return spill.sort_rows(rows, descending=descending,
                               device=device or rows.device)

    def sort_kv(self, keys, values, *, descending=False, plan=None,
                device=None):
        from repro_torch.engine import spill
        self.check_dtype(keys.dtype)
        return spill.sort_rows_kv(keys, values, descending=descending,
                                  device=device or keys.device)

    def argsort(self, rows, *, descending=False, plan=None, device=None):
        from repro_torch.engine import spill
        self.check_dtype(rows.dtype)
        return spill.argsort_rows(rows, descending=descending,
                                  device=device or rows.device)
