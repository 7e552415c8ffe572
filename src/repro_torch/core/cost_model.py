"""Cost models: the paper's SRAM unit, and what ``planner.choose`` prices
the backends with.

* **The paper's model** (Tables I/II, Fig. 8): cycles, latency and
  throughput of the N-input, W-bit in-memory sorting unit, and
  ``validate_claims``.  Its constants are the paper's published 65 nm 6T
  SRAM numbers — a model of that macro, not a measurement of any chip,
  and no statement about the CUDA card.  The per-cycle simulator
  (``gates``/``sorter``) validates functional correctness and total cycle
  counts; this module owns the quoted latency/throughput/ratio numbers.
* **The device model**: the part of the JAX package's cost model the
  single-device planner needs: closed-form ns estimates per sort backend,
  for top-k (selection, K5's one pass, the torch backend's top-k off the
  card), for the relational ops (a sort plus O(n) post-passes) and for
  the spill tier (chunk sorts, the host link, the host merge), with fixed
  asymptotics and leading constants from the active tuning profile: the
  JAX package's seeds (``core/tuning.py``) until ``planner.calibrate``
  measures them on the running device.
* **The distributed model**: mesh sorts (odd-even, flat sample sort, the
  two-level sample sort) priced by their exchanges over the profile's
  link constants or a ``Topology``'s measured rates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import cas, network
from repro_torch.core import tuning as _tuning
from repro_torch.core.tuning import DeviceSortConstants

# ---- paper constants (§III, Table I/II) -------------------------------------
# The paper's 65 nm SRAM model, as published: no number here was measured.
CYCLE_NS = 0.55                      # latency of one IMC operation, 65 nm
OPERATING_FREQ_GHZ = 1 / CYCLE_NS    # 1.81 GHz (Table II)

TABLE1_CAS_OPS: Dict[str, int] = {"NOR": 14, "NOT": 8, "AND": 3, "COPY": 3}
CAS_CYCLES_W4 = sum(TABLE1_CAS_OPS.values())            # 28

# Fig. 8 anchors (ratios as published): the paper does not reprint MemSort's
# ([7]) raw tables, so that baseline is anchored to the reported ratios
MEMSORT_CYCLE_RATIO = 1.45           # Fig. 8(a): cycles(MemSort)/cycles(ours)
MEMSORT_LATENCY_RATIO = 3.4          # Fig. 8(b)
OFF_MEMORY_LATENCY_RATIO = 5.0       # §III text


def cas_cycles(width: int = 4) -> int:
    """Cycles for one CAS block: the gate program's length.  W=4 is the
    paper's 28 (``CAS_CYCLES_W4``, checked by ``validate_claims``); other
    widths extrapolate the reconstructed program."""
    return cas.cached_program(width).total_cycles


def sort_cycles(n: int, width: int = 4) -> int:
    """Total cycles to sort N unsigned W-bit values in-memory.

    stages x CAS + movement (Eq. 3-4 with the paper's fused-first-exchange
    accounting).  N=8, W=4 -> 6*28 + 24 = 192 (§III / Table I).
    """
    stages = network.n_stages(n)
    movement = network.total_extra_cycles(n)
    return stages * cas_cycles(width) + movement


def sort_latency_ns(n: int, width: int = 4) -> float:
    """N=8, W=4 -> 105.6 ns (Table II)."""
    return sort_cycles(n, width) * CYCLE_NS


def throughput_gops(n: int, width: int = 4) -> float:
    """IMC operations per second; Table II reports 1.8 GOPS for N=8, W=4
    (one op per 0.55 ns cycle)."""
    return sort_cycles(n, width) / sort_latency_ns(n, width)


def stage_op_totals(n: int = 8) -> Dict[str, int]:
    """Table I right column: per-op totals for the complete N-input unit.

    Movement cycles are COPY-class (temp-row transfers): for N=8 the paper
    reports COPY 42 = 6 stages * 3 + 24 movement cycles.
    """
    stages = network.n_stages(n)
    totals = {k: v * stages for k, v in TABLE1_CAS_OPS.items()}
    totals["COPY"] += network.total_extra_cycles(n)
    return totals


# ---- comparison baselines (Fig. 8) ------------------------------------------

def memsort_cycles(n: int = 8, width: int = 4) -> float:
    return sort_cycles(n, width) * MEMSORT_CYCLE_RATIO


def memsort_latency_ns(n: int = 8, width: int = 4) -> float:
    return sort_latency_ns(n, width) * MEMSORT_LATENCY_RATIO


def off_memory_latency_ns(n: int = 8, width: int = 4) -> float:
    return sort_latency_ns(n, width) * OFF_MEMORY_LATENCY_RATIO


def bubble_sort_comparisons(n: int = 8) -> int:
    """Software baseline the paper uses (8-bit masked to 4-bit, bubble sort):
    worst-case compare-swap count."""
    return n * (n - 1) // 2


def memory_bits(n: int = 8, width: int = 4) -> int:
    """Fig. 8(c): array bits used, with CAS-row reuse (22-row array)."""
    from repro_torch.core import sorter
    return sorter.array_geometry(n, width)["bits"]


@dataclasses.dataclass(frozen=True)
class PaperClaims:
    """Every quantitative claim we validate, with model + paper values."""
    rows: tuple

    def all_pass(self) -> bool:
        return all(abs(m - p) <= tol for (_, m, p, tol) in self.rows)


def validate_claims() -> PaperClaims:
    rows = (
        ("Eq1 N_CAS(8)", network.n_cas_blocks(8), 24, 0),
        ("Eq2 N_stages(8)", network.n_stages(8), 6, 0),
        ("Eq3 temp rows(8)", network.n_temp_rows(8), 2, 0),
        ("Eq4 movement cycles per exchange(8)", network.movement_cycles(8), 6, 0),
        ("CAS cycles (W=4)", cas_cycles(4), 28, 0),
        ("reconstructed CAS program cycles (W=4)",
         cas.cached_program(4).total_cycles, 28, 0),
        ("total movement cycles (N=8)", network.total_extra_cycles(8), 24, 0),
        ("sort cycles (N=8, W=4)", sort_cycles(8), 192, 0),
        ("Table I NOR total (N=8)", stage_op_totals(8)["NOR"], 84, 0),
        ("Table I NOT total (N=8)", stage_op_totals(8)["NOT"], 48, 0),
        ("Table I AND total (N=8)", stage_op_totals(8)["AND"], 18, 0),
        ("Table I COPY total (N=8)", stage_op_totals(8)["COPY"], 42, 0),
        ("Table II latency ns", sort_latency_ns(8), 105.6, 1e-9),
        ("Table II throughput GOPS", throughput_gops(8), 1.8, 0.02),
        ("Table II frequency GHz", OPERATING_FREQ_GHZ, 1.81, 0.01),
        ("array geometry rows (W=4)", cas.cached_program(4).n_rows, 22, 0),
        ("Fig8a MemSort cycle ratio", memsort_cycles(8) / sort_cycles(8), 1.45, 1e-12),
        ("Fig8b MemSort latency ratio",
         memsort_latency_ns(8) / sort_latency_ns(8), 3.4, 1e-12),
        ("off-memory latency ratio",
         off_memory_latency_ns(8) / sort_latency_ns(8), 5.0, 1e-12),
    )
    return PaperClaims(rows=rows)


# ---- device-level cost model (engine auto-dispatch) --------------------------


def _radix_digit_bits(digit_bits: Optional[int]) -> int:
    return digit_bits if digit_bits is not None \
        else _tuning.active().digit_bits


def _log2(v: float) -> float:
    return math.log2(max(2.0, v))


def device_sort_cost_ns(method: str, n: int, batch: int = 1, *,
                        run_len: Optional[int] = None,
                        consts: Optional[DeviceSortConstants] = None,
                        plain: bool = False,
                        key_bits: int = 32) -> float:
    """Estimated ns to sort ``batch`` rows of ``n`` with one backend.

    ``n`` is priced at the padded size each backend executes (``radix``
    pads nothing: K3 runs fixed tiles and ends a row's last, partial one
    inside the kernel, and its plain pass pads nothing either).  ``plain``
    says the tensor lies on the CPU: the kernel backends (``cuda``,
    ``radix``) would run their plain versions and pay
    ``cuda_plain_penalty``, and ``torch`` is the comparison sort the
    reference prices (c * n log2 n).  Off ``plain``, ``torch`` is priced
    as what ``torch.sort`` runs on the card, a radix sort (``torch_card``
    a key and 8-bit pass).  ``key_bits`` is the encoded key width; only
    the radix pass counts depend on it.
    """
    prof = _tuning.active()
    c = consts or prof.constants
    m = 1 << max(0, (n - 1).bit_length())
    pen = c.cuda_plain_penalty if plain else 1.0
    if method == "torch":
        if not plain:
            # on the card torch.sort is a radix sort of 8-bit digits
            return c.torch_card * batch * n * -(-key_bits // 8)
        return c.torch * batch * n * _log2(n)
    if method == "bitonic":
        return c.bitonic * batch * m * _log2(m) ** 2
    if method == "cuda":
        return pen * c.cuda * batch * m * _log2(m) ** 2
    if method == "radix":
        passes = -(-key_bits // prof.digit_bits)
        return pen * c.radix * batch * n * passes
    if method == "merge":
        run_len = min(run_len if run_len is not None else prof.run_len, m)
        tiles = 1 << max(0, (-(-n // run_len) - 1).bit_length())
        padded = tiles * run_len
        gen = c.merge_run * batch * padded * _log2(run_len)
        levels = _log2(tiles) if tiles > 1 else 0.0
        return gen + c.merge_level * batch * padded * levels
    raise ValueError(f"no device cost model for method {method!r}")


def cuda_topk_cost_ns(n: int, k: int, batch: int = 1, *,
                      consts: Optional[DeviceSortConstants] = None,
                      plain: bool = False) -> float:
    """Estimated ns for the ``cuda`` backend's top-k of ``(batch, n)``
    rows as K5 runs it: for ``k <= 256`` one pass that reads each row once
    and keeps a k-buffer per stream (priced as the row plus a bitonic
    merge of k, at the ``cuda`` network constant); past 256 the network
    route sorts each row's chunks, priced as the sort (sort-prefix).
    ``plain`` pays ``cuda_plain_penalty`` (a CPU tensor)."""
    from repro_torch.kernels.bitonic_topk import MAX_K
    if k > MAX_K:
        return device_sort_cost_ns("cuda", n, batch, consts=consts,
                                   plain=plain)
    c = consts or _tuning.active().constants
    pen = c.cuda_plain_penalty if plain else 1.0
    return pen * c.cuda * batch * (n + k * _log2(k) ** 2)


def native_topk_cost_ns(n: int, k: int, batch: int = 1, *,
                        consts: Optional[DeviceSortConstants] = None
                        ) -> float:
    """Estimated ns for the ``torch`` backend's top-k off the card: one
    O(n) selection pass (``torch.topk`` over the total-order key) plus
    the O(k log k) ordering of the survivors — the JAX package's native
    ``lax.top_k`` price off the TPU.  On the card the backend keeps the
    sort-prefix price, as the reference keeps it on the TPU."""
    c = consts or _tuning.active().constants
    return c.torch_topk * batch * n + c.torch * batch * k * _log2(k)


def selection_cost_ns(n: int, k: int, key_bits: int = 32, batch: int = 1, *,
                      consts: Optional[DeviceSortConstants] = None,
                      digit_bits: Optional[int] = None) -> float:
    """Estimated ns for an exact top-k *selection* of ``(batch, n)`` rows:
    ``ceil(b/digit_bits)`` MSD digit-refinement passes of O(n) counting
    over the row (K4's grid strides over the keys and pads nothing), plus
    the O(k log k) ordering of the k survivors (priced as a ``torch`` sort
    of k)."""
    c = consts or _tuning.active().constants
    passes = -(-key_bits // _radix_digit_bits(digit_bits))
    return c.select * batch * n * passes + c.torch * batch * k * _log2(k)


def bytes_moved(method: str, n: int, itemsize: int = 4, *,
                key_bits: int = 32, k: Optional[int] = None,
                run_len: Optional[int] = None,
                digit_bits: Optional[int] = None,
                plain: bool = False) -> int:
    """Analytic bytes one backend moves through device memory sorting
    ``n`` elements of ``itemsize`` bytes (with ``k``: taking their top k):
    the paper's data-movement accounting (Tables I/II count temp-row COPY
    cycles; this counts the software analogue, the element reads and
    writes that leave the compute unit's resident tile).

    The JAX package's formulas under the port's names: the merge family
    (``merge``, and ``torch`` as a comparison sort) moves every element
    once a level, ~log2 n levels; ``bitonic`` once a substage; ``cuda``
    once in and once out (K1 holds a row in registers and shared memory,
    as the reference's VMEM tile); ``radix`` once a digit pass;
    ``select``'s counting passes read only, then write k values and k
    indices; ``torch``'s top-k is one scan and the k pairs; every other
    top-k is its sort plus a read of the k-prefix.

    ``plain`` says the tensor lies on the CPU, where every method moves
    what the reference's does.  On the card two methods move what the
    port's pricing says they run (``device_sort_cost_ns`` and
    ``cuda_topk_cost_ns``): a ``torch`` sort is ``torch.sort``'s radix
    sort of 8-bit digits, each pass a read and a write of every element
    (``2 n s ceil(key_bits / 8)``); and a ``cuda`` top-k with
    ``k <= kernels.bitonic_topk.MAX_K`` is K5's one pass, a read of the
    row and the k pairs written (``n s + 2 k s``), not a sort.  Methods
    the model does not know (``imc``, ``distributed``, ``spill``) raise
    ``ValueError``.
    """
    passes = -(-key_bits // _radix_digit_bits(digit_bits))
    if k is not None:
        from repro_torch.kernels.bitonic_topk import MAX_K
        if method == "select":
            return n * itemsize * passes + 2 * k * itemsize
        if method == "torch" or (method == "cuda" and not plain
                                 and k <= MAX_K):
            return n * itemsize + 2 * k * itemsize      # one scan, k pairs
        return bytes_moved(method, n, itemsize, key_bits=key_bits,
                           run_len=run_len, digit_bits=digit_bits,
                           plain=plain) + k * itemsize
    lvl = _log2(n)
    if method == "torch" and not plain:
        return 2 * n * itemsize * -(-key_bits // 8)
    if method in ("torch", "merge"):
        return int(2 * n * itemsize * lvl)
    if method == "bitonic":
        return int(2 * n * itemsize * lvl * lvl)
    if method == "cuda":
        return 2 * n * itemsize
    if method == "radix":
        return 2 * n * itemsize * passes
    raise ValueError(f"no bytes-moved model for method {method!r}")


# ---- relational ops (repro_torch.relational auto-dispatch) -------------------
#
# Every relational op is priced as (sort backbone) + (O(n) post-pass), as in
# the JAX package: the post-pass is a handful of elementwise / searchsorted
# sweeps over the sorted column, priced at the one-merge-level constant
# (``merge_level``, one O(n) gather-bound pass) times a per-op pass count.
# No new profile field: relational plans reuse the sort constants.

REL_POST_PASSES: Dict[str, float] = {
    "unique": 3.0,     # boundary mask + compaction search + pad
    "group_by": 4.0,   # boundary + compaction + segment reduce (per agg ~1)
    "join": 6.0,       # 2x searchsorted runs + offset scan + pair expansion
    "rle": 3.0,        # boundary + compaction + segment lengths
    "delta": 1.0,      # one adjacent-diff sweep
}

# ops that sort more than one column (join sorts both sides)
REL_SORT_COLUMNS: Dict[str, float] = {"join": 2.0}


def relational_cost_ns(op: str, method: str, n: int, batch: int = 1, *,
                       run_len: Optional[int] = None, key_bits: int = 32,
                       consts: Optional[DeviceSortConstants] = None,
                       plain: bool = False) -> float:
    """Estimated ns for relational ``op`` over an ``n``-element column with
    its sort backbone on ``method``.

    ``planner.choose_relational`` prices every auto candidate with this,
    passing the stable merge pipeline in place of a non-stable backend on
    the order-sensitive ops, since that is what the engine runs for them.
    The sketches are priced too (quantile at the selection model's median
    contract, histogram at one binary-search sweep), though they take no
    backend.  ``plain`` is ``device_sort_cost_ns``'s: the kernel backends
    on a CPU tensor."""
    c = consts or _tuning.active().constants
    if op == "quantile":
        return selection_cost_ns(n, max(1, n // 2), key_bits, batch,
                                 consts=c)
    if op == "histogram":
        # one searchsorted sweep over the edges + a bincount scatter
        return c.torch * batch * n * _log2(n)
    if op not in REL_POST_PASSES:
        raise ValueError(f"no relational cost model for op {op!r}")
    sort_ns = device_sort_cost_ns(method, n, batch, run_len=run_len,
                                  consts=c, plain=plain, key_bits=key_bits)
    post = c.merge_level * batch * n * REL_POST_PASSES[op]
    return REL_SORT_COLUMNS.get(op, 1.0) * sort_ns + post


# ---- out-of-core spill tier ---------------------------------------------------

def spill_sort_cost_ns(n: int, batch: int = 1, itemsize: int = 4, *,
                       chunk_bytes: Optional[int] = None,
                       key_bits: int = 32, overlap: bool = True,
                       consts: Optional[DeviceSortConstants] = None,
                       plain: bool = False) -> float:
    """Estimated ns for the spill tier (``repro_torch.engine.spill``) over
    ``batch`` rows of ``n`` keys: the JAX package's three terms.

      chunk sorts   ceil(total/chunk) device sorts at the chunk size,
                    priced as ``torch`` sorts (``plain``: on the CPU)
      link          every key crosses the host link four times (chunk
                    H2D, run D2H, merge-block H2D, merged D2H) at
                    ``pcie_per_byte``; with overlap the spill phase pays
                    max(sorts, its transfers), else their sum
      host merge    log2(chunks) levels at ``host_merge_level`` a key

    ``chunk_bytes`` defaults to the profile's ``spill_threshold_bytes``,
    the same knob the planner routes on."""
    prof = _tuning.active()
    c = consts or prof.constants
    cb = chunk_bytes if chunk_bytes is not None \
        else prof.spill_threshold_bytes
    chunk = max(1, cb // max(1, itemsize))
    total = n * batch
    n_chunks = max(1, -(-total // chunk))
    per_chunk = device_sort_cost_ns("torch", min(chunk, total), consts=c,
                                    key_bits=key_bits, plain=plain)
    sort_ns = n_chunks * per_chunk
    spill_xfer = 2.0 * total * itemsize * c.pcie_per_byte
    merge_xfer = 2.0 * total * itemsize * c.pcie_per_byte
    pipeline = max(sort_ns, spill_xfer) if overlap else sort_ns + spill_xfer
    levels = _log2(n_chunks) if n_chunks > 1 else 0.0
    return pipeline + merge_xfer + c.host_merge_level * total * levels


# ---- distributed tier (mesh sorts) --------------------------------------------
#
# The JAX package's cluster-scale model (its Eq. 3-4 term: operand
# movement priced per exchange).  The comparison-sort and merge constants
# are the device model's; the link rates come from the profile's ``links``
# (``collective_*`` for NVLink, ``network_*`` between nodes) unless a
# ``Topology`` axis's measured rates are passed in.

def collective_cost_ns(n_dev: int, m: int, itemsize: int,
                       links: Optional[_tuning.LinkConstants] = None, *,
                       alpha: Optional[float] = None,
                       per_byte: Optional[float] = None) -> float:
    """Estimated ns of ONE exchange round in which every entry exchanges
    ``n_dev`` shards of ``m`` elements: ``n_dev=1`` prices a neighbour
    exchange (odd-even pays D of these), ``n_dev=D`` a capacity-padded
    all-to-all (the sample sort pays two).  ``alpha``/``per_byte``
    override the link rates (the two-tier hook)."""
    lk = links or _tuning.active().links
    a = alpha if alpha is not None else lk.collective_alpha
    b = per_byte if per_byte is not None else lk.collective_per_byte
    return a + b * n_dev * m * itemsize


def flat_collective_rates(inner: int, outer: int, *,
                          links: Optional[_tuning.LinkConstants] = None,
                          ici_alpha: Optional[float] = None,
                          ici_per_byte: Optional[float] = None,
                          dcn_alpha: Optional[float] = None,
                          dcn_per_byte: Optional[float] = None
                          ) -> Tuple[float, float]:
    """(alpha, per_byte) a FLAT all-to-all pays on an ``outer x inner``
    mesh: a fraction ``(outer-1)/outer`` of every entry's bytes crosses
    the slow outer tier, the rest the fast inner one, and the round waits
    for the slower launch.  ``outer <= 1`` is the inner tier alone.  The
    keyword names are the JAX package's (``ici`` the inner tier, ``dcn``
    the outer)."""
    lk = links or _tuning.active().links
    ia = ici_alpha if ici_alpha is not None else lk.collective_alpha
    ib = ici_per_byte if ici_per_byte is not None else lk.collective_per_byte
    da = dcn_alpha if dcn_alpha is not None else lk.network_alpha
    db = dcn_per_byte if dcn_per_byte is not None else lk.network_per_byte
    if outer <= 1:
        return ia, ib
    f_dcn = (outer - 1) / outer
    return max(ia, da), ib * (1.0 - f_dcn) + db * f_dcn


def distributed_sort_cost_ns(strategy: str, n: int, n_dev: int,
                             itemsize: int = 4, *,
                             consts: Optional[DeviceSortConstants] = None,
                             links: Optional[_tuning.LinkConstants] = None,
                             alpha: Optional[float] = None,
                             per_byte: Optional[float] = None) -> float:
    """Estimated ns to sort ``n`` keys over ``n_dev`` entries.  Both
    strategies pay the same local shard sort:

      oddeven   D rounds x (one shard exchange + a 2m bitonic merge box)
      sample    2 all-to-alls + one merge tree over the received runs
    """
    c = consts or _tuning.active().constants
    m = -(-n // n_dev)
    local = c.torch * m * _log2(m)
    if strategy == "oddeven":
        round_merge = c.bitonic * (2 * m) * _log2(2 * m)
        return local + n_dev * (
            collective_cost_ns(1, m, itemsize, links,
                               alpha=alpha, per_byte=per_byte)
            + round_merge)
    if strategy == "sample":
        # r*m*log r: the capacity-padded exchange staging and the merge
        # tree over the received runs; + m the rebalance (the JAX
        # package's fitted form)
        r = 1 << max(0, (n_dev - 1).bit_length())
        merge = c.merge_level * ((r * m) * (_log2(r) if r > 1 else 0.0) + m)
        return local + 2 * collective_cost_ns(n_dev, m, itemsize, links,
                                              alpha=alpha,
                                              per_byte=per_byte) + merge
    raise ValueError(
        f"no distributed cost model for strategy {strategy!r}")


def hierarchical_sort_cost_ns(n: int, inner: int, outer: int,
                              itemsize: int = 4, *,
                              consts: Optional[DeviceSortConstants] = None,
                              links: Optional[_tuning.LinkConstants] = None,
                              ici_alpha: Optional[float] = None,
                              ici_per_byte: Optional[float] = None,
                              dcn_alpha: Optional[float] = None,
                              dcn_per_byte: Optional[float] = None) -> float:
    """Estimated ns of the two-level sample sort over ``outer x inner``:
    the flat path's local sort and merge aggregate, three inner-tier
    all-to-alls (opening, intra-node rebalance, finalize), one outer-tier
    bucket all-to-all, and the global rebalance (inner-tier volume plus
    an O(m) outer-tier spill)."""
    c = consts or _tuning.active().constants
    lk = links or _tuning.active().links
    ia = ici_alpha if ici_alpha is not None else lk.collective_alpha
    ib = ici_per_byte if ici_per_byte is not None else lk.collective_per_byte
    da = dcn_alpha if dcn_alpha is not None else lk.network_alpha
    db = dcn_per_byte if dcn_per_byte is not None else lk.network_per_byte
    d = max(1, inner) * max(1, outer)
    m = -(-n // d)
    local = c.torch * m * _log2(m)
    r = 1 << max(0, (d - 1).bit_length())
    merge = c.merge_level * ((r * m) * (_log2(r) if r > 1 else 0.0) + m)
    intra = 3 * collective_cost_ns(inner, m, itemsize, lk,
                                   alpha=ia, per_byte=ib)
    inter = collective_cost_ns(outer, m, itemsize, lk,
                               alpha=da, per_byte=db)
    rebalance = max(ia, da) + ib * d * m * itemsize + db * m * itemsize
    return local + merge + intra + inter + rebalance
