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
  for top-k selection and for the relational ops (a sort plus O(n)
  post-passes), with fixed asymptotics and leading constants
  from the active tuning profile.  The constants are the JAX package's
  default seeds (``core/tuning.py``), not measurements on a CUDA card;
  they order candidates, they do not predict times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

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
    says the kernel backends (``cuda``, ``radix``) would run their plain
    versions (a CPU tensor) and pays ``cuda_plain_penalty``.  ``key_bits``
    is the encoded key width; only the radix pass count depends on it.
    """
    prof = _tuning.active()
    c = consts or prof.constants
    m = 1 << max(0, (n - 1).bit_length())
    pen = c.cuda_plain_penalty if plain else 1.0
    if method == "torch":
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


def selection_cost_ns(n: int, k: int, key_bits: int = 32, batch: int = 1, *,
                      consts: Optional[DeviceSortConstants] = None,
                      digit_bits: Optional[int] = None) -> float:
    """Estimated ns for an exact top-k *selection* of ``(batch, n)`` rows:
    ``ceil(b/digit_bits)`` MSD digit-refinement passes of O(n) counting
    over the row (K4's grid strides over the keys and pads nothing), plus
    the O(k log k) ordering of the k survivors (priced as a ``torch`` sort
    of k)."""
    prof = _tuning.active()
    c = consts or prof.constants
    digit_bits = prof.digit_bits if digit_bits is None else digit_bits
    passes = -(-key_bits // digit_bits)
    return c.select * batch * n * passes + c.torch * batch * k * _log2(k)


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
