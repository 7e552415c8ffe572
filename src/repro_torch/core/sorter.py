"""Complete in-memory binary sorting unit (paper §II-B).

The N-input sorter maps the Batcher bitonic network onto N/2 memory
partitions (FELIX-style partitioning): every stage executes its N/2 CAS
blocks *concurrently*, one per partition, and stage transitions whose operand
placement changes pay the Eq. 3-4 movement cost (N/4 temporary rows,
3N/4 cycles per exchanging transition).

Functional execution folds the partition axis into the batch axis of the CAS
block.  This is exact, not an approximation: the physical array is
22 rows x 4*(N/2) columns and every IMC cycle operates on ALL columns of a
row pair at once, so the partitions advance in lock-step — identical to
batching independent 22 x W arrays.  Cycle accounting therefore charges each
stage ONE CAS program (28 cycles at W=4), not N/2 of them.

Each stage gathers its (i, j) operands, runs ``cas.run_cas`` on them — the
simulator on the CPU, one K7 launch on a CUDA card — selects (lo, hi) or
(hi, lo) by the pair's direction and puts both back.  The stage index and
direction tensors are built once per (n, device), and the partition plan
once per n.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core import cas, network


@dataclasses.dataclass(frozen=True)
class SortResult:
    values: torch.Tensor         # (batch, n) ascending, int32 words
    cycles: int                  # total IMC cycles (compute + movement)
    compute_cycles: int          # stages * CAS program length
    movement_cycles: int         # Eq.3-4 inter-partition operand exchange
    n_partitions: int
    n_temp_rows: int
    array_rows: int
    array_cols: int
    op_counts: dict


def array_geometry(n: int, width: int = 4) -> dict:
    """Physical array footprint for an N-input sorter (paper: 16x22 for N=8)."""
    prog = cas.cached_program(width)
    return {
        "rows": prog.n_rows,
        "cols": width * (n // 2),
        "temp_rows": network.n_temp_rows(n),
        "bits": prog.n_rows * width * (n // 2),
    }


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> network.PartitionPlan:
    return network.plan_partitions(n)


# one stage on a device: (i indices, j indices, ascending mask, the inverse
# of cat(i, j)) -- the last scatters a stage's outputs back by one gather
_Stage = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_STAGES: Dict[Tuple[int, str], List[_Stage]] = {}


def _stages(n: int, device: torch.device) -> List[_Stage]:
    key = (n, str(device))
    stages = _STAGES.get(key)
    if stages is None:
        stages = []
        for stage in network.bitonic_stages(n):
            ii = torch.tensor([p[0] for p in stage], dtype=torch.int64)
            jj = torch.tensor([p[1] for p in stage], dtype=torch.int64)
            asc = torch.tensor([p[2] for p in stage], dtype=torch.bool)
            inv = torch.empty(n, dtype=torch.int64)
            inv[torch.cat([ii, jj])] = torch.arange(n)
            stages.append(tuple(t.to(device) for t in (ii, jj, asc[None, :],
                                                       inv)))
        _STAGES[key] = stages
    return stages


def sort_in_memory(values, width: int = 4, *, device="cuda") -> SortResult:
    """Sort (batch, n) unsigned ``width``-bit words with the IMC bitonic
    unit, on ``device`` (default the card; ``"cpu"`` runs the simulator).

    Every CAS in the schedule runs the full gate program (28 cycles at
    W=4): as K7 on a CUDA card, on the simulated 6T SRAM array on the
    CPU.  Results are bit-exact against any comparison sort of the W-bit
    words; the values come back as int32 words on ``device``.  ``n`` must
    be a power of two >= 2 (ValueError otherwise: the network is not
    padded).
    """
    from repro_torch.core.sortspec import resolve_device
    v = cas.as_words(values).to(resolve_device(device))
    if v.dim() == 1:
        v = v[None, :]
    batch, n = v.shape
    plan = _plan(n)
    prog = cas.cached_program(width)
    stages = _stages(n, v.device)

    for ii, jj, asc, inv in stages:
        res = cas.run_cas(v.index_select(1, ii).reshape(-1),
                          v.index_select(1, jj).reshape(-1), width=width,
                          device=v.device)
        lo = res.lo.view(batch, -1)
        hi = res.hi.view(batch, -1)
        out = torch.cat([torch.where(asc, lo, hi), torch.where(asc, hi, lo)],
                        dim=1)
        v = out.index_select(1, inv)

    compute = len(stages) * prog.total_cycles
    movement = plan.extra_cycles
    geom = array_geometry(n, width)
    counter_ops = cas.static_op_counts(width).as_dict()
    counter_ops.pop("total")
    counter_ops = {k: c * len(stages) for k, c in counter_ops.items()}
    # movement ops are COPY-class (temp-row reads/writes)
    counter_ops["COPY"] += movement
    counter_ops["total"] = compute + movement
    return SortResult(values=v, cycles=compute + movement,
                      compute_cycles=compute, movement_cycles=movement,
                      n_partitions=plan.n_partitions,
                      n_temp_rows=network.n_temp_rows(n),
                      array_rows=geom["rows"], array_cols=geom["cols"],
                      op_counts=counter_ops)
