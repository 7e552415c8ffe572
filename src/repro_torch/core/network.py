"""Batcher bitonic sorting networks (paper §II-B, Eq. 1-4).

A bitonic network over N = 2^k inputs is an *oblivious* schedule of
compare-and-swap (CAS) pairs: the pair list of every stage is fixed at
network-construction time and independent of the data.  This is exactly what
makes it the right algorithm for an in-memory substrate (paper) and for a
SIMD substrate (a CUDA card): every stage is a data-independent vector op.

The port's own copy of the JAX package's ``core/network.py``: pure
Python metadata, no torch.  It produces:
  * the stage schedule (list of stages; each stage a list of (i, j, ascending))
  * the analytic counts of Eq. 1-2 and checks them against the generated net
  * the partition residency plan of §II-B: which partition holds which element
    at each stage, and which stage transitions require inter-partition operand
    movement (Eq. 3-4 cost accounting).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

CASPair = Tuple[int, int, bool]  # (low index, high index, sort-ascending?)


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def n_cas_blocks(n: int) -> int:
    """Eq. 1:  N_CAS = N * log2(N) * (1 + log2(N)) / 4."""
    k = int(math.log2(n))
    return n * k * (1 + k) // 4


def n_stages(n: int) -> int:
    """Eq. 2:  N_stages = log2(N) * (1 + log2(N)) / 2."""
    k = int(math.log2(n))
    return k * (1 + k) // 2


def n_temp_rows(n: int) -> int:
    """Eq. 3:  temporary rows used for inter-partition movement."""
    return n // 4


def movement_cycles(n: int) -> int:
    """Eq. 4:  extra cycles charged per exchanging stage transition."""
    return 3 * n // 4


def bitonic_stages(n: int) -> List[List[CASPair]]:
    """Standard Batcher bitonic network, ascending overall sort.

    Returns ``stages`` where ``stages[s]`` is the list of CAS pairs executed
    concurrently in stage ``s`` (each element index appears in exactly one
    pair per stage; there are n/2 pairs per stage).
    """
    if not is_pow2(n) or n < 2:
        raise ValueError(f"bitonic network requires power-of-two n >= 2, got {n}")
    stages: List[List[CASPair]] = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            pairs: List[CASPair] = []
            for i in range(n):
                partner = i ^ j
                if partner > i:
                    ascending = (i & k) == 0
                    pairs.append((i, partner, ascending))
            stages.append(pairs)
            j //= 2
        k *= 2
    # Self-check against the paper's closed forms (Eq. 1-2).
    assert len(stages) == n_stages(n), (len(stages), n_stages(n))
    assert sum(len(s) for s in stages) == n_cas_blocks(n)
    return stages


def apply_network(values: Sequence, stages: List[List[CASPair]]) -> list:
    """Reference (python-level) execution of the network — test oracle glue."""
    v = list(values)
    for stage in stages:
        for (i, j, asc) in stage:
            lo, hi = (v[i], v[j]) if v[i] <= v[j] else (v[j], v[i])
            v[i], v[j] = (lo, hi) if asc else (hi, lo)
    return v


# ---------------------------------------------------------------------------
# Partition residency planning (§II-B)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Residency of the N elements across the N/2 memory partitions.

    ``residency[s]`` maps element index -> partition index during stage s.
    ``moving_transitions`` counts stage transitions whose operand placement
    requires inter-partition movement, with the paper's fused-first-exchange
    accounting: the first exchange is absorbed into the
    broadcast-writeback of the previous stage (movement types c/d write a row
    across *all* partitions' columns), so it is not charged.
    """
    n: int
    residency: List[dict]
    raw_moving_transitions: int
    moving_transitions: int

    @property
    def extra_cycles(self) -> int:
        return self.moving_transitions * movement_cycles(self.n)

    @property
    def n_partitions(self) -> int:
        return self.n // 2


def plan_partitions(n: int) -> PartitionPlan:
    stages = bitonic_stages(n)
    # Initial residency: partition p holds elements (2p, 2p+1) — the stage-1
    # pairs, which by construction are (2p, 2p+1), so stage 1 is always local.
    residency: List[dict] = []
    current = {e: e // 2 for e in range(n)}
    raw_moves = 0
    for s, stage in enumerate(stages):
        # Assign each pair to a partition, preferring partitions already
        # holding one of the operands (greedy, keeps moves minimal).
        target: dict = {}
        taken = set()
        # First pass: pairs that can stay where (at least) one operand lives.
        pending = []
        for (i, j, _) in stage:
            pi, pj = current[i], current[j]
            if pi == pj and pi not in taken:
                target[(i, j)] = pi
                taken.add(pi)
            elif pi not in taken:
                target[(i, j)] = pi
                taken.add(pi)
            elif pj not in taken:
                target[(i, j)] = pj
                taken.add(pj)
            else:
                pending.append((i, j))
        free = [p for p in range(n // 2) if p not in taken]
        for pair, p in zip(pending, free):
            target[pair] = p
        new = {}
        moved = False
        for (i, j), p in target.items():
            if current[i] != p or current[j] != p:
                moved = True
            new[i] = p
            new[j] = p
        if s > 0 and moved:
            raw_moves += 1
        current = new
        residency.append(dict(current))
    # Paper accounting: first exchange fused with previous writeback broadcast.
    charged = max(0, raw_moves - 1)
    return PartitionPlan(n=n, residency=residency,
                         raw_moving_transitions=raw_moves,
                         moving_transitions=charged)


def total_extra_cycles(n: int) -> int:
    """Total inter-stage movement cycles for an N-input sort (24 for N=8)."""
    return plan_partitions(n).extra_cycles
