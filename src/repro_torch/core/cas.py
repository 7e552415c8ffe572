"""Execute the in-memory Compare-And-Swap block.

``run_cas`` is the faithful path: the operands are written into rows A/B
of the IMC array, the 28-cycle gate program of :mod:`repro_torch.core.gates`
runs one op per cycle, and (min, max) are read back from rows A/B — the
paper's §II-A contract (min in row 3 at cycle 28, max in row 4 at cycle 27).

* On the CPU (``device="cpu"``) the program runs on the cycle-accurate
  simulator (:mod:`repro_torch.core.imc_array`), as in the JAX package.
* On a CUDA card (the default) it is one launch of K7
  (``kernels/ops.bitserial_cas``), which runs the same program per pair
  on the card; the simulator's torch ops never run there.

Cycle accounting is static and data-independent: the program's length and
op mix, whatever the operands.  Words are int32 carriers of the W low bits
(see ``imc_array``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import gates, imc_array, keycodec


@dataclasses.dataclass(frozen=True)
class CASResult:
    lo: torch.Tensor          # elementwise min(a, b), int32 words
    hi: torch.Tensor          # elementwise max(a, b), int32 words
    cycles: int
    op_counts: dict


@functools.lru_cache(maxsize=None)
def cached_program(width: int) -> gates.CASProgram:
    return gates.build_cas_program(width)


def static_op_counts(width: int) -> imc_array.CycleCounter:
    """The op mix of one CAS of width W (data-independent)."""
    counter = imc_array.CycleCounter()
    for op in cached_program(width).ops:
        counter.count(op.kind)
    return counter


_UNSIGNED_VIEW = {torch.uint32: torch.int32}


def as_words(x) -> torch.Tensor:
    """Unsigned words of any integer dtype -> int32 carriers of their low
    32 bits: what the reference's cast to uint32 keeps."""
    x = torch.as_tensor(x)
    if x.dtype == torch.int32:
        return x
    if x.dtype in _UNSIGNED_VIEW:
        return x.view(_UNSIGNED_VIEW[x.dtype])
    if x.dtype == torch.int64:
        return keycodec.wrap_int32(x & 0xFFFFFFFF)
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"CAS operands are unsigned words, got {x.dtype}")
    return x.to(torch.int32)


def _simulate(a: torch.Tensor, b: torch.Tensor, width: int):
    prog = cached_program(width)
    state = imc_array.make_array(a.shape[0], prog.n_rows, width,
                                 device=a.device)
    state = imc_array.write_word(state, imc_array.ROW_A,
                                 imc_array.int_to_bits(a, width))
    state = imc_array.write_word(state, imc_array.ROW_B,
                                 imc_array.int_to_bits(b, width))
    state = imc_array.run_program(state, prog.ops)
    lo = imc_array.bits_to_int(imc_array.read_word(state, imc_array.ROW_A))
    hi = imc_array.bits_to_int(imc_array.read_word(state, imc_array.ROW_B))
    return lo, hi


def run_cas(a, b, width: int = 4, *, device="cuda") -> CASResult:
    """Compare-and-swap batches of unsigned ``width``-bit words in-memory.

    Args:
      a, b: (batch,) unsigned words (any integer dtype; their W low bits),
        moved to ``device``: a CUDA card (K7, the default) or the CPU
        (the simulator).
    Returns:
      CASResult with lo=min, hi=max per element as int32 words, plus exact
      cycle accounting.
    """
    from repro_torch.core.sortspec import resolve_device
    dev = resolve_device(device)
    a, b = as_words(a).to(dev), as_words(b).to(dev)
    counter = static_op_counts(width)
    if a.is_cuda:
        from repro_torch.kernels import ops
        lo, hi = ops.bitserial_cas(a, b, width=width)
    else:
        lo, hi = _simulate(a, b, width)
    return CASResult(lo=lo, hi=hi, cycles=counter.total,
                     op_counts=counter.as_dict())
