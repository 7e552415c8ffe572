"""Device cost model — what ``planner.choose`` prices the backends with.

The part of the JAX package's cost model the single-device planner needs:
closed-form ns estimates per sort backend and for top-k selection, with fixed asymptotics and leading
constants from the active tuning profile.  The constants are the JAX
package's default seeds (``core/tuning.py``), not measurements on a CUDA
card; they order candidates, they do not predict times.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core import tuning as _tuning
from repro_torch.core.tuning import DeviceSortConstants


def _log2(v: float) -> float:
    return math.log2(max(2.0, v))


def device_sort_cost_ns(method: str, n: int, batch: int = 1, *,
                        run_len: Optional[int] = None,
                        consts: Optional[DeviceSortConstants] = None,
                        plain: bool = False,
                        key_bits: int = 32) -> float:
    """Estimated ns to sort ``batch`` rows of ``n`` with one backend.

    ``n`` is priced at the padded size each backend executes.  ``plain``
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
        tiled = -(-n // prof.radix_tile) * prof.radix_tile
        return pen * c.radix * batch * tiled * passes
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
                      digit_bits: Optional[int] = None,
                      tile: Optional[int] = None) -> float:
    """Estimated ns for an exact top-k *selection* of ``(batch, n)`` rows:
    ``ceil(b/digit_bits)`` MSD digit-refinement passes of O(n) counting
    over the tile-padded row, plus the O(k log k) ordering of the k
    survivors (priced as a ``torch`` sort of k)."""
    prof = _tuning.active()
    c = consts or prof.constants
    digit_bits = prof.digit_bits if digit_bits is None else digit_bits
    tile = prof.radix_tile if tile is None else tile
    passes = -(-key_bits // digit_bits)
    tiled = -(-n // tile) * tile
    return c.select * batch * tiled * passes + c.torch * batch * k * _log2(k)
