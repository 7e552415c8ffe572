"""K5 — per-row top-k: the CUDA kernels and their plain versions.

The function: the top k of each row, descending, the lower index first
among equal keys, keys compared numerically (-0.0 and +0.0 tie and come
out in index order, as in the reference's Pallas top-k).  Indices are
unique, so the answer is unique whatever order a kernel meets the keys in.

Two routes (``csrc/bitonic_topk.cu``):

* k <= :data:`MAX_K` — :func:`topk_rows`, one pass over rows of any length
  n >= k.  Every (key, index) pair is one 64-bit composite (:func:`pack`):
  the key's order-preserving code with -0.0 folded onto +0.0, above
  2^31 - 1 - index, above one bit that remembers a -0.0, so the order is a
  plain descending compare and 0 is a placeholder below every genuine
  pair.  :func:`plan` picks the kernel: ``short`` rows (n <= 512, k <= 16)
  take 2^p lanes of 16 keys each, merged by bitonic merge-and-halve across
  the lanes; longer rows are ``stream``ed, a warp a stripe of the row
  keeping its best N = max(32, next_pow2(k)) pairs, then the warps of a CTA
  and, for a row of several CTAs, a second launch (``topk_rows_merge``)
  merge their runs.  :func:`topk_rows_plain` is the same decomposition in
  tensor ops: each stripe's best N by the plain network of K1, then the
  same merge-and-halve of the runs (the kernel's admission queue only
  saves work and is not mirrored).
* k > :data:`MAX_K` — :func:`topk_blocks`, K1's descending key-value
  network on lane indices over power-of-two rows up to K1's cap, first k
  columns; ``kernels/ops.py`` chunks longer rows and orders the candidates.
  :func:`topk_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import index_rows, next_pow2
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as _bs

MAX_N = _bs.MAX_N       # topk_blocks: the same cap as K1
MAX_K = 256             # topk_rows: the largest k of the one-pass kernels
MAX_ROW = (1 << 31) - 1     # topk_rows: indices stay int32

SHORT_KEYS = 16         # keys a lane of the short kernel
SHORT_MAX_N = 32 * SHORT_KEYS
SHORT_MAX_K = 16
WARPS = 8               # warps a CTA of the stream kernel
STEP = 32 * 32          # keys a warp takes a step of the stream kernel
                        # (at k <= 64; 32 * 16 above)
MERGE_WARPS = 16        # at most, a CTA of the merge kernel
SMS = 132               # the H100's SMs
TARGET_WARPS = SMS * 16     # stream warps the plan aims at: 2 CTAs an SM
MIN_STRIPE = 2048       # keys a warp at the least, where rows are few

PLACEHOLDER = -(1 << 63)    # composite 0 (loses to every pair), signed


@dataclass(frozen=True)
class RowPlan:
    """How :func:`topk_rows` cuts its rows.  ``short``: ``lanes`` lanes a
    row of :data:`SHORT_KEYS` keys each.  ``stream``: ``warps_per_row`` 1
    (a warp a row) or :data:`WARPS` (``ctas`` CTAs a row, a stripe of
    ``stripe`` keys a warp)."""
    route: str
    lanes: int = 1
    warps_per_row: int = 1
    ctas: int = 1
    stripe: int = 0


def run_len(k: int) -> int:
    """N: the pairs a warp of the stream kernel keeps."""
    return max(32, next_pow2(k))


def plan(rows: int, n: int, k: int) -> RowPlan:
    """The kernel and cut for top-k of (rows, n): short rows at small k on
    lanes; else a warp a row, or, where that leaves the card short of
    :data:`TARGET_WARPS` warps, CTAs of :data:`WARPS` warps a row -- as many
    as fit one wave of :data:`TARGET_WARPS` and no more than stripes of
    :data:`MIN_STRIPE` keys need -- and a merge launch when a row has more
    than one."""
    if next_pow2(k) <= SHORT_MAX_K and n <= SHORT_MAX_N:
        return RowPlan("short", lanes=next_pow2(-(-n // SHORT_KEYS)))
    if rows >= TARGET_WARPS or n <= MIN_STRIPE:
        return RowPlan("stream")
    ctas = max(1, min(TARGET_WARPS // (rows * WARPS),
                      -(-n // (WARPS * MIN_STRIPE))))
    stripe = -(-(-(-n // (ctas * WARPS))) // STEP) * STEP
    return RowPlan("stream", warps_per_row=WARPS,
                   ctas=-(-n // (stripe * WARPS)), stripe=stripe)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pack(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) keys -> int64 composites whose signed order is the
    kernels' unsigned composite order: key code (-0.0 as +0.0) in the high
    32 bits, then 2^31 - 1 - index, then a -0.0 bit (less 2^63)."""
    bits = keycodec.key_bits(x.dtype)
    neg_zero = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    if x.dtype.is_floating_point:
        zero = x == 0
        neg_zero = (zero & torch.signbit(x)).to(torch.int64)
        x = torch.where(zero, torch.zeros_like(x), x)
    code = keycodec.encode(x).to(torch.int64) & ((1 << bits) - 1)
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    lo = ((0x7fffffff - idx) << 1) | neg_zero
    return (code - (1 << 31)) * (1 << 32) + lo


def unpack(c: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack`: (keys of ``dtype``, int32 indices)."""
    bits = keycodec.key_bits(dtype)
    code = (c >> 32) + (1 << 31)
    lo = c & 0xffffffff
    idx = (0x7fffffff - (lo >> 1)).to(torch.int32)
    code = torch.where(code >= 1 << (bits - 1), code - (1 << bits), code)
    key = keycodec.decode(code.to(keycodec.key_dtype(dtype)), dtype)
    if dtype.is_floating_point:
        key = torch.where((lo & 1) == 1, torch.full_like(key, -0.0), key)
    return key, idx


def _best(c: torch.Tensor, m: int) -> torch.Tensor:
    """Each row's best m composites, descending, by K1's plain network
    (rows padded with placeholders to a power of two >= m)."""
    w = next_pow2(max(c.shape[-1], m))
    if w > c.shape[-1]:
        c = torch.cat([c, c.new_full((c.shape[0], w - c.shape[-1]),
                                     PLACEHOLDER)], -1)
    return _bs.apply_network(c, True)[:, :m]


def _merge(h: torch.Tensor) -> torch.Tensor:
    """Bitonic rows -> descending (the last stage of the network)."""
    rows, m = h.shape
    d = m // 2
    while d >= 1:
        v = h.reshape(rows, m // (2 * d), 2, d)
        a, b = v[:, :, 0, :], v[:, :, 1, :]
        h = torch.stack([torch.maximum(a, b), torch.minimum(a, b)],
                        2).reshape(rows, m)
        d //= 2
    return h


def _halve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge-and-halve of descending runs: the first half of both."""
    return _merge(torch.maximum(a, b.flip(-1)))


def _tree(runs: torch.Tensor) -> torch.Tensor:
    """(rows, w, m) runs -> (rows, m): run i takes run i + s at s = 1, 2,
    4, .. where i % 2s == 0, as a CTA's warps merge in shared memory."""
    rows, w, m = runs.shape
    runs = list(runs.unbind(1))
    s = 1
    while s < w:
        for i in range(0, w - s, 2 * s):
            runs[i] = _halve(runs[i], runs[i + s])
        s *= 2
    return runs[0]


def merge_runs_plain(parts: torch.Tensor, k: int, dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_rows_merge``: (rows, ctas, N) descending
    runs of composites (signed, as :func:`pack` gives them) -> the rows' top
    k.  Warp w of the merge CTA merges runs w, w + warps, .., then the
    warps' runs merge pairwise."""
    rows, ctas, m = parts.shape
    warps = min(ctas, MERGE_WARPS)
    acc = parts.new_full((rows, warps, m), PLACEHOLDER)
    for g0 in range(0, ctas, warps):
        part = parts[:, g0:g0 + warps]
        w = part.shape[1]
        acc[:, :w] = _halve(acc[:, :w].reshape(-1, m),
                            part.reshape(-1, m)).view(rows, w, m)
    return unpack(_tree(acc)[:, :k], dtype)


def topk_rows_plain(x: torch.Tensor, k: int,
                    plan_: Optional[RowPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_rows`, cut as ``plan_`` (default
    :func:`plan`) cuts the kernels' work."""
    rows, n = x.shape
    p = plan_ or plan(rows, n, k)
    c = pack(x)
    if p.route == "short":
        kp = next_pow2(k)
        lane_runs = SHORT_KEYS // kp
        c = torch.cat([c, c.new_full((rows, p.lanes * SHORT_KEYS - n),
                                     PLACEHOLDER)], -1)
        runs = _bs.apply_network(c.reshape(-1, kp), True)
        runs = runs.view(rows, p.lanes * lane_runs, kp)
        while runs.shape[1] > 1:     # in the lane, then across the lanes
            runs = _halve(runs[:, 0::2].reshape(-1, kp),
                          runs[:, 1::2].reshape(-1, kp)) \
                .view(rows, -1, kp)
        top = runs[:, 0]
    elif p.warps_per_row == 1:
        top = _best(c, run_len(k))
    else:
        m = run_len(k)
        width = p.ctas * WARPS * p.stripe
        c = torch.cat([c, c.new_full((rows, width - n), PLACEHOLDER)], -1)
        runs = _best(c.view(-1, p.stripe), m).view(rows * p.ctas, WARPS, m)
        return merge_runs_plain(_tree(runs).view(rows, p.ctas, m), k,
                                x.dtype)
    return unpack(top[:, :k], x.dtype)


def topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_blocks`: the descending key-value
    network on lane indices, first k columns."""
    sk, si = _bs.apply_network_kv(x, index_rows(x), True)
    return sk[:, :k].contiguous(), si[:, :k].contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("bitonic_topk")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitonic_topk_blocks.argtypes = [i, vp, vp, vp, ll, i, i, vp]
        lib.topk_rows_short.argtypes = [i, vp, vp, vp, ll, i, i, i, vp]
        lib.topk_rows_stream.argtypes = [i, vp, vp, vp, vp, ll, ll, i, ll,
                                         i, i, vp]
        lib.topk_rows_merge.argtypes = [i, vp, vp, vp, ll, i, i, i, vp]
        for f in (lib.bitonic_topk_blocks, lib.topk_rows_short,
                  lib.topk_rows_stream, lib.topk_rows_merge):
            f.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _build.KEY_CODES:
        raise TypeError(f"{what}: no kernel for keys of "
                        f"{keycodec.dtype_name(x.dtype)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: keys must be contiguous")


def _check_plan(p: RowPlan, n: int, k: int) -> None:
    if p.route == "short":
        if next_pow2(k) > SHORT_MAX_K or p.lanes > 32 or \
                p.lanes * SHORT_KEYS < n:
            raise ValueError(f"topk_rows: the short kernel takes k <= "
                             f"{SHORT_MAX_K} over {p.lanes} lanes of "
                             f"{SHORT_KEYS} keys; got n={n}, k={k}")
    elif p.warps_per_row != 1 and (p.warps_per_row != WARPS or p.ctas < 1
                                   or p.stripe * WARPS * p.ctas < n):
        raise ValueError(f"topk_rows: {p} does not cover rows of {n}")


def topk_rows(x: torch.Tensor, k: int, plan_: Optional[RowPlan] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of (rows, n) -> (rows, k) values and int32 indices,
    descending, the lower index first among equal keys, any n >= k, k <=
    :data:`MAX_K`, cut as ``plan_`` (default :func:`plan`).  The kernels
    for a CUDA tensor (one launch, or two for a row of several CTAs), the
    plain version for a CPU tensor."""
    if x.dim() != 2:
        raise ValueError(f"topk_rows takes (rows, n), got shape "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"topk_rows: k must satisfy 1 <= k <= min(n, "
                         f"{MAX_K}) (n={n}); got k={k}")
    if n > MAX_ROW:
        raise ValueError(f"topk_rows: rows of {n} keys exceed int32 indices")
    p = plan_ or plan(rows, n, k)
    _check_plan(p, n, k)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"topk_rows: unsupported device {x.device}")
        return topk_rows_plain(x, k, p)
    _check_cuda(x, "topk_rows")
    vout = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    iout = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vout, iout
    code = _build.KEY_CODES[x.dtype]
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        if p.route == "short":
            status = _lib().topk_rows_short(
                code, _build.ptr(x), _build.ptr(vout), _build.ptr(iout),
                rows, n, k, p.lanes.bit_length() - 1, stream)
            _build.check(status, "topk_rows_short")
            _build.count_launch("topk_rows_short")
            return vout, iout
        part = None if p.ctas == 1 else torch.empty(
            (rows, p.ctas, run_len(k)), dtype=torch.int64, device=x.device)
        status = _lib().topk_rows_stream(
            code, _build.ptr(x), _build.ptr(vout), _build.ptr(iout),
            _build.ptr(part), rows, n, k, p.stripe or n, p.warps_per_row,
            p.ctas, stream)
        _build.check(status, "topk_rows_stream")
        _build.count_launch("topk_rows_stream")
        if part is not None:
            status = _lib().topk_rows_merge(
                code, _build.ptr(part), _build.ptr(vout), _build.ptr(iout),
                rows, p.ctas, min(p.ctas, MERGE_WARPS), k, stream)
            _build.check(status, "topk_rows_merge")
            _build.count_launch("topk_rows_merge")
    return vout, iout


def topk_blocks(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of (rows, n) -> (rows, k) values and int32 indices,
    descending, the lower index first among equal keys; n a power of two
    >= k (``ops.bitonic_topk`` pads).  The kernel for a CUDA tensor, the
    plain network for a CPU tensor."""
    n = _bs._check_rows(x, "topk_blocks")
    if not 1 <= k <= n:
        raise ValueError(f"topk_blocks: k must satisfy 1 <= k <= n (n={n}); "
                         f"got k={k}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"topk_blocks: unsupported device {x.device}")
        return topk_plain(x, k)
    _check_cuda(x, "topk_blocks")
    if n > MAX_N:
        raise ValueError(f"topk_blocks: rows of {n} exceed the shared-memory "
                         f"cap of {MAX_N}")
    rows = x.shape[0]
    vout = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    iout = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vout, iout
    with torch.cuda.device(x.device):
        status = _lib().bitonic_topk_blocks(
            _build.KEY_CODES[x.dtype], _build.ptr(x), _build.ptr(vout),
            _build.ptr(iout), rows, n.bit_length() - 1, k,
            _build.stream_of(x))
    _build.check(status, "bitonic_topk_blocks")
    _build.count_launch("bitonic_topk_blocks")
    return vout, iout
