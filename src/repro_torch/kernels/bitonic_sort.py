"""K1 — whole-row bitonic sort: the CUDA kernel and its plain version.

The kernel (``csrc/bitonic_sort.cu`` over ``csrc/bitonic_reg.cuh``) runs
the entire Batcher network on each row in registers, reading the row once
and writing it once; :func:`schedule` says where each substage runs (in a
thread, across a warp, or in a shared-memory round).  The plain version
here is the same network in PyTorch, in that order, addressed with the
reshape trick the JAX package uses: for a substage with partner distance
``j`` the row is viewed as ``(n/(2j), 2, j)``, partners are the two middle
halves, and the direction is constant per outer chunk.  It runs for CPU
tensors (the tests), is the ``bitonic`` backend, and is what ``chip_smoke.py``
holds the kernel against on the card.

Both reproduce the reference bit for bit, including XLA's min/max on signed
zeros (``jnp.minimum(0.0, -0.0)`` is ``-0.0``; ``torch.minimum`` returns
``0.0``) and, for the plain network, XLA's min/max gradient (a tie splits
the cotangent in halves), so autograd through it matches the JAX VJP.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build

# a CTA holds a row in at most 1024 threads of 16 keys (key-value rows of
# 16384: 512 threads of 32 keys and payloads)
MAX_N = 1 << 14


def thread_keys(n: int, kv: bool = False) -> int:
    """Keys a thread of the kernel holds for rows of n: 16, but 32 for
    key-value rows of 16384 (``csrc/bitonic_reg.cuh`` ``bitonic_shape``)."""
    return 32 if kv and n >= MAX_N else 16


def shared_from(n: int, kv: bool = False) -> int:
    """The shortest partner distance the kernel runs through shared
    memory: a warp's 32 x 16 keys at 16 a thread; at 32 a thread every
    distance past the thread (no shuffles)."""
    e = thread_keys(n, kv)
    return 32 * e if e == 16 else e


def _substages(n: int):
    """Static (k, j) substage schedule of the n-input bitonic network."""
    out = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            out.append((k, j))
            j //= 2
        k *= 2
    return out


def schedule(n: int, kv: bool = False):
    """Where the kernel runs each substage of the n-input network, in its
    order (``csrc/bitonic_reg.cuh``), E = :func:`thread_keys` keys a
    thread: a list of ``(place, [(k, j), ...])`` steps, place ``"shared"``
    for a shared-memory round trip of up to log2(E) consecutive substages
    with j >= :func:`shared_from` (the top of a stage first), ``"warp"``
    for a stage's shuffle substages (E <= j below that) and ``"thread"``
    for its substages with j < E, in registers."""
    log_e = thread_keys(n, kv).bit_length() - 1
    log_span = shared_from(n, kv).bit_length() - 1
    steps = []
    for lk in range(1, n.bit_length()):
        k, lj = 1 << lk, lk - 1
        while lj >= log_span:
            r = min(log_e, lj - log_span + 1)
            steps.append(("shared", [(k, 1 << b)
                                     for b in range(lj, lj - r, -1)]))
            lj -= r
        if lj >= log_e:
            steps.append(("warp", [(k, 1 << b)
                                   for b in range(lj, log_e - 1, -1)]))
        steps.append(("thread", [(k, 1 << b)
                                 for b in range(min(lj, log_e - 1), -1, -1)]))
    return steps


def network_order(n: int):
    """The (k, j) substages in the order :func:`schedule` runs them."""
    return [kj for _, kjs in schedule(n) for kj in kjs]


def _chunk_flags(n: int, k: int, j: int, device) -> torch.Tensor:
    """Bit k of each outer chunk's first index in the (n/(2j), 2, j) view:
    the chunks that run reversed at stage k."""
    q = torch.arange(n // (2 * j), device=device)
    return (((q * (2 * j)) & k) != 0).view(1, -1, 1)


def _pick(a: torch.Tensor, b: torch.Tensor):
    """(take a as the minimum, take a as the maximum) with XLA's rules:
    on a float tie of -0.0 and +0.0 the minimum is -0.0, the maximum +0.0."""
    if a.is_floating_point():
        tie = a == b
        neg = torch.signbit(a)
        return (a < b) | (tie & neg), (a > b) | (tie & ~neg)
    return a <= b, a >= b


class _MinMax(torch.autograd.Function):
    """Elementwise (minimum, maximum) with XLA's values and XLA's gradient:
    an operand equal to the result takes the cotangent, halved when both
    operands equal it (lax.min/max's balanced JVP)."""

    @staticmethod
    def forward(ctx, a, b):
        a_min, a_max = _pick(a, b)
        mn, mx = torch.where(a_min, a, b), torch.where(a_max, a, b)
        ctx.save_for_backward(a, b, mn, mx)
        return mn, mx

    @staticmethod
    def backward(ctx, g_mn, g_mx):
        a, b, mn, mx = ctx.saved_tensors

        def share(x, y, z):
            w = torch.where(x == z, 1.0, 0.0) / torch.where(y == z, 2.0, 1.0)
            return w.to(z.dtype)

        ga = g_mn * share(a, b, mn) + g_mx * share(a, b, mx)
        gb = g_mn * share(b, a, mn) + g_mx * share(b, a, mx)
        return ga, gb


def apply_network(x: torch.Tensor, descending: bool) -> torch.Tensor:
    """Plain version of the key-only kernel: the full network on (rows, n),
    n a power of two."""
    dtype = x.dtype
    x = keycodec.to_signed(x)
    rows, n = x.shape
    for (k, j) in network_order(n):
        v = x.reshape(rows, n // (2 * j), 2, j)
        a, b = v[:, :, 0, :], v[:, :, 1, :]
        desc = _chunk_flags(n, k, j, x.device)
        if descending:
            desc = ~desc
        mn, mx = _MinMax.apply(a, b)
        first = torch.where(desc, mx, mn)
        second = torch.where(desc, mn, mx)
        x = torch.stack([first, second], dim=2).reshape(rows, n)
    return keycodec.from_signed(x, dtype)


def apply_network_kv(keys: torch.Tensor, vals: torch.Tensor,
                     descending: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the key-value kernel.  The comparator is the
    composite (key in the requested direction, payload ascending on ties):
    with unique index payloads a strict total order, so the unstable
    network returns the ties-keep-ascending-index result both ways."""
    dtype = keys.dtype
    keys = keycodec.to_signed(keys)
    rows, n = keys.shape
    for (k, j) in network_order(n):
        kv = keys.reshape(rows, n // (2 * j), 2, j)
        vv = vals.reshape(rows, n // (2 * j), 2, j)
        ka, kb = kv[:, :, 0, :], kv[:, :, 1, :]
        va, vb = vv[:, :, 0, :], vv[:, :, 1, :]
        # raw chunk directions: the final direction lives in the comparator,
        # so the chunks flagged here are those reversed w.r.t. the result
        rev = _chunk_flags(n, k, j, keys.device)
        key_first = (ka > kb) if descending else (ka < kb)
        a_first = (key_first | ((ka == kb) & (va < vb))) != rev
        keys = torch.stack([torch.where(a_first, ka, kb),
                            torch.where(a_first, kb, ka)], 2).reshape(rows, n)
        vals = torch.stack([torch.where(a_first, va, vb),
                            torch.where(a_first, vb, va)], 2).reshape(rows, n)
    return keycodec.from_signed(keys, dtype), vals


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("bitonic_sort")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitonic_sort_blocks.argtypes = [i, vp, vp, vp, vp, ll, i, i, vp]
        lib.bitonic_sort_blocks.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_rows(x: torch.Tensor, what: str) -> int:
    if x.dim() != 2:
        raise ValueError(f"{what} takes (rows, n), got shape "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} needs a power-of-two row length, got {n}")
    return n


def _launch(keys, vals, descending: bool, name: str):
    n = _check_rows(keys, name)
    if keys.dtype not in _build.KEY_CODES:
        raise TypeError(f"{name}: no kernel for keys of "
                        f"{keycodec.dtype_name(keys.dtype)}")
    if n > MAX_N:
        raise ValueError(f"{name}: rows of {n} exceed the shared-memory cap "
                         f"of {MAX_N}")
    if not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be contiguous")
    if vals is not None:
        if (vals.dtype != torch.int32 or vals.shape != keys.shape
                or vals.device != keys.device or not vals.is_contiguous()):
            raise ValueError(f"{name}: the payload must be a contiguous "
                             f"int32 tensor of the keys' shape and device")
    kout = torch.empty_like(keys)
    vout = None if vals is None else torch.empty_like(vals)
    if keys.numel() == 0:
        return kout, vout
    with torch.cuda.device(keys.device):
        status = _lib().bitonic_sort_blocks(
            _build.KEY_CODES[keys.dtype], _build.ptr(keys), _build.ptr(vals),
            _build.ptr(kout), _build.ptr(vout), keys.shape[0],
            n.bit_length() - 1, int(descending), _build.stream_of(keys))
    _build.check(status, name)
    _build.count_launch(name)
    return kout, vout


def sort_blocks(x: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    """Sort each row of (rows, n), n a power of two: the kernel for a CUDA
    tensor, the plain network for a CPU tensor."""
    if x.is_cuda:
        return _launch(x, None, descending, "bitonic_sort_blocks")[0]
    if x.device.type != "cpu":
        raise ValueError(f"sort_blocks: unsupported device {x.device}")
    _check_rows(x, "sort_blocks")
    return apply_network(x, descending)


def sort_kv_blocks(keys: torch.Tensor, vals: torch.Tensor, *,
                   descending: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value sort of (rows, n) by the composite (key, payload) order."""
    if keys.is_cuda:
        return _launch(keys, vals, descending, "bitonic_sort_kv_blocks")
    if keys.device.type != "cpu":
        raise ValueError(f"sort_kv_blocks: unsupported device {keys.device}")
    _check_rows(keys, "sort_kv_blocks")
    return apply_network_kv(keys, vals, descending)
