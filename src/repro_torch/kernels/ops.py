"""Entry points of the ``cuda`` backend over the bitonic kernels (K1, K5),
and of the ``imc`` path over the bit-serial CAS kernel (K7).

Handles what the kernels do not: arbitrary axes and leading dims,
power-of-two padding with the direction's sentinel, rows longer than one
kernel row (top-k), and autodiff.  A sort runs the key-value network with
an index payload, so it also yields the permutation its gradient needs: a
sort is a permutation, and its transpose scatter-adds the cotangent back
(``torch.autograd.Function``, the counterpart of the JAX package's
``custom_vjp``); a top-k's gradient scatter-adds the values' cotangent at
the selected indices.
"""
from __future__ import annotations

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import index_rows, next_pow2
from repro_torch.kernels import bitonic_sort as _bs
from repro_torch.kernels import bitonic_topk as _bt


def sentinel(dtype, descending: bool):
    """Value that sorts to the end of a row in the given direction."""
    if dtype.is_floating_point:
        return float("-inf") if descending else float("inf")
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


def _to_rows(x: torch.Tensor, axis: int):
    """Move ``axis`` last and flatten leading dims -> (rows, n)."""
    axis = axis % x.dim()
    x = torch.movedim(x, axis, -1)
    lead = x.shape[:-1]
    return x.reshape(-1, x.shape[-1]), lead, axis


def _from_rows(rows: torch.Tensor, lead, axis: int) -> torch.Tensor:
    return torch.movedim(rows.reshape(*lead, rows.shape[-1]), -1, axis)


def pad_rows(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    """Right-pad (rows, n) to (rows, m) with ``fill``."""
    n = x.shape[-1]
    if m == n:
        return x
    pad = torch.full((x.shape[0], m - n), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _sort_fwd_impl(x: torch.Tensor, axis: int, descending: bool):
    rows, lead, ax = _to_rows(x, axis)
    n = rows.shape[-1]
    rows = pad_rows(rows, next_pow2(n),
                    sentinel(x.dtype, descending)).contiguous()
    idx = index_rows(rows)
    sk, si = _bs.sort_kv_blocks(rows, idx, descending=descending)
    return _from_rows(sk[:, :n], lead, ax), _from_rows(si[:, :n], lead, ax)


class _BitonicSort(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, descending):
        out, order = _sort_fwd_impl(x.detach(), axis, descending)
        ctx.save_for_backward(order)
        ctx.axis = axis
        return out

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        go, lead, ax = _to_rows(g, ctx.axis)
        oo, _, _ = _to_rows(order, ctx.axis)
        gx = torch.zeros_like(go).scatter_add_(1, oo.to(torch.int64), go)
        return _from_rows(gx, lead, ax), None, None


def bitonic_sort(x: torch.Tensor, axis: int = -1,
                 descending: bool = False) -> torch.Tensor:
    """Sort along ``axis`` with the bitonic kernel (differentiable)."""
    return _BitonicSort.apply(x, axis, descending)


def bitonic_argsort(x: torch.Tensor, axis: int = -1,
                    descending: bool = False) -> torch.Tensor:
    """Argsort along ``axis`` with the key-value kernel (int32 indices;
    ties keep ascending index order in both directions)."""
    return _sort_fwd_impl(x, axis, descending)[1]


# ---------------------------------------------------------------------------
# top-k (hierarchical for large n)
# ---------------------------------------------------------------------------

_TOPK_CHUNK = 2048


def order_candidates(keys: torch.Tensor, idx: torch.Tensor, n: int, k: int,
                     descending: bool):
    """The first k of (candidate keys, their int32 indices in a row of n)
    in (key in ``descending``'s direction, index ascending) order.  The
    caller guarantees that equal keys already sit in index order, so that
    is their stable order.  Up to K1's cap it is one K1 key-value sort
    (K1 breaks key ties on ascending payload), pads carrying index ``n``,
    above every genuine index, so a pad never displaces a genuine key
    equal to the pad key; above it, the engine's merge path orders the
    candidates' positions.  Both are the card's kernels whatever the
    device, so a CPU tensor runs the same route's plain versions, as the
    reference runs its one kernel route everywhere."""
    c = keys.shape[-1]
    cm = next_pow2(c)
    if cm <= _bs.MAX_N:
        sk, si = _bs.sort_kv_blocks(
            pad_rows(keys, cm, sentinel(keys.dtype, descending)).contiguous(),
            pad_rows(idx, cm, n).contiguous(), descending=descending)
        return sk[:, :k], si[:, :k]
    from repro_torch.engine import merge_sort_rows_kv, planner
    plan = planner.choose_cached(c, keys.shape[0], keys.dtype,
                                 requested="merge", device="cuda")
    _, pos = merge_sort_rows_kv(keys, index_rows(keys), descending=descending,
                                plan=plan, index_payload=True)
    pos = pos[:, :k].to(torch.int64)
    return keys.gather(-1, pos), idx.gather(-1, pos)


def _topk_impl(x: torch.Tensor, k: int, chunk: int = _TOPK_CHUNK):
    """(values, int32 indices) of the top k along the last axis."""
    rows, lead, _ = _to_rows(x, -1)
    rows = keycodec.to_signed(rows)
    n = rows.shape[-1]
    sent = sentinel(rows.dtype, True)
    if n <= chunk:
        m = max(next_pow2(n), next_pow2(k))
        v, i = _bt.topk_blocks(pad_rows(rows, m, sent).contiguous(), k)
    else:
        # per-chunk top-k, then an ordering of the chunks' candidates: the
        # reference's partition-then-merge (pads sit at positions >= n, so
        # their lane indices are above every genuine one)
        n_chunks = -(-n // chunk)
        r = pad_rows(rows, n_chunks * chunk, sent).contiguous()
        kk = min(k, chunk)
        v, i = _bt.topk_blocks(r.view(-1, chunk), kk)
        offs = torch.arange(n_chunks, dtype=torch.int32,
                            device=x.device).view(1, -1, 1) * chunk
        cv = v.view(-1, n_chunks * kk)
        ci = (i.view(-1, n_chunks, kk) + offs).view(-1, n_chunks * kk)
        # the candidates of a chunk are in index order among equal keys,
        # and the chunks are in order
        v, i = order_candidates(cv, ci, n, k, descending=True)
    v = keycodec.from_signed(v.contiguous(), x.dtype)
    return v.reshape(*lead, k), i.contiguous().reshape(*lead, k)


class _BitonicTopk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k, chunk):
        v, i = _topk_impl(x.detach(), k, chunk)
        ctx.save_for_backward(i)
        ctx.shape = x.shape
        ctx.mark_non_differentiable(i)
        return v, i

    @staticmethod
    def backward(ctx, gv, gi):
        (idx,) = ctx.saved_tensors
        n, k = ctx.shape[-1], idx.shape[-1]
        gx = torch.zeros((idx.numel() // k, n), dtype=gv.dtype,
                         device=gv.device)
        gx.scatter_add_(1, idx.reshape(-1, k).to(torch.int64),
                        gv.reshape(-1, k))
        return gx.reshape(ctx.shape), None, None


def bitonic_topk(x: torch.Tensor, k: int, chunk: int = _TOPK_CHUNK):
    """Top-k along the last axis -> (values, int32 indices), descending,
    the lower index first among equal keys (numeric: -0.0 == +0.0);
    differentiable in the values.  Rows up to ``chunk`` run K5 once;
    longer rows run K5 per chunk and order the candidates."""
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(
            f"topk k must satisfy 1 <= k <= n (n={n}); got k={k}")
    return _BitonicTopk.apply(x, k, chunk)


# ---------------------------------------------------------------------------
# bit-serial CAS (faithful mode, K7)
# ---------------------------------------------------------------------------

_CAS_LANES = 128


def bitserial_cas(a: torch.Tensor, b: torch.Tensor, *, width: int = 4):
    """Elementwise (min, max) of W-bit words via the paper's gate program
    (K7 on a card): any equal shapes of int32 words, flattened and padded
    with zeros into 128-lane rows as the reference does, returned in the
    operands' shape."""
    from repro_torch.kernels import bitserial_cas as _bc
    shape = a.shape
    flat_a, flat_b = a.reshape(-1), b.reshape(-1)
    n = flat_a.shape[0]
    lanes = _CAS_LANES if n >= _CAS_LANES else max(n, 1)
    m = -(-n // lanes) * lanes
    if m != n:
        flat_a = torch.nn.functional.pad(flat_a, (0, m - n))
        flat_b = torch.nn.functional.pad(flat_b, (0, m - n))
    lo, hi = _bc.cas_blocks(flat_a.reshape(-1, lanes).contiguous(),
                            flat_b.reshape(-1, lanes).contiguous(),
                            width=width)
    return lo.reshape(-1)[:n].reshape(shape), hi.reshape(-1)[:n].reshape(shape)
