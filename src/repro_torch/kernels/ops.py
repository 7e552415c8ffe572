"""Entry points of the ``cuda`` backend over the bitonic kernel (K1).

Handles what the kernel does not: arbitrary axes and leading dims,
power-of-two padding with the direction's sentinel, and autodiff.  A sort
runs the key-value network with an index payload, so it also yields the
permutation its gradient needs: a sort is a permutation, and its
transpose scatter-adds the cotangent back (``torch.autograd.Function``,
the counterpart of the JAX package's ``custom_vjp``).
"""
from __future__ import annotations

import torch

from repro_torch.core.sortspec import index_rows, next_pow2
from repro_torch.kernels import bitonic_sort as _bs


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
