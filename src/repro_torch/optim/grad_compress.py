"""Error-feedback gradient compression.

The port of the JAX package's ``optim/grad_compress.py``: the codec runs
compress -> decompress around the optimizer, so the numbers a compressed
all-reduce would deliver are reproduced on one device, with error
feedback (Karimireddy et al. 2019): e_{t+1} = g_t + e_t - D(C(g_t + e_t)).

Two codecs:
  * int8 — a per-tensor scale, 4x under the float32 wire format;
  * topk — exactly k = max(1, floor(n * frac)) largest-|g| lanes of each
    tensor kept, the rest zeroed; the top-k runs through the port's front
    door (``repro_torch.sort.topk``, ``sort_method``), and the kept lanes
    are scattered back from its indices (never a threshold compare).

The error buffer lives in the optimizer state under ``_ef`` and is updated
in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as _tree


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    codec: str = "int8"          # int8 | topk
    topk_frac: float = 0.125
    # "auto": the k-aware planner prices selection, K5 and sort-prefix for
    # each tensor's (n, k)
    sort_method: str = "auto"


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    # divided by a tensor: on the card a Python scalar divisor becomes a
    # product with its reciprocal, which can round a lane differently
    scale = torch.clamp(g.abs().max(), min=1e-12) \
        / torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def topk_budget(n: int, frac: float) -> int:
    """The exact element budget the top-k codec keeps (and prices)."""
    return max(1, int(n * frac))


def _topk_roundtrip(g: torch.Tensor, frac: float, method: str
                    ) -> torch.Tensor:
    """Keep exactly k = max(1, floor(n * frac)) largest-|g| lanes: an
    exact-k scatter from the top-k indices (ties at the threshold keep k
    lanes, a zero k-th magnitude keeps k lanes)."""
    from repro_torch import sort as sorting
    flat = g.reshape(-1)
    k = topk_budget(flat.shape[0], frac)
    _, idx = sorting.topk(flat.abs(), k, method=method, device=flat.device)
    idx = idx.to(torch.int64)
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(g.shape)


def make_compressor(cfg: CompressorConfig):
    """``(init_state, apply)`` for ``steps.build_train_step``'s
    ``grad_compressor`` hook: ``grads', opt_state' = apply(grads,
    opt_state)``.  ``init_state(params)`` gives ``{"_ef": zeros}`` to merge
    into the optimizer state."""
    if cfg.codec not in ("int8", "topk"):
        raise ValueError(f"unknown codec {cfg.codec!r} (int8 | topk)")

    def init_state(params):
        return {"_ef": _tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def roundtrip(g):
        if cfg.codec == "int8":
            return _int8_roundtrip(g)
        return _topk_roundtrip(g, cfg.topk_frac, cfg.sort_method)

    def apply(grads, opt_state):
        sent = []
        with torch.no_grad():
            for g, e in zip(_tree.leaves(grads),
                            _tree.leaves(opt_state["_ef"])):
                e.add_(g.to(torch.float32))          # corrected = g + e
                s = roundtrip(e)
                e.sub_(s)                            # e' = corrected - sent
                sent.append(s)
        return _tree.unflatten(grads, sent), dict(opt_state)

    return init_state, apply


def wire_bytes(n_params: int, codec: str, topk_frac: float = 0.125) -> int:
    """Bytes on the wire a step for the gradient all-reduce; the top-k
    bill uses the budget the codec enforces."""
    if codec == "int8":
        return n_params * 1 + 4  # values + scale
    return topk_budget(n_params, topk_frac) * (4 + 4)   # value + index
