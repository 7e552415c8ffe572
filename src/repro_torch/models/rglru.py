"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``.  Two parallel
projections of the residual stream: one passes through a short causal
conv1d and the Real-Gated Linear Recurrent Unit, the other is a GeLU gate;
their product is projected back to d_model.

RG-LRU recurrence (float32):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(c * r_t * log_a)            log_a = -8 * softplus(lambda) <= 0
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the recurrence with :func:`associative_scan`, the
reference's ``jax.lax.associative_scan`` written in PyTorch ops (the same
odd/even recursion: O(S) work, O(log S) depth, the same products in the
same order); decode is the O(1) update.  ``b_a``, ``b_i`` and ``lam`` stay
float32 in every model dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models import layers
from repro_torch.sharding.partitioning import P

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) float32 recurrent state
    conv: torch.Tensor       # (B, conv_width - 1, W)


def init(gen: torch.Generator, d_model: int, width: int, cfg: RGLRUConfig,
         dtype, lead=()):
    dev = gen.device

    def f32(t):
        return t.to(device=dev).expand(*lead, width).clone()

    # lambda via inverse softplus, so that a^c spans ~(0.9, 0.999)
    lin = torch.linspace(0.9, 0.999, width, dtype=torch.float32)
    lam = torch.log(torch.expm1(lin ** -(1.0 / _C) - 1.0 + 1e-8))
    return {
        "in_x": layers.dense_init(gen, d_model, width, dtype, lead=lead),
        "in_gate": layers.dense_init(gen, d_model, width, dtype, lead=lead),
        "conv_w": layers.dense_init(gen, cfg.conv_width, width, dtype,
                                    lead=lead),
        "conv_b": torch.zeros((*lead, width), dtype=dtype, device=dev),
        "w_a": layers.dense_init(gen, width, width, dtype, lead=lead),
        "b_a": f32(torch.zeros(width)),
        "w_i": layers.dense_init(gen, width, width, dtype, lead=lead),
        "b_i": f32(torch.zeros(width)),
        "lam": f32(lam),
        "out": layers.dense_init(gen, width, d_model, dtype, lead=lead),
    }


def specs():
    """The reference's specs of ``init``'s tree."""
    return {"in_x": P("data", "model"), "in_gate": P("data", "model"),
            "conv_w": P(None, "model"), "conv_b": P("model"),
            "w_a": P("data", "model"), "b_a": P(None),
            "w_i": P("data", "model"), "b_i": P(None),
            "lam": P(None), "out": P("model", "data")}


def _gates(params, xw):
    """xw: (..., W) conv output -> (a_t, gated input), float32."""
    x32 = xw.float()
    r = torch.sigmoid(x32 @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(x32 @ params["w_i"].float() + params["b_i"])
    log_a = -_C * layers.softplus(params["lam"])            # (W,) <= 0
    a = torch.exp(r * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)
    return a, gated


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps h -> a h + b under
    ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``: returns (the
    running products of a, the running h from h = 0).  The recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_l, b_l = a[:, 0:-1:2], b[:, 0:-1:2]
    a_r, b_r = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = associative_scan(a_l * a_r, a_r * b_l + b_r)
    a_e, b_e = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        odd_a_l, odd_b_l = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_l, odd_b_l = odd_a, odd_b
    even_a = torch.cat([a[:, :1], odd_a_l * a_e], dim=1)
    even_b = torch.cat([b[:, :1], a_e * odd_b_l + b_e], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def apply(params, x, width: int, cfg: RGLRUConfig,
          init_state: RGLRUState = None,
          policy=None) -> Tuple[torch.Tensor, RGLRUState]:
    """Full-sequence block. x: (B,S,D) -> (out, final state).  With a
    policy on a mesh the whole block runs on each rank's batch rows
    (``policy.run_rows``)."""
    if policy is not None and policy.places:
        return policy.run_rows(
            lambda p, xl, st: apply(p, xl, width, cfg, st), params, x,
            init_state, RGLRUState)
    xb = x @ params["in_x"]
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    xw, conv_tail = layers.conv1d(
        params, xb, cfg.conv_width,
        None if init_state is None else init_state.conv)
    a, gated = _gates(params, xw)                           # (B,S,W) float32
    if init_state is not None:
        # fold h0 in by treating it as an extra leading element
        gated = gated.clone()
        gated[:, 0, :] += a[:, 0, :] * init_state.h
    _, h = associative_scan(a, gated)
    final = RGLRUState(h=h[:, -1, :], conv=conv_tail)
    y = h.to(x.dtype) * gate
    return y @ params["out"], final


def init_state(width: int, cfg: RGLRUConfig, batch: int, dtype,
               device) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, width), dtype=dtype,
                         device=device))


def decode_step(params, x, width: int, cfg: RGLRUConfig, st: RGLRUState
                ) -> Tuple[torch.Tensor, RGLRUState]:
    """Single-token update. x: (B,1,D) -> (out, new state)."""
    xb = x @ params["in_x"]
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    xw, conv_tail = layers.conv1d(params, xb, cfg.conv_width, st.conv)
    a, gated = _gates(params, xw[:, 0, :])
    h = a * st.h + gated
    y = h[:, None, :].to(x.dtype) * gate
    return y @ params["out"], RGLRUState(h=h, conv=conv_tail)
