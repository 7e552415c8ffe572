"""Mixture-of-Experts with sort-based token routing.

The port of the JAX package's ``models/moe.py`` on one device:

  1. router logits (float32) -> softmax -> top-k experts per token through
     the port's front door (``repro_torch.sort.topk``, ``cfg.router_method``;
     on the card ``auto`` plans K5's short-row kernel for rows of a few
     dozen experts), gates renormalised to sum to one;
  2. each (token, expert) pair's arrival rank within its expert, per batch
     row, by ``relational.group_ranks`` (the counting sort of small
     domains);
  3. pairs scattered into a static-capacity (B, E * C + 1, D) buffer (slot
     ``expert * C + rank``; a pair past capacity lands in the last slot,
     which is dropped);
  4. batched expert products (E, C, D) x (E, D, F), plain ``torch.einsum``
     (the reference computes them outside any Pallas kernel);
  5. outputs gathered back by slot, weighted by the gates and summed over
     each token's k pairs; the shared experts add a dense MLP.

Aux losses as the reference: the Switch load-balance loss and the router
z-loss.  The gates carry a gradient where the top-k backend gives one
(``torch``, ``cuda``, ``merge``, ``bitonic``); ``select`` and ``radix``
return values without a ``grad_fn`` (the reference's give a zero
gradient), and the router still learns through ``probs`` in the aux
losses.

Determinism on the card: the dispatch adds each pair into its own slot
(slots are unique but for the dropped overflow slot), and the backward of
the gather adds each token's gradient into its slot plus signed zeros from
dropped pairs, whose sum does not depend on their order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import relational
from repro_torch import sort as sorting
from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers


def init(gen: torch.Generator, d_model: int, cfg: MoEConfig, mlp_type: str,
         dtype, lead=()):
    """The layer's parameters (``lead`` stacks layers): a float32 router
    ``(d, E)`` and expert weights ``(E, d, F)`` / ``(E, F, d)`` in
    ``dtype``, plus ``shared`` (a dense MLP of ``n_shared_experts * F``)."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    gated = mlp_type in ("swiglu", "geglu")
    std_in, std_out = 1 / math.sqrt(d_model), 1 / math.sqrt(f)
    params = {
        "router": layers.truncnorm_init(gen, (*lead, d_model, e), std_in,
                                        torch.float32),
        "wi": layers.truncnorm_init(gen, (*lead, e, d_model, f), std_in,
                                    dtype),
        "wo": layers.truncnorm_init(gen, (*lead, e, f, d_model), std_out,
                                    dtype),
    }
    if gated:
        params["wg"] = layers.truncnorm_init(gen, (*lead, e, d_model, f),
                                             std_in, dtype)
    if cfg.n_shared_experts:
        params["shared"] = layers.mlp_init(
            gen, d_model, cfg.n_shared_experts * f, mlp_type, dtype, lead)
    return params


def capacity(tokens_local: int, cfg: MoEConfig) -> int:
    if tokens_local <= cfg.n_experts:
        # decode / tiny-batch regime: capacity = T guarantees zero drops
        # (an expert can receive at most T assignments)
        return tokens_local
    c = int(math.ceil(tokens_local * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, cfg.top_k)


def route(params, x: torch.Tensor, cfg: MoEConfig):
    """Steps 1-2 -> (gate values (B, S*k) float32, expert ids (B, S*k)
    int32, slots (B, S*k) int64, keep (B, S*k) bool, capacity, aux)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    rl = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(rl, dim=-1)
    gate_v, gate_i = sorting.topk(probs, k, method=cfg.router_method,
                                  device=probs.device)
    gate_v = gate_v / (gate_v.sum(dim=-1, keepdim=True) + 1e-9)

    # aux: load balance (Switch) + router z-loss
    onehot_sel = F.one_hot(gate_i.to(torch.int64), e).to(torch.float32)
    dispatch_frac = onehot_sel.sum(dim=2).mean(dim=(0, 1)) / k
    mean_prob = probs.mean(dim=(0, 1))
    lb_loss = e * (dispatch_frac * mean_prob).sum()
    z_loss = torch.logsumexp(rl, dim=-1).square().mean()

    # (token, expert) pairs in (token-major, k-minor) order: pair p belongs
    # to token p // k; each pair's arrival rank within its expert
    flat_e = gate_i.reshape(b, s * k)
    flat_g = gate_v.reshape(b, s * k)
    pos = relational.group_ranks(flat_e, e, device=x.device).ranks
    cap = capacity(s, cfg)
    keep = pos < cap
    slot = torch.where(keep, flat_e.to(torch.int64) * cap + pos, e * cap)
    return flat_g, flat_e, slot, keep, cap, {"moe_lb_loss": lb_loss,
                                             "moe_z_loss": z_loss}


def apply(params, x: torch.Tensor, cfg: MoEConfig, mlp_type: str):
    """The MoE layer on ``x`` (B, S, D) -> (out (B, S, D), aux losses)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_g, _, slot, keep, cap, aux = route(params, x, cfg)

    # 3. dispatch into per-row expert buffers (B, E*C+1, D), flattened so
    # one index_add places every pair; the last slot of a row is dropped
    row = torch.arange(b, device=x.device)[:, None]
    xk = x.repeat_interleave(k, dim=1).reshape(b * s * k, d)
    buf = torch.zeros((b * (e * cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (slot + row * (e * cap + 1)).reshape(-1), xk)
    buf = buf.reshape(b, e * cap + 1, d)[:, :-1].reshape(b, e, cap, d)

    # 4. batched expert products
    act = layers._ACTS[mlp_type]
    h = torch.einsum("becd,edf->becf", buf, params["wi"])
    if "wg" in params:
        h = act(torch.einsum("becd,edf->becf", buf, params["wg"])) * h
    else:
        h = act(h)
    y = torch.einsum("becf,efd->becd", h, params["wo"])       # (B,E,C,D)

    # 5. gather each pair's output by slot, weight by its gate, sum the k
    # pairs of each token
    yf = y.reshape(b * e * cap, d)
    g_idx = torch.where(keep, slot, 0) + row * (e * cap)
    gathered = yf.index_select(0, g_idx.reshape(-1)).reshape(b, s * k, d)
    contrib = gathered * (flat_g * keep).to(yf.dtype)[..., None]
    out = contrib.reshape(b, s, k, d).sum(dim=2)

    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(params["shared"], x, mlp_type)
    return out, aux
