"""Mixture-of-Experts with sort-based token routing.

The port of the JAX package's ``models/moe.py``:

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

With a sharding policy the layer runs as the reference's does under its
constraints: steps 1-3 (routing, its K5 top-k and its ``autograd.Function``,
the ranks and the dispatch's ``index_add``) run in one ``policy.run_local``
region on each rank's batch rows, whose routing logits are ``(dp, None,
None)`` so each row's top-k is local; the buffer is sliced on the expert
axis (``(dp, model, None, None)``, the EP slice) for the expert products
on the DTensor weights, gathered back (``(dp, None, None, None)``, the EP
combine), and step 5 runs in a second region.  The aux losses' means come
out of the first region as partial sums over the batch shards.

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
from repro_torch.sharding.partitioning import P


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


def specs(cfg: MoEConfig, mlp_type: str):
    """The reference's specs of ``init``'s tree: experts on 'model'."""
    out = {"router": P("data", None), "wi": P("model", "data", None),
           "wo": P("model", None, "data")}
    if mlp_type in ("swiglu", "geglu"):
        out["wg"] = P("model", "data", None)
    if cfg.n_shared_experts:
        out["shared"] = layers.mlp_specs(mlp_type)
    return out


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
    flat_g, flat_e, slot, keep, cap, (frac, mean_prob, z_loss) = \
        _route(params, x, cfg)
    lb_loss = cfg.n_experts * (frac * mean_prob).sum()
    return flat_g, flat_e, slot, keep, cap, {"moe_lb_loss": lb_loss,
                                             "moe_z_loss": z_loss}


def _route(params, x: torch.Tensor, cfg: MoEConfig):
    """``route`` with its aux terms apart: the dispatch fraction and mean
    probability an expert (E,) and the z-loss, each a mean over ``x``'s
    tokens."""
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
    z_loss = torch.logsumexp(rl, dim=-1).square().mean()

    # (token, expert) pairs in (token-major, k-minor) order: pair p belongs
    # to token p // k; each pair's arrival rank within its expert
    flat_e = gate_i.reshape(b, s * k)
    flat_g = gate_v.reshape(b, s * k)
    pos = relational.group_ranks(flat_e, e, device=x.device).ranks
    cap = capacity(s, cfg)
    keep = pos < cap
    slot = torch.where(keep, flat_e.to(torch.int64) * cap + pos, e * cap)
    return flat_g, flat_e, slot, keep, cap, (dispatch_frac, mean_prob,
                                             z_loss)


def _dispatch(x: torch.Tensor, slot, cap: int, cfg: MoEConfig):
    """Step 3: x's pairs into per-row expert buffers (B, E, C, D)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    # one index_add over (B, E*C+1, D) flattened places every pair; the
    # last slot of a row is dropped
    row = torch.arange(b, device=x.device)[:, None]
    xk = x.repeat_interleave(k, dim=1).reshape(b * s * k, d)
    buf = torch.zeros((b * (e * cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (slot + row * (e * cap + 1)).reshape(-1), xk)
    return buf.reshape(b, e * cap + 1, d)[:, :-1].reshape(b, e, cap, d)


def _experts(params, buf, mlp_type: str):
    """Step 4: the batched expert products (B, E, C, D) -> (B, E, C, D)."""
    act = layers._ACTS[mlp_type]
    h = torch.einsum("becd,edf->becf", buf, params["wi"])
    if "wg" in params:
        h = act(torch.einsum("becd,edf->becf", buf, params["wg"])) * h
    else:
        h = act(h)
    return torch.einsum("becf,efd->becd", h, params["wo"])


def _combine(y, slot, keep, flat_g, cfg: MoEConfig):
    """Step 5: each pair's output gathered by slot, weighted by its gate,
    the k pairs of each token summed -> (B, S, D)."""
    b, e, cap, d = y.shape
    k = cfg.top_k
    s = slot.shape[1] // k
    row = torch.arange(b, device=y.device)[:, None]
    yf = y.reshape(b * e * cap, d)
    g_idx = torch.where(keep, slot, 0) + row * (e * cap)
    gathered = yf.index_select(0, g_idx.reshape(-1)).reshape(b, s * k, d)
    contrib = gathered * (flat_g * keep).to(yf.dtype)[..., None]
    return contrib.reshape(b, s, k, d).sum(dim=2)


def apply(params, x: torch.Tensor, cfg: MoEConfig, mlp_type: str,
          policy=None):
    """The MoE layer on ``x`` (B, S, D) -> (out (B, S, D), aux losses)."""
    if policy is not None and policy.places:
        return _apply_sharded(params, x, cfg, mlp_type, policy)
    flat_g, _, slot, keep, cap, aux = route(params, x, cfg)
    buf = _dispatch(x, slot, cap, cfg)
    y = _experts(params, buf, mlp_type)                       # (B,E,C,D)
    out = _combine(y, slot, keep, flat_g, cfg)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(params["shared"], x, mlp_type)
    return out, aux


def _apply_sharded(params, x, cfg: MoEConfig, mlp_type: str, policy):
    """``apply`` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate
    b, s, d = x.shape
    dp, tpa = policy.dp_axes, policy.tp_axis
    act_spec = policy._sanitize(P(dp, None, None), x.shape)
    x = policy._constrain(x, act_spec)
    # the mesh dimensions that split the batch: the aux means are partial
    # sums over them
    split = [i for i, p in enumerate(x.placements) if p.is_shard()]
    shards = 1
    for i in split:
        shards *= x.device_mesh.size(i)
    part = tuple(Partial() if i in split else Replicate()
                 for i in range(x.device_mesh.ndim))
    cap = capacity(s, cfg)
    rows = P(dp, None)

    def local_route(xl, router):
        flat_g, _, slot, keep, _, (frac, mean_prob, z) = _route(
            {"router": router}, xl, cfg)
        buf = _dispatch(xl, slot, cap, cfg)
        return (buf, flat_g, slot, keep, frac / shards, mean_prob / shards,
                z / shards)

    buf, flat_g, slot, keep, frac, mean_prob, z_loss = policy.run_local(
        local_route, (x, params["router"]), (act_spec, P()),
        [P(dp, None, None, None), rows, rows, rows, part, part, part],
        grad_partial=(1,))
    buf = policy._constrain(buf, P(dp, tpa, None, None))      # EP slice
    y = _experts(params, buf, mlp_type)
    y = policy._constrain(y, P(dp, None, None, None))         # EP combine
    out = policy.run_local(
        lambda yl, sl, kl, gl: _combine(yl, sl, kl, gl, cfg),
        (y, slot, keep, flat_g),
        (P(dp, None, None, None), rows, rows, rows), act_spec)
    out = policy._constrain(out, act_spec)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(params["shared"], x, mlp_type)
    lb_loss = cfg.n_experts * (frac * mean_prob).sum()
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
