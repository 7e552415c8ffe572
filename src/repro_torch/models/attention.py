"""Attention: MHA/GQA/MQA with RoPE/M-RoPE, causal + sliding-window masks,
cross-attention (enc-dec), and a prefill/decode KV cache.

The port of the JAX package's ``models/attention.py``.  The stored kv-head
count is ``n_kv_heads * kv_repeat``; the model sets ``kv_repeat`` from its
sharding policy (``policy.kv_repeat``: repeat-to-TP), 1 without one.  With
a ``policy`` the heads, scores and cache are constrained as the
reference's are (``shard_heads``, ``shard_scores``, ``shard_cache``) and
K6 runs on each rank's shard (``policy.run_sharded_flash``); without one
nothing here changes.

KV-cache layout: ``(B, S_cache, R, head_dim)``.  Sliding-window layers keep
only ``window`` positions (a ring buffer, slot = t mod window).  Unlike the
reference, ``decode_step`` writes the new position into the cache in place
and returns the same tensors: the functional copy would cost a whole cache
read and write per layer and token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models import layers
from repro_torch.sharding.partitioning import (P, is_dtensor, local_tensor,
                                               pin_grad, shard_offset,
                                               splittable)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, R, H)
    v: torch.Tensor          # (B, S_cache, R, H)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_type: str = "standard"        # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    causal: bool = True
    window: int = 0                    # 0 = global
    kv_repeat: int = 1                 # R = n_kv_heads * kv_repeat

    @property
    def r_heads(self) -> int:
        return self.n_kv_heads * self.kv_repeat


def init(gen: torch.Generator, cfg: AttentionConfig, dtype, lead=()):
    d, n, k, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, d, n * h, dtype, lead=lead),
        "wk": layers.dense_init(gen, d, k * h, dtype, lead=lead),
        "wv": layers.dense_init(gen, d, k * h, dtype, lead=lead),
        "wo": layers.dense_init(gen, n * h, d, dtype, lead=lead),
    }


def specs():
    """The reference's specs of ``init``'s tree."""
    return {"wq": P("data", "model"), "wk": P("data", "model"),
            "wv": P("data", "model"), "wo": P("model", "data")}


def _rope(cfg: AttentionConfig, x, positions):
    if cfg.rope_type == "none" or positions is None:
        return x
    if cfg.rope_type == "mrope":
        return layers.apply_mrope(x, positions, cfg.rope_theta,
                                  cfg.mrope_sections)
    return layers.apply_rope(x, positions, cfg.rope_theta)


def _repeat_kv(cfg: AttentionConfig, x):
    if cfg.kv_repeat == 1:
        return x
    return torch.repeat_interleave(x, cfg.kv_repeat, dim=2)


def _attend(cfg: AttentionConfig, q, k, v, mask, policy=None):
    """q: (B,S,N,H); k/v: (B,T,R,H); mask: (B,1,S,T) or None -> (B,S,N,H).

    Grouped-query attention with the BLOCKED head grouping: q head
    ``r * g + j`` reads kv head r.  The logits are formed in q's dtype and
    cast to float32 for the softmax; the output is cast back to q's dtype.
    """
    if policy is not None and policy.places and is_dtensor(q):
        return _attend_local(cfg, q, k, v, mask, policy)
    b, s, n, h = q.shape
    t, r = k.shape[1], k.shape[2]
    g = n // r
    q = q.reshape(b, s, r, g, h)
    scale = 1.0 / math.sqrt(h)
    logits = torch.einsum("bsrgh,btrh->brgst", q, k) * scale
    logits = logits.float()
    if policy is not None:
        logits = policy.shard_scores(logits)
    if mask is not None:
        logits = torch.where(mask[:, None] if mask.dim() == 4 else mask,
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if policy is not None:
        probs = policy.shard_scores(probs)
    out = torch.einsum("brgst,btrh->bsrgh", probs, v)
    return out.reshape(b, s, n, h)


def _attend_local(cfg: AttentionConfig, q, k, v, mask, policy):
    """``_attend`` on DTensors: each rank runs it on its (batch, kv-head)
    block, the scores placed as the reference's ``shard_scores`` places
    them (batch on DP, the kv-head axis on TP where it divides): DTensor's
    einsum would fold the sharded head axis into the batch of a ``bmm``
    it cannot place."""
    r = k.shape[2]
    tp = policy.tp_axis if policy.tp_size > 1 and r % policy.tp_size == 0 \
        else None
    spec = P(policy.dp_axes, None, tp, None)
    qspec = policy._sanitize(spec, q.shape)
    kspec = policy._sanitize(spec, k.shape)
    if (qspec[2] is None) != (kspec[2] is None):
        qspec = policy._sanitize(P(policy.dp_axes, None, None, None),
                                 q.shape)
        kspec = policy._sanitize(P(policy.dp_axes, None, None, None),
                                 k.shape)
    if mask is None:
        return policy.run_local(
            lambda a, b_, c: _attend(cfg, a, b_, c, None), (q, k, v),
            (qspec, kspec, kspec), qspec)
    return policy.run_local(
        lambda a, b_, c, m: _attend(cfg, a, b_, c, m), (q, k, v, mask),
        (qspec, kspec, kspec, P()), qspec)


def _attend_q_chunked(cfg: AttentionConfig, q, k, v, q_chunk: int,
                      policy=None):
    """Causal/windowed self-attention a block of queries at a time: the
    live score block is (B, heads, q_chunk, S), never S x S."""
    b, s, n, h = q.shape
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // q_chunk):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        m = kpos[None, :] <= qpos[:, None]
        if cfg.window:
            m &= kpos[None, :] > qpos[:, None] - cfg.window
        outs.append(_attend(cfg, q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                            m[None, None], policy))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t_offset: int = 0, window: int = 0, device=None):
    """(1, 1, S, S+t_offset) boolean mask; True = attend."""
    qpos = torch.arange(s, device=device)[:, None] + t_offset
    kpos = torch.arange(s + t_offset, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None]


def apply(params, cfg: AttentionConfig, x, positions=None, *, kv=None,
          use_flash: bool = False, policy=None):
    """Full-sequence attention (prefill, training, the encoder).

    kv: the source hidden states of a cross-attention (no rotary).
    use_flash: causal self-attention through K6
    (``kernels.flash_attention``; forward-only), as the reference routes
    only that case to its flash kernel.  Returns (out, KVCache(k, v)) — the
    repeated K/V for the cache.
    """
    b, s, _ = x.shape
    n, h = cfg.n_heads, cfg.head_dim
    src = x if kv is None else kv
    q = splittable(layers.matmul(x, params["wq"]), 2, n).reshape(
        b, s, n, h)
    k = splittable(layers.matmul(src, params["wk"]), 2,
                   cfg.n_kv_heads).reshape(
        b, src.shape[1], cfg.n_kv_heads, h)
    v = splittable(layers.matmul(src, params["wv"]), 2,
                   cfg.n_kv_heads).reshape(
        b, src.shape[1], cfg.n_kv_heads, h)
    if kv is None:                       # self-attention: rotary applies
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    k = _repeat_kv(cfg, k)
    v = _repeat_kv(cfg, v)
    if policy is not None:
        q = policy.shard_heads(q)
        k = policy.shard_heads(k)
        v = policy.shard_heads(v)
    self_causal = cfg.causal and kv is None
    if use_flash and self_causal:
        if policy is not None:
            out = policy.run_sharded_flash(q, k, v, causal=True,
                                           window=cfg.window)
        else:
            from repro_torch.kernels.flash_attention import flash_attention
            out = flash_attention(q, k, v, causal=True, window=cfg.window)
    elif self_causal and s > 2048 and s % 1024 == 0:
        out = _attend_q_chunked(cfg, q, k, v, q_chunk=1024, policy=policy)
    else:
        mask = causal_mask(s, window=cfg.window, device=x.device) \
            if self_causal else None
        out = _attend(cfg, q, k, v, mask, policy)
    out = pin_grad(out.reshape(b, s, n * h))
    return layers.matmul(out, params["wo"]), KVCache(k=k, v=v)


def init_cache(cfg: AttentionConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, length, cfg.r_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _write_slot(dst, new, idx):
    """``dst[:, idx] = new`` in place (idx: a 1-element int64 tensor); a
    DTensor cache writes into each rank's shard, ``new`` placed as the
    cache is (its sequence dimension, when the cache shards it, kept
    whole: the rank that holds the slot writes it)."""
    if not is_dtensor(dst):
        dst.index_copy_(1, idx, new)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pl = tuple(dst.placements)
    new_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
    new = new.redistribute(mesh, new_pl).to_local()
    local = dst.to_local()
    idx = local_tensor(idx)
    if Shard(1) not in pl:
        local.index_copy_(1, idx, new)
        return
    n = local.shape[1]
    rel = idx - shard_offset(pl, 1, mesh, dst.shape[1])
    inside = (rel >= 0) & (rel < n)
    rel = rel.clamp(0, n - 1)
    local.index_copy_(1, rel, torch.where(inside, new,
                                          local.index_select(1, rel)))


def decode_step(params, cfg: AttentionConfig, x, cache: KVCache, t,
                policy=None):
    """Single-token decode. x: (B, 1, D); t: 0-dim int tensor, the current
    position, rotated as positions (B, 1), or (3, B, 1) under M-RoPE (t = h
    = w).  Writes the new K/V into ``cache`` in place (ring slot t mod
    window on sliding-window layers) and returns (out, cache)."""
    b = x.shape[0]
    n, h = cfg.n_heads, cfg.head_dim
    q = splittable(x @ params["wq"], 2, n).reshape(b, 1, n, h)
    k = splittable(x @ params["wk"], 2, cfg.n_kv_heads).reshape(
        b, 1, cfg.n_kv_heads, h)
    v = splittable(x @ params["wv"], 2, cfg.n_kv_heads).reshape(
        b, 1, cfg.n_kv_heads, h)
    t = torch.as_tensor(t, device=x.device)
    lead = (3, b, 1) if cfg.rope_type == "mrope" else (b, 1)
    positions = t.to(torch.int32).expand(*lead)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    k = _repeat_kv(cfg, k)
    v = _repeat_kv(cfg, v)

    s_cache = cache.k.shape[1]
    slot = torch.remainder(t, s_cache) if cfg.window else t
    idx = slot.to(torch.int64).reshape(1)
    _write_slot(cache.k, k.to(cache.k.dtype), idx)
    _write_slot(cache.v, v.to(cache.v.dtype), idx)

    kpos = torch.arange(s_cache, device=x.device)
    if cfg.window:
        # ring buffer: valid if the stored position is within the window
        stored_pos = kpos + (t - slot) - torch.where(kpos > slot, s_cache, 0)
        valid = (stored_pos >= 0) & (stored_pos <= t) & \
                (stored_pos > t - cfg.window)
    else:
        valid = kpos <= t
    mask = valid[None, None, None, :]    # (1,1,1,S_cache)
    k_all, v_all = cache.k, cache.v
    if policy is not None:
        k_all, v_all = policy.shard_cache(k_all), policy.shard_cache(v_all)
    out = _attend(cfg, q, k_all, v_all, mask, policy)
    out = out.reshape(b, 1, n * h)
    return out @ params["wo"], cache
