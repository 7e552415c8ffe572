"""Attention: MHA/GQA/MQA with RoPE/M-RoPE, causal + sliding-window masks,
cross-attention (enc-dec), and a prefill/decode KV cache.

The port of the JAX package's ``models/attention.py`` on one device: the
``policy`` (sharding) arguments are gone, so the stored kv-head count is
``n_kv_heads * kv_repeat`` with ``kv_repeat`` 1 unless a caller sets it.

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


def _attend(cfg: AttentionConfig, q, k, v, mask):
    """q: (B,S,N,H); k/v: (B,T,R,H); mask: (B,1,S,T) or None -> (B,S,N,H).

    Grouped-query attention with the BLOCKED head grouping: q head
    ``r * g + j`` reads kv head r.  The logits are formed in q's dtype and
    cast to float32 for the softmax; the output is cast back to q's dtype.
    """
    b, s, n, h = q.shape
    t, r = k.shape[1], k.shape[2]
    g = n // r
    q = q.reshape(b, s, r, g, h)
    scale = 1.0 / math.sqrt(h)
    logits = torch.einsum("bsrgh,btrh->brgst", q, k) * scale
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask[:, None] if mask.dim() == 4 else mask,
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("brgst,btrh->bsrgh", probs, v)
    return out.reshape(b, s, n, h)


def _attend_q_chunked(cfg: AttentionConfig, q, k, v, q_chunk: int):
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
                            m[None, None]))
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
          use_flash: bool = False):
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
    q = (x @ params["wq"]).reshape(b, s, n, h)
    k = (src @ params["wk"]).reshape(b, src.shape[1], cfg.n_kv_heads, h)
    v = (src @ params["wv"]).reshape(b, src.shape[1], cfg.n_kv_heads, h)
    if kv is None:                       # self-attention: rotary applies
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    k = _repeat_kv(cfg, k)
    v = _repeat_kv(cfg, v)
    self_causal = cfg.causal and kv is None
    if use_flash and self_causal:
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=True, window=cfg.window)
    elif self_causal and s > 2048 and s % 1024 == 0:
        out = _attend_q_chunked(cfg, q, k, v, q_chunk=1024)
    else:
        mask = causal_mask(s, window=cfg.window, device=x.device) \
            if self_causal else None
        out = _attend(cfg, q, k, v, mask)
    out = out.reshape(b, s, n * h)
    return out @ params["wo"], KVCache(k=k, v=v)


def init_cache(cfg: AttentionConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, length, cfg.r_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params, cfg: AttentionConfig, x, cache: KVCache, t):
    """Single-token decode. x: (B, 1, D); t: 0-dim int tensor, the current
    position, rotated as positions (B, 1), or (3, B, 1) under M-RoPE (t = h
    = w).  Writes the new K/V into ``cache`` in place (ring slot t mod
    window on sliding-window layers) and returns (out, cache)."""
    b = x.shape[0]
    n, h = cfg.n_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, 1, n, h)
    k = (x @ params["wk"]).reshape(b, 1, cfg.n_kv_heads, h)
    v = (x @ params["wv"]).reshape(b, 1, cfg.n_kv_heads, h)
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
    cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v.to(cache.v.dtype))

    kpos = torch.arange(s_cache, device=x.device)
    if cfg.window:
        # ring buffer: valid if the stored position is within the window
        stored_pos = kpos + (t - slot) - torch.where(kpos > slot, s_cache, 0)
        valid = (stored_pos >= 0) & (stored_pos <= t) & \
                (stored_pos > t - cfg.window)
    else:
        valid = kpos <= t
    mask = valid[None, None, None, :]    # (1,1,1,S_cache)
    out = _attend(cfg, q, cache.k, cache.v, mask)
    out = out.reshape(b, 1, n * h)
    return out @ params["wo"], cache
