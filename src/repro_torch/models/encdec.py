"""Whisper-style encoder-decoder (whisper-tiny backbone).

The port of the JAX package's ``models/encdec.py``.  The conv/mel audio
frontend is a stub, as there: the encoder takes precomputed frame
embeddings (B, S_enc, d_model).  Positions are fixed sinusoids on both
sides (the decoder's learned embedding approximated by the same
sinusoids).  LayerNorm + GELU + MHA (n_kv == n_heads), pre-norm; no
rotary, and no attention here goes through K6 (the reference sends only
the decoder-only stacks' causal self-attention to its flash kernel).

Training keeps only each encoder and decoder layer's inputs while a
gradient is taken (``remat``, on by default as in the reference).

With a sharding ``policy`` the parameters are DTensors placed by
``param_specs``, the residual stream is constrained after the encoder's
input and each layer (``shard_activations``), attention takes the
policy's hooks and the loss's logits stay vocab-sharded, as in the
reference.

Decode keeps two caches a decoder layer: the self-attention KV cache
(updated in place) and the cross-attention K/V computed once from the
encoder output by ``prefill`` and frozen.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.transformer import (_fill_local, place_state,
                                            remat_active, sharded)
from repro_torch.sharding.partitioning import is_dtensor


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32: sin of the first half of the
    frequencies, cos of the second."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


@dataclasses.dataclass
class EncDecTransformer:
    cfg: ModelConfig
    device: torch.device
    remat: bool = True
    policy: Any = None               # ShardingPolicy or None

    def __post_init__(self):
        self.device = torch.device(self.device)
        cfg = self.cfg
        kvr = 1
        if self.policy is not None:
            kvr = self.policy.kv_repeat(cfg.n_kv_heads, cfg.n_heads)
        base = dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, rope_type="none",
                    kv_repeat=kvr)
        self.enc_attn = attention.AttentionConfig(causal=False, **base)
        self.dec_attn = attention.AttentionConfig(causal=True, **base)
        self.cross_attn = attention.AttentionConfig(causal=False, **base)

    # ---------------------------------------------------------------- init
    def _norm(self):
        return layers.layernorm_init(self.cfg.d_model, self.cfg.param_dtype(),
                                     self.device)

    def _mlp(self, gen):
        cfg = self.cfg
        return layers.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu",
                               cfg.param_dtype())

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters from ``gen`` (a generator on the model's
        device), in the reference's tree layout."""
        cfg = self.cfg
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = cfg.param_dtype()
        params: Dict[str, Any] = {"enc": [], "dec": []}
        for _ in range(cfg.n_enc_layers):
            params["enc"].append({
                "ln1": self._norm(),
                "attn": attention.init(gen, self.enc_attn, dtype),
                "ln2": self._norm(), "mlp": self._mlp(gen)})
        for _ in range(cfg.n_layers):
            params["dec"].append({
                "ln1": self._norm(),
                "self_attn": attention.init(gen, self.dec_attn, dtype),
                "lnx": self._norm(),
                "cross_attn": attention.init(gen, self.cross_attn, dtype),
                "ln2": self._norm(), "mlp": self._mlp(gen)})
        params["embed"] = layers.embedding_init(gen, cfg.padded_vocab,
                                                cfg.d_model, dtype)
        params["enc_ln"] = self._norm()
        params["dec_ln"] = self._norm()
        return params

    def param_specs(self) -> Dict[str, Any]:
        """The reference's partition-spec tree of ``init``'s parameters."""
        cfg = self.cfg
        ln = layers.norm_specs("layernorm")
        return {
            "enc": [{"ln1": ln, "attn": attention.specs(), "ln2": ln,
                     "mlp": layers.mlp_specs("gelu")}
                    for _ in range(cfg.n_enc_layers)],
            "dec": [{"ln1": ln, "self_attn": attention.specs(), "lnx": ln,
                     "cross_attn": attention.specs(), "ln2": ln,
                     "mlp": layers.mlp_specs("gelu")}
                    for _ in range(cfg.n_layers)],
            "embed": layers.embedding_specs(tied=True),
            "enc_ln": ln, "dec_ln": ln}

    def _shard(self, x):
        return x if self.policy is None else \
            self.policy.shard_activations(x)

    # -------------------------------------------------------------- encoder
    def encode(self, params, frames):
        """frames: (B, S_enc, D) stubbed audio embeddings -> (B, S_enc, D).
        Each layer under ``checkpoint`` while a gradient is taken
        (``remat_active``)."""
        with sharded(self.policy):
            return self._encode(params, frames)

    def _encode(self, params, frames):
        x = frames.to(self.cfg.param_dtype())
        x = x + sinusoids(x.shape[1], x.shape[2], x.device).to(x.dtype)[None]
        x = self._shard(x)
        remat = remat_active(self.remat, params)
        for p in params["enc"]:
            x = (checkpoint(self._enc_layer, p, x, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else self._enc_layer(p, x))
        return layers.layernorm(params["enc_ln"], x)

    def _enc_layer(self, p, x):
        with sharded(self.policy):       # also in a remat recompute
            return self._enc_layer_body(p, x)

    def _enc_layer_body(self, p, x):
        h = layers.layernorm(p["ln1"], x)
        mix, _ = attention.apply(p["attn"], self.enc_attn, h,
                                 policy=self.policy)
        x = x + mix
        h2 = layers.layernorm(p["ln2"], x)
        return self._shard(x + layers.mlp_apply(p["mlp"], h2, "gelu"))

    # -------------------------------------------------------------- decoder
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, False, cfg.d_model,
                         self.policy)
        return x + sinusoids(tokens.shape[1], cfg.d_model,
                             x.device).to(x.dtype)[None]

    def _tail(self, p, x, cross):
        """The decoder layer after its self-attention: + cross-attention
        output, + the MLP of the second norm."""
        x = x + cross
        h2 = layers.layernorm(p["ln2"], x)
        return x + layers.mlp_apply(p["mlp"], h2, "gelu")

    def decode_hidden(self, params, tokens, enc_out):
        """The decoder over whole sequences -> (B, S, D); each layer under
        ``checkpoint`` while a gradient is taken."""
        with sharded(self.policy):
            return self._decode_hidden(params, tokens, enc_out)

    def _decode_hidden(self, params, tokens, enc_out):
        x = self._embed(params, tokens)
        remat = remat_active(self.remat, params)
        for p in params["dec"]:
            x = (checkpoint(self._dec_layer, p, x, enc_out,
                            use_reentrant=False, preserve_rng_state=False)
                 if remat else self._dec_layer(p, x, enc_out))
        return layers.layernorm(params["dec_ln"], x)

    def _dec_layer(self, p, x, enc_out):
        with sharded(self.policy):       # also in a remat recompute
            return self._dec_layer_body(p, x, enc_out)

    def _dec_layer_body(self, p, x, enc_out):
        h = layers.layernorm(p["ln1"], x)
        mix, _ = attention.apply(p["self_attn"], self.dec_attn, h,
                                 policy=self.policy)
        x = x + mix
        hx = layers.layernorm(p["lnx"], x)
        cross, _ = attention.apply(p["cross_attn"], self.cross_attn, hx,
                                   kv=enc_out, policy=self.policy)
        return self._shard(self._tail(p, x, cross))

    def _logits(self, params, hidden):
        return layers.logits_from_hidden(hidden, params["embed"], None,
                                         tie=True,
                                         true_vocab=self.cfg.vocab_size)

    def loss(self, params, batch):
        """batch: {frames, tokens, labels} -> (cross-entropy, aux)."""
        enc_out = self.encode(params, batch["frames"])
        hidden = self.decode_hidden(params, batch["tokens"], enc_out)
        with sharded(self.policy):
            ce = layers.cross_entropy_loss(self._logits(params, hidden),
                                           batch["labels"], self.policy)
        return ce, {"ce_loss": ce}

    # ------------------------------------------------------ prefill / decode
    def prefill(self, params, frames, tokens, max_len: int, state=None):
        """Encode ``frames``, run the prompt through the decoder, and build
        the decode state: a ``max_len``-deep self-attention cache and the
        frozen cross K/V a layer, ``t`` = the prompt's length.
        ``state``: a decode state of this batch and ``max_len`` to fill in
        place instead (every tensor keeps its address; self-attention
        slots past the prompt keep what they held, which decode masks)."""
        with sharded(self.policy):
            return self._prefill(params, frames, tokens, max_len, state)

    def _prefill(self, params, frames, tokens, max_len: int, state=None):
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prefill of {s} tokens exceeds max_len "
                             f"{max_len}")
        enc_out = self.encode(params, frames)
        x = self._embed(params, tokens)
        states = []
        for i, p in enumerate(params["dec"]):
            h = layers.layernorm(p["ln1"], x)
            mix, kv = attention.apply(p["self_attn"], self.dec_attn, h,
                                      policy=self.policy)
            placed = self.policy is not None and self.policy.places
            cache = state["layers"][i]["self"] if state is not None else \
                place_state(self.policy, attention.init_cache(
                    self.dec_attn, b, max_len, kv.k.dtype,
                    "meta" if placed else self.device), self.device)
            for dst, src_ in ((cache.k, kv.k), (cache.v, kv.v)):
                if is_dtensor(dst):
                    _fill_local(dst, src_, s, max_len)
                else:
                    dst[:, :s] = src_
            x = x + mix
            hx = layers.layernorm(p["lnx"], x)
            cross, src = attention.apply(p["cross_attn"], self.cross_attn,
                                         hx, kv=enc_out, policy=self.policy)
            x = self._shard(self._tail(p, x, cross))
            if state is not None:
                frozen = state["layers"][i]["cross"]
                frozen.k.copy_(src.k)
                frozen.v.copy_(src.v)
            states.append({"self": cache, "cross": src})
        hidden = layers.layernorm(params["dec_ln"], x)
        logits = self._logits(params, hidden[:, -1:])
        t = torch.full((), s, dtype=torch.int32, device=x.device)
        if state is not None:
            state["t"].copy_(t)
            return logits[:, 0], state
        return logits[:, 0], {"layers": states, "t": t}

    def decode_step(self, params, token, state):
        """One decode step. token: (B, 1) int32 -> (logits, state); the
        self-attention caches are updated in place."""
        with sharded(self.policy):
            return self._decode_step(params, token, state)

    def _decode_step(self, params, token, state):
        cfg = self.cfg
        t = state["t"]
        b = token.shape[0]
        x = layers.embed(params["embed"], token, False, cfg.d_model,
                         self.policy)
        # the sinusoid at position t, computed directly (no table)
        half = cfg.d_model // 2
        log_ts = math.log(10000.0) / (half - 1)
        inv = torch.exp(-log_ts * torch.arange(half, dtype=torch.float32,
                                               device=x.device))
        ang = t.float() * inv
        pos = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]
        x = x + pos.to(x.dtype)
        for p, st in zip(params["dec"], state["layers"]):
            h = layers.layernorm(p["ln1"], x)
            mix, _ = attention.decode_step(p["self_attn"], self.dec_attn, h,
                                           st["self"], t, policy=self.policy)
            x = x + mix
            hx = layers.layernorm(p["lnx"], x)
            # cross-attention against the frozen encoder K/V
            q = (hx @ p["cross_attn"]["wq"]).reshape(
                b, 1, cfg.n_heads, self.cross_attn.head_dim)
            out = attention._attend(self.cross_attn, q, st["cross"].k,
                                    st["cross"].v, None, self.policy)
            x = self._tail(p, x, out.reshape(b, 1, -1)
                           @ p["cross_attn"]["wo"])
        hidden = layers.layernorm(params["dec_ln"], x)
        logits = self._logits(params, hidden)
        return logits[:, 0], {"layers": state["layers"], "t": t + 1}
