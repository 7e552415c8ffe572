"""Decoder-only transformer trunk: dense attention-only stacks.

The port of the JAX package's ``models/transformer.py`` for the ``dense``
family.  The reference scans one layer over parameters stacked along a
leading layer axis; here a loop over the layers indexes the same stacked
tensors, so the parameter and decode-state trees keep the reference's
shape leaf for leaf: ``params["body"]`` holds ``(L, ...)`` leaves and the
decode state is ``{"prefix": [...], "body": KVCache((L, B, S, R, H) x 2),
"t": 0-dim int32}``.

The families the slice does not carry (moe, ssm, hybrid, encdec, vlm)
raise ``NotImplementedError``; they are ROADMAP Queue 1 item 12.  There is
no training path yet (``loss`` comes with the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers


def _attn_config(cfg: ModelConfig) -> attention.AttentionConfig:
    return attention.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_type=cfg.rope_type,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        causal=True, window=cfg.window)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's transformer does not carry yet."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None \
            or cfg.rglru is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port serves dense attention stacks (moe, ssm, hybrid, encdec "
            f"and vlm are ROADMAP Queue 1 item 12)")
    if cfg.vision_prefix or cfg.rope_type == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: vlm inputs (vision prefix, M-RoPE) are not ported "
            f"yet (ROADMAP Queue 1 item 12)")


def _layer(tree, i: int):
    """Layer i's slice of a stacked (L, ...) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(k=tree.k[i], v=tree.v[i])
    return tree[i]


@dataclasses.dataclass
class Transformer:
    cfg: ModelConfig
    device: torch.device

    def __post_init__(self):
        check_supported(self.cfg)
        self.device = torch.device(self.device)
        self.attn_cfg = _attn_config(self.cfg)
        self.norm = layers.norm_fn(self.cfg.norm_type)
        # one homogeneous stack: stacked "body" unless there is one layer
        self.scan_body = self.cfg.n_layers > 1
        self.n_prefix = 0 if self.scan_body else self.cfg.n_layers
        self.n_body = self.cfg.n_layers - self.n_prefix

    # ------------------------------------------------------------------ init
    def _init_layer(self, gen: torch.Generator, lead=()):
        cfg = self.cfg
        dtype, dev = cfg.param_dtype(), self.device
        return {
            "ln1": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
            "ln2": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
            "mixer": attention.init(gen, self.attn_cfg, dtype, lead),
            "ffn": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                   dtype, lead),
        }

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters from ``gen`` (a generator on the model's
        device), in the reference's tree layout."""
        cfg = self.cfg
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = cfg.param_dtype()
        params: Dict[str, Any] = {
            "embed": layers.embedding_init(gen, cfg.padded_vocab,
                                           cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            params["unembed"] = layers.unembed_init(gen, cfg.padded_vocab,
                                                    cfg.d_model, dtype)
        params["final_ln"] = layers.make_norm(cfg.norm_type, cfg.d_model,
                                              dtype, self.device)[0]
        params["prefix"] = [self._init_layer(gen)
                            for _ in range(self.n_prefix)]
        params["body"] = (self._init_layer(gen, lead=(self.n_body,))
                          if self.scan_body else {})
        return params

    def _layers(self, params, state=None):
        """(layer params, layer state or None) for every layer, in order."""
        out = []
        for i, lp in enumerate(params["prefix"]):
            out.append((lp, None if state is None else state["prefix"][i]))
        for i in range(self.n_body if self.scan_body else 0):
            out.append((_layer(params["body"], i),
                        None if state is None else _layer(state["body"], i)))
        return out

    # ------------------------------------------------------------- forwards
    def _ffn(self, lp, x):
        return x + layers.mlp_apply(lp["ffn"], self.norm(lp["ln2"], x),
                                    self.cfg.mlp_type)

    def _positions(self, tokens):
        b, s = tokens.shape
        return torch.arange(s, dtype=torch.int32,
                            device=tokens.device).expand(b, s)

    def hidden_states(self, params, tokens):
        """Token ids -> final hidden states (B, S, D)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, cfg.emb_scale, cfg.d_model)
        positions = self._positions(tokens)
        for lp, _ in self._layers(params):
            mix, _ = attention.apply(lp["mixer"], self.attn_cfg,
                                     self.norm(lp["ln1"], x), positions)
            x = self._ffn(lp, x + mix)
        return self.norm(params["final_ln"], x)

    def logits(self, params, hidden):
        cfg = self.cfg
        return layers.logits_from_hidden(
            hidden, params["embed"], params.get("unembed"),
            cfg.tie_embeddings, cfg.logits_softcap,
            true_vocab=cfg.vocab_size)

    # ------------------------------------------------------ prefill / decode
    def init_state(self, batch: int, max_len: int):
        """An empty decode state: zero caches, t = 0."""
        dtype = self.cfg.param_dtype()

        def cache(lead=()):
            one = attention.init_cache(self.attn_cfg, batch, max_len, dtype,
                                       self.device)
            return attention.KVCache(
                k=one.k.expand(*lead, *one.k.shape).contiguous(),
                v=one.v.expand(*lead, *one.v.shape).contiguous())

        return {"prefix": [cache() for _ in range(self.n_prefix)],
                "body": cache((self.n_body,)) if self.scan_body else None,
                "t": torch.zeros((), dtype=torch.int32, device=self.device)}

    def decode_step(self, params, token, state):
        """One decode step. token: (B, 1) int32. Returns (logits, state);
        the caches of ``state`` are updated in place."""
        cfg = self.cfg
        t = state["t"]
        x = layers.embed(params["embed"], token, cfg.emb_scale, cfg.d_model)
        for lp, st in self._layers(params, state):
            mix, _ = attention.decode_step(lp["mixer"], self.attn_cfg,
                                           self.norm(lp["ln1"], x), st, t)
            x = self._ffn(lp, x + mix)
        hidden = self.norm(params["final_ln"], x)
        logits = self.logits(params, hidden)
        new_state = {"prefix": state["prefix"], "body": state["body"],
                     "t": t + 1}
        return logits[:, 0], new_state

    def prefill(self, params, tokens, max_len: int):
        """Run the full prompt, build the decode state, return the last
        position's logits.  With ``cfg.flash_prefill`` the attention runs
        through K6."""
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_len and not cfg.window:
            raise ValueError(f"prefill of {s} tokens exceeds max_len "
                             f"{max_len}")
        x = layers.embed(params["embed"], tokens, cfg.emb_scale, cfg.d_model)
        positions = self._positions(tokens)
        state = self.init_state(b, max_len)
        for lp, cache in self._layers(params, state):
            mix, kv = attention.apply(lp["mixer"], self.attn_cfg,
                                      self.norm(lp["ln1"], x), positions,
                                      use_flash=cfg.flash_prefill)
            self._fill_cache(cache, kv)
            x = self._ffn(lp, x + mix)
        hidden = self.norm(params["final_ln"], x)
        logits = self.logits(params, hidden[:, -1:, :])
        state["t"] = torch.full((), s, dtype=torch.int32, device=self.device)
        return logits[:, 0], state

    def _fill_cache(self, cache: attention.KVCache, kv: attention.KVCache):
        """The reference's ``_pad_cache``, in place: a prefill's K/V into a
        zero cache of capacity ``cap`` — the first s slots, or on a
        windowed layer whose prompt outgrows the window the last ``cap``
        positions, rolled so that position p sits at ring slot p % cap (the
        decode layout)."""
        s, cap = kv.k.shape[1], cache.k.shape[1]
        for dst, src in ((cache.k, kv.k), (cache.v, kv.v)):
            if s <= cap:
                dst[:, :s] = src
            else:
                dst.copy_(torch.roll(src[:, -cap:], (s - cap) % cap, dims=1))
