"""Decoder-only transformer trunk: dense and MoE attention stacks.

The port of the JAX package's ``models/transformer.py`` for the ``dense``
and ``moe`` families.  The layout follows the reference's rule: layers of
one signature (mixer kind, MoE or dense FFN) after the leading dense
layers form a stacked ``body`` (``(L, ...)`` leaves) when there are more
than one of them, the rest are ``prefix`` layers, one tree each; a
homogeneous stack is all body.  The reference scans the body; here a loop
over the layers indexes the stacked tensors, so the parameter and
decode-state trees keep the reference's shape leaf for leaf: the decode
state is ``{"prefix": [...], "body": KVCache((L, B, S, R, H) x 2), "t":
0-dim int32}``.

Training: ``loss`` is the reference's (masked cross-entropy over float32
logits, plus ``0.01 * lb + 1e-3 * z`` of the MoE layers' aux losses), its
attention the einsum path (K6 is forward-only and refuses a tensor that
requires grad).

The families the port does not carry (ssm, hybrid, encdec, vlm) raise
``NotImplementedError``; they are ROADMAP Queue 1 item 12b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe


def _attn_config(cfg: ModelConfig) -> attention.AttentionConfig:
    return attention.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_type=cfg.rope_type,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        causal=True, window=cfg.window)


def _layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, bool]:
    has_moe = (cfg.moe is not None and i >= cfg.moe.first_dense_layers)
    return (cfg.layer_kind(i), has_moe)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's transformer does not carry yet."""
    if cfg.family not in ("dense", "moe") or cfg.ssm is not None \
            or cfg.rglru is not None or (cfg.family == "moe") != (
                cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port carries dense and moe attention stacks (ssm, hybrid, "
            f"encdec and vlm are ROADMAP Queue 1 item 12b)")
    if cfg.vision_prefix or cfg.rope_type == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: vlm inputs (vision prefix, M-RoPE) are not ported "
            f"yet (ROADMAP Queue 1 item 12b)")


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
        # the reference's layout: a stacked body of the layers after the
        # leading dense ones when they share one signature and are more
        # than one; all body for a homogeneous stack; else all prefix
        cfg = self.cfg
        sigs = [_layer_signature(cfg, i) for i in range(cfg.n_layers)]
        first = cfg.moe.first_dense_layers if cfg.moe else 0
        body = sigs[first:]
        self.scan_body = len(set(body)) == 1 and len(body) > 1
        self.n_prefix = first if self.scan_body else (
            0 if len(set(sigs)) == 1 and len(sigs) > 1 else cfg.n_layers)
        if len(set(sigs)) == 1 and len(sigs) > 1:
            self.scan_body, self.n_prefix = True, 0
        self.n_body = cfg.n_layers - self.n_prefix

    # ------------------------------------------------------------------ init
    def _init_layer(self, gen: torch.Generator, i: int, lead=()):
        cfg = self.cfg
        dtype, dev = cfg.param_dtype(), self.device
        _, has_moe = _layer_signature(cfg, i)
        params = {
            "ln1": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
            "ln2": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
            "mixer": attention.init(gen, self.attn_cfg, dtype, lead),
        }
        if has_moe:
            params["ffn"] = moe.init(gen, cfg.d_model, cfg.moe, cfg.mlp_type,
                                     dtype, lead)
        else:
            params["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                            cfg.mlp_type, dtype, lead)
        return params

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
        params["prefix"] = [self._init_layer(gen, i)
                            for i in range(self.n_prefix)]
        params["body"] = (self._init_layer(gen, self.n_prefix,
                                           lead=(self.n_body,))
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
    def _ffn(self, lp, x, i: int, aux=None):
        """x + the layer's FFN (dense MLP or MoE) of its second norm; a MoE
        layer's aux losses are added into ``aux`` when it is given."""
        h = self.norm(lp["ln2"], x)
        if _layer_signature(self.cfg, i)[1]:
            f, moe_aux = moe.apply(lp["ffn"], h, self.cfg.moe,
                                   self.cfg.mlp_type)
            if aux is not None:
                for k, v in moe_aux.items():
                    aux[k] = aux[k] + v if k in aux else v
        else:
            f = layers.mlp_apply(lp["ffn"], h, self.cfg.mlp_type)
        return x + f

    def _positions(self, tokens):
        b, s = tokens.shape
        return torch.arange(s, dtype=torch.int32,
                            device=tokens.device).expand(b, s)

    def forward(self, params, tokens) -> Tuple[torch.Tensor, Dict]:
        """Token ids -> (final hidden states (B, S, D), aux): ``aux`` sums
        the MoE layers' ``moe_lb_loss`` and ``moe_z_loss`` (empty for a
        dense stack), in layer order as the reference."""
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, cfg.emb_scale, cfg.d_model)
        positions = self._positions(tokens)
        aux: Dict[str, torch.Tensor] = {}
        for i, (lp, _) in enumerate(self._layers(params)):
            if i == self.n_prefix and self.scan_body and cfg.moe is not None:
                # the reference's scan starts its aux carry at zero
                for k in ("moe_lb_loss", "moe_z_loss"):
                    aux.setdefault(k, torch.zeros((), dtype=torch.float32,
                                                  device=x.device))
            mix, _ = attention.apply(lp["mixer"], self.attn_cfg,
                                     self.norm(lp["ln1"], x), positions)
            x = self._ffn(lp, x + mix, i, aux)
        return self.norm(params["final_ln"], x), aux

    def hidden_states(self, params, tokens):
        """Token ids -> final hidden states (B, S, D)."""
        return self.forward(params, tokens)[0]

    def logits(self, params, hidden):
        cfg = self.cfg
        return layers.logits_from_hidden(
            hidden, params["embed"], params.get("unembed"),
            cfg.tie_embeddings, cfg.logits_softcap,
            true_vocab=cfg.vocab_size)

    # ------------------------------------------------------------- training
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """batch: {tokens, labels}; labels are next-token ids with -100 =
        masked.  -> (total, aux): cross-entropy plus, for a MoE stack,
        ``0.01 * moe_lb_loss + 1e-3 * moe_z_loss``; aux also holds
        ``ce_loss``."""
        hidden, aux = self.forward(params, batch["tokens"])
        logits = self.logits(params, hidden)
        ce = layers.cross_entropy_loss(logits, batch["labels"])
        total = ce
        if self.cfg.moe is not None:
            total = total + 0.01 * aux.get("moe_lb_loss", 0.0) \
                + 1e-3 * aux.get("moe_z_loss", 0.0)
        aux = dict(aux)
        aux["ce_loss"] = ce
        return total, aux

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
        for i, (lp, st) in enumerate(self._layers(params, state)):
            mix, _ = attention.decode_step(lp["mixer"], self.attn_cfg,
                                           self.norm(lp["ln1"], x), st, t)
            x = self._ffn(lp, x + mix, i)
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
        for i, (lp, cache) in enumerate(self._layers(params, state)):
            mix, kv = attention.apply(lp["mixer"], self.attn_cfg,
                                      self.norm(lp["ln1"], x), positions,
                                      use_flash=cfg.flash_prefill)
            self._fill_cache(cache, kv)
            x = self._ffn(lp, x + mix, i)
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
