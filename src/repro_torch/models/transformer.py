"""Decoder-only transformer trunk: the dense, moe, ssm, hybrid and vlm
families (whisper's encoder-decoder is ``encdec.py``).

The port of the JAX package's ``models/transformer.py``.  Each layer's
mixer is ``cfg.layer_kind(i)``: attention (dense / GQA / MQA, global or
windowed), Mamba-2 SSD (``ssm``; such a layer has one norm and no FFN) or
RG-LRU (``rglru``); FFNs are dense MLPs or sort-routed MoE.  The layout
follows the reference's rule: layers of one signature (mixer kind, MoE or
dense FFN) after the leading dense layers form a stacked ``body`` (``(L,
...)`` leaves) when there are more than one of them, the rest are
``prefix`` layers, one tree each; a homogeneous stack is all body (mamba2),
a mixed one all prefix (recurrentgemma's rglru, rglru, attn pattern).  The
reference scans the body; here a loop over the layers indexes the stacked
tensors, so the parameter and decode-state trees keep the reference's
shape leaf for leaf: the decode state is ``{"prefix": [...], "body": one
stacked state, "t": 0-dim int32}`` with a ``KVCache``, ``SSMState`` or
``RGLRUState`` a layer.  Decode updates every layer's state in place.

The vlm family feeds ``vision_embeds`` into the leading ``vision_prefix``
positions and rotates with M-RoPE over (3, B, S) positions (t = h = w for
text by default).

With a sharding ``policy`` (``sharding.partitioning.ShardingPolicy``)
the parameters and decode state are DTensors placed by ``param_specs``
and ``sharding.partitioning.decode_state_specs``, and the policy's hooks
sit where the reference's do: the residual stream after the embedding and
each layer (``shard_activations``), the sequence-parallel gather and
scatter around each training block's mixer and FFN (``sp_gather`` /
``sp_scatter``), the heads, scores and cache inside attention, the MoE's
routing and expert slice, the logits of the loss.  Plain tensors that meet DTensors (positions,
masks, constants) count as replicated (``implicit_replication``).  Without
a policy nothing of this runs.

Training: ``loss`` is the reference's (masked cross-entropy over float32
logits, plus ``0.01 * lb + 1e-3 * z`` of the MoE layers' aux losses), its
attention the einsum path (K6 is forward-only and refuses a tensor that
requires grad).  With ``remat`` (the default, as the reference's
``build``) each layer's forward runs again in the backward, so a MoE
router's top-k launches twice a layer and step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.sharding.partitioning import (P, decode_state_specs,
                                               is_dtensor)

_STATES = (attention.KVCache, ssm.SSMState, rglru.RGLRUState)


def _attn_config(cfg: ModelConfig,
                 kv_repeat: int = 1) -> attention.AttentionConfig:
    return attention.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_type=cfg.rope_type,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        causal=True, window=cfg.window, kv_repeat=kv_repeat)


_IMPLICIT = [0]       # entries of ``sharded`` that hold a mesh


@contextlib.contextmanager
def sharded(policy):
    """The context a sharded forward runs in: plain tensors meeting
    DTensors count as replicated (``implicit_replication``, entered at the
    outermost level only: it switches itself off on exit, also inside an
    outer one).  Nothing without a mesh."""
    if policy is None or not policy.places:
        yield
        return
    _IMPLICIT[0] += 1
    try:
        if _IMPLICIT[0] > 1:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _IMPLICIT[0] -= 1


def stacked_specs(specs):
    """A layer's specs with the stacked body's leading layer axis."""
    return _tree.map(lambda spec: P(*((None,) + tuple(spec))), specs)


def _layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, bool]:
    has_moe = (cfg.moe is not None and i >= cfg.moe.first_dense_layers)
    return (cfg.layer_kind(i), has_moe)


def check_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family without the sub-config it needs."""
    need = {"ssm": ("ssm", cfg.ssm), "hybrid": ("rglru", cfg.rglru),
            "moe": ("moe", cfg.moe)}
    if cfg.family in need and need[cfg.family][1] is None:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family needs a "
                         f"{need[cfg.family][0]!r} config")


def _layer(tree, i: int):
    """Layer i's slice of a stacked (L, ...) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, _STATES):
        return type(tree)(*(x[i] for x in tree))
    return tree[i]


def _unstack(tree, n: int):
    """The n layer trees of a stacked (L, ...) parameter tree, each leaf
    ``unbind`` once: the backward stacks the n layers' gradients in one op,
    where n separate ``tree[i]`` would each add a whole (L, ...) gradient."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if is_dtensor(tree):
        return [tree[i] for i in range(n)]
    return list(tree.unbind(0))


def remat_active(remat: bool, params) -> bool:
    """Whether a forward keeps only each layer's inputs (the reference's
    ``jax.checkpoint(..., nothing_saveable)`` a layer): ``remat`` is on,
    autograd records, and some parameter leaf takes a gradient.  Prefill,
    decode and serve take none, so they run exactly as without remat."""
    return remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in _tree.leaves(params))


@dataclasses.dataclass
class Transformer:
    cfg: ModelConfig
    device: torch.device
    remat: bool = True
    policy: Any = None               # ShardingPolicy or None

    def __post_init__(self):
        check_config(self.cfg)
        self.device = torch.device(self.device)
        cfg = self.cfg
        kvr = 1
        if self.policy is not None:
            kvr = self.policy.kv_repeat(cfg.n_kv_heads, cfg.n_heads)
        self.attn_cfg = _attn_config(cfg, kvr)
        self.norm = layers.norm_fn(cfg.norm_type)
        if cfg.ssm is not None:
            self.ssm_dims = ssm.SSMDims.from_config(cfg.d_model, cfg.ssm)
        self.rglru_width = (0 if cfg.rglru is None else
                            (cfg.rglru.lru_width or cfg.d_model))
        # the reference's layout: a stacked body of the layers after the
        # leading dense ones when they share one signature and are more
        # than one; all body for a homogeneous stack; else all prefix
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
        kind, has_moe = _layer_signature(cfg, i)
        params = {
            "ln1": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
            "ln2": layers.make_norm(cfg.norm_type, cfg.d_model, dtype, dev,
                                    lead)[0],
        }
        if kind == "attn":
            params["mixer"] = attention.init(gen, self.attn_cfg, dtype, lead)
        elif kind == "ssm":
            params["mixer"] = ssm.init(gen, self.ssm_dims, dtype, lead)
        else:
            params["mixer"] = rglru.init(gen, cfg.d_model, self.rglru_width,
                                         cfg.rglru, dtype, lead)
        if kind == "ssm":
            del params["ln2"]          # mamba blocks: one norm a layer
        elif has_moe:
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

    def _layer_specs(self, i: int):
        cfg = self.cfg
        kind, has_moe = _layer_signature(cfg, i)
        specs = {"ln1": layers.norm_specs(cfg.norm_type),
                 "ln2": layers.norm_specs(cfg.norm_type)}
        if kind == "attn":
            specs["mixer"] = attention.specs()
        elif kind == "ssm":
            specs["mixer"] = ssm.specs()
        else:
            specs["mixer"] = rglru.specs()
        if kind == "ssm":
            del specs["ln2"]
        elif has_moe:
            specs["ffn"] = moe.specs(cfg.moe, cfg.mlp_type)
        else:
            specs["ffn"] = layers.mlp_specs(cfg.mlp_type)
        return specs

    def param_specs(self) -> Dict[str, Any]:
        """The reference's partition-spec tree of ``init``'s parameters
        (``PartitionSpec`` leaves, the same structure); the stacked body's
        specs lead with ``None`` for the layer axis."""
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "embed": layers.embedding_specs(tied=cfg.tie_embeddings)}
        if not cfg.tie_embeddings:
            specs["unembed"] = layers.unembed_specs()
        specs["final_ln"] = layers.norm_specs(cfg.norm_type)
        specs["prefix"] = [self._layer_specs(i)
                           for i in range(self.n_prefix)]
        specs["body"] = (stacked_specs(self._layer_specs(self.n_prefix))
                         if self.scan_body else {})
        return specs

    def _layers(self, params, state=None):
        """(layer index, layer params, layer state or None) for every
        layer, in order; a body layer's are views into the stacks."""
        out = []
        for i, lp in enumerate(params["prefix"]):
            out.append((i, lp,
                        None if state is None else state["prefix"][i]))
        if self.scan_body:
            for i, lp in enumerate(_unstack(params["body"], self.n_body)):
                out.append((self.n_prefix + i, lp, None if state is None
                            else _layer(state["body"], i)))
        return out

    # ------------------------------------------------------------- forwards
    def _mix(self, lp, h, i: int, positions, use_flash: bool = False,
             init_state=None):
        """The layer's mixer over a whole sequence: (out, its state: the
        repeated K/V of an attention layer, the final state of a recurrent
        one)."""
        cfg = self.cfg
        kind = cfg.layer_kind(i)
        pol = self.policy
        if kind == "attn":
            return attention.apply(lp["mixer"], self.attn_cfg, h, positions,
                                   use_flash=use_flash, policy=pol)
        if kind == "ssm":
            return ssm.apply(lp["mixer"], h, self.ssm_dims, init_state,
                             policy=pol)
        return rglru.apply(lp["mixer"], h, self.rglru_width, cfg.rglru,
                           init_state, policy=pol)

    def _ffn(self, lp, x, i: int, aux=None, sp: bool = False):
        """x + the layer's FFN (dense MLP or MoE) of its second norm; a MoE
        layer's aux losses are added into ``aux`` when it is given; an ssm
        layer has none.  ``sp``: the training block's sequence-parallel
        gather and scatter around the FFN (a policy's)."""
        kind, has_moe = _layer_signature(self.cfg, i)
        if kind == "ssm":
            return x
        pol = self.policy
        h = self.norm(lp["ln2"], x)
        if sp and pol is not None:
            h = pol.sp_gather(h)
        if has_moe:
            f, moe_aux = moe.apply(lp["ffn"], h, self.cfg.moe,
                                   self.cfg.mlp_type, policy=pol)
            if aux is not None:
                for k, v in moe_aux.items():
                    aux[k] = aux[k] + v if k in aux else v
        else:
            f = layers.mlp_apply(lp["ffn"], h, self.cfg.mlp_type)
        if sp and pol is not None:
            f = pol.sp_scatter(f)
        return x + f

    def _shard(self, x):
        return x if self.policy is None else \
            self.policy.shard_activations(x)

    def _default_positions(self, tokens):
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=tokens.device).expand(b, s)
        if self.cfg.rope_type == "mrope":
            return pos.expand(3, b, s)
        return pos

    def _embed(self, params, tokens, vision_embeds=None):
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, cfg.emb_scale, cfg.d_model,
                         self.policy)
        if vision_embeds is not None and cfg.vision_prefix:
            # the vision prefix's patch embeddings replace its positions
            if is_dtensor(x):
                vision_embeds = self.policy.as_dtensor(vision_embeds)
            x = torch.cat([vision_embeds.to(x.dtype),
                           x[:, cfg.vision_prefix:]], dim=1)
        return self._shard(x)

    def forward(self, params, tokens, positions=None,
                vision_embeds=None) -> Tuple[torch.Tensor, Dict]:
        """Token ids -> (final hidden states (B, S, D), aux): ``aux`` sums
        the MoE layers' ``moe_lb_loss`` and ``moe_z_loss`` (empty without
        MoE), in layer order as the reference.  While a gradient is taken
        (``remat_active``) each layer runs under ``checkpoint``: only its
        inputs are kept, and the backward runs its forward again."""
        with sharded(self.policy):
            return self._forward(params, tokens, positions, vision_embeds)

    def _forward(self, params, tokens, positions, vision_embeds):
        cfg = self.cfg
        x = self._embed(params, tokens, vision_embeds)
        if positions is None:
            positions = self._default_positions(tokens)
        aux: Dict[str, torch.Tensor] = {}
        remat = remat_active(self.remat, params)
        for i, lp, _ in self._layers(params):
            if i == self.n_prefix and self.scan_body and cfg.moe is not None:
                # the reference's scan starts its aux carry at zero
                for k in ("moe_lb_loss", "moe_z_loss"):
                    aux.setdefault(k, torch.zeros((), dtype=torch.float32,
                                                  device=x.device))
            if remat:
                x, layer_aux = checkpoint(self._layer_fwd, lp, x, i,
                                          positions, use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                x, layer_aux = self._layer_fwd(lp, x, i, positions)
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v if k in aux else v
        return self.norm(params["final_ln"], x), aux

    def _layer_fwd(self, lp, x, i: int, positions):
        """One layer of the training forward: (x after the layer, the MoE
        aux losses it adds, ``{}`` for a dense FFN or an ssm layer).  The
        aux losses leave as outputs, so the layer can run under
        ``checkpoint``; it enters ``sharded`` itself, as the backward's
        recompute runs outside the forward's context."""
        with sharded(self.policy):
            return self._layer_body(lp, x, i, positions)

    def _layer_body(self, lp, x, i: int, positions):
        pol = self.policy
        h = self.norm(lp["ln1"], x)
        if pol is not None:
            h = pol.sp_gather(h)           # SP: gather seq once per block
        mix, _ = self._mix(lp, h, i, positions)
        if pol is not None:
            mix = pol.sp_scatter(mix)      # SP: TP partial sum -> RS
        aux: Dict[str, torch.Tensor] = {}
        return self._shard(self._ffn(lp, x + mix, i, aux, sp=True)), aux

    def hidden_states(self, params, tokens, positions=None,
                      vision_embeds=None):
        """Token ids -> final hidden states (B, S, D)."""
        return self.forward(params, tokens, positions, vision_embeds)[0]

    def logits(self, params, hidden):
        cfg = self.cfg
        return layers.logits_from_hidden(
            hidden, params["embed"], params.get("unembed"),
            cfg.tie_embeddings, cfg.logits_softcap,
            true_vocab=cfg.vocab_size)

    # ------------------------------------------------------------- training
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """batch: {tokens, labels, (positions), (vision_embeds)}; labels
        are next-token ids with -100 = masked.  -> (total, aux):
        cross-entropy plus, for a MoE stack, ``0.01 * moe_lb_loss + 1e-3 *
        moe_z_loss``; aux also holds ``ce_loss``."""
        hidden, aux = self.forward(params, batch["tokens"],
                                   batch.get("positions"),
                                   batch.get("vision_embeds"))
        with sharded(self.policy):
            logits = self.logits(params, hidden)
            ce = layers.cross_entropy_loss(logits, batch["labels"],
                                           self.policy)
        total = ce
        if self.cfg.moe is not None:
            total = total + 0.01 * aux.get("moe_lb_loss", 0.0) \
                + 1e-3 * aux.get("moe_z_loss", 0.0)
        aux = dict(aux)
        aux["ce_loss"] = ce
        return total, aux

    # ------------------------------------------------------ prefill / decode
    def _init_layer_state(self, i: int, batch: int, max_len: int,
                          dev=None):
        kind = self.cfg.layer_kind(i)
        dtype, dev = self.cfg.param_dtype(), dev or self.device
        if kind == "attn":
            return attention.init_cache(self.attn_cfg, batch, max_len, dtype,
                                        dev)
        if kind == "ssm":
            return ssm.init_state(self.ssm_dims, batch, dtype, dev)
        return rglru.init_state(self.rglru_width, self.cfg.rglru, batch,
                                dtype, dev)

    def init_state(self, batch: int, max_len: int):
        """An empty decode state: zero caches and recurrent states, t = 0.
        Only a global attention layer's cache grows with ``max_len``.
        With a policy on a mesh the state is laid out on the ``meta``
        device and each rank makes only its zero shards (``place_state``)."""
        placed = self.policy is not None and self.policy.places
        dev = torch.device("meta") if placed else self.device
        body = None
        if self.scan_body:
            one = self._init_layer_state(self.n_prefix, batch, max_len, dev)
            body = type(one)(*(x.expand(self.n_body, *x.shape).contiguous()
                               for x in one))
        state = {"prefix": [self._init_layer_state(i, batch, max_len, dev)
                            for i in range(self.n_prefix)],
                 "body": body,
                 "t": torch.zeros((), dtype=torch.int32, device=dev)}
        return place_state(self.policy, state, self.device)

    def decode_step(self, params, token, state):
        """One decode step. token: (B, 1) int32. Returns (logits, state);
        every layer's state in ``state`` is updated in place."""
        with sharded(self.policy):
            return self._decode_step(params, token, state)

    def _decode_step(self, params, token, state):
        cfg = self.cfg
        t = state["t"]
        x = layers.embed(params["embed"], token, cfg.emb_scale, cfg.d_model,
                         self.policy)
        for i, lp, st in self._layers(params, state):
            h = self.norm(lp["ln1"], x)
            kind = cfg.layer_kind(i)
            if kind == "attn":
                mix, _ = attention.decode_step(lp["mixer"], self.attn_cfg, h,
                                               st, t, policy=self.policy)
            else:
                if kind == "ssm":
                    mix, new = ssm.decode_step(lp["mixer"], h, self.ssm_dims,
                                               st, policy=self.policy)
                else:
                    mix, new = rglru.decode_step(lp["mixer"], h,
                                                 self.rglru_width, cfg.rglru,
                                                 st)
                _copy_state(st, new)
            x = self._ffn(lp, x + mix, i)
        hidden = self.norm(params["final_ln"], x)
        logits = self.logits(params, hidden)
        new_state = {"prefix": state["prefix"], "body": state["body"],
                     "t": t + 1}
        return logits[:, 0], new_state

    def prefill(self, params, tokens, max_len: int, positions=None,
                vision_embeds=None, state=None):
        """Run the full prompt, build the decode state, return the last
        position's logits.  With ``cfg.flash_prefill`` the causal
        self-attention runs through K6; recurrent layers keep their final
        states.  ``state``: a decode state of this batch and ``max_len``
        to fill in place instead (every tensor keeps its address; cache
        slots past the prompt keep what they held, which decode masks)."""
        with sharded(self.policy):
            return self._prefill(params, tokens, max_len, positions,
                                 vision_embeds, state)

    def _prefill(self, params, tokens, max_len, positions, vision_embeds,
                 state=None):
        cfg = self.cfg
        b, s = tokens.shape
        global_attn = not cfg.window and any(
            cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        if s > max_len and global_attn:
            raise ValueError(f"prefill of {s} tokens exceeds max_len "
                             f"{max_len}")
        x = self._embed(params, tokens, vision_embeds)
        if positions is None:
            positions = self._default_positions(tokens)
        given = state is not None
        if not given:
            state = self.init_state(b, max_len)
        for i, lp, st in self._layers(params, state):
            mix, new = self._mix(lp, self.norm(lp["ln1"], x), i, positions,
                                 use_flash=cfg.flash_prefill)
            if cfg.layer_kind(i) == "attn":
                self._fill_cache(st, new)
            else:
                _copy_state(st, new)
            x = self._shard(self._ffn(lp, x + mix, i))
        hidden = self.norm(params["final_ln"], x)
        logits = self.logits(params, hidden[:, -1:, :])
        t = torch.full((), s, dtype=torch.int32, device=self.device)
        t = t if not is_dtensor(state["t"]) else self.policy.as_dtensor(t)
        if given:
            state["t"].copy_(t)
        else:
            state["t"] = t
        return logits[:, 0], state

    def _fill_cache(self, cache: attention.KVCache, kv: attention.KVCache):
        """The reference's ``_pad_cache``, in place: a prefill's K/V into a
        zero cache of capacity ``cap`` — the first s slots, or on a
        windowed layer whose prompt outgrows the window the last ``cap``
        positions, rolled so that position p sits at ring slot p % cap (the
        decode layout)."""
        s, cap = kv.k.shape[1], cache.k.shape[1]
        for dst, src in ((cache.k, kv.k), (cache.v, kv.v)):
            if is_dtensor(dst):
                _fill_local(dst, src, s, cap)
            elif s <= cap:
                dst[:, :s] = src
            else:
                dst.copy_(torch.roll(src[:, -cap:], (s - cap) % cap, dims=1))


def _copy_state(dst, src) -> None:
    """A recurrent layer's new state into its slot of the decode state."""
    for d, x in zip(dst, src):
        if is_dtensor(d):
            d.to_local().copy_(x.redistribute(d.device_mesh,
                                              d.placements).to_local())
        else:
            d.copy_(x)


def _fill_local(dst, src, s: int, cap: int) -> None:
    """``_fill_cache`` of a DTensor cache, on each rank's shard: ``src``
    placed as ``dst`` is (a cache that shards its sequence:
    ``_fill_seq_shard``)."""
    from torch.distributed.tensor import Shard
    pl = tuple(dst.placements)
    if Shard(1) in pl:
        _fill_seq_shard(dst, src, s, cap)
        return
    src = src.redistribute(dst.device_mesh, pl).to_local()
    local = dst.to_local()
    if s <= cap:
        local[:, :s] = src
    else:
        local.copy_(torch.roll(src[:, -cap:], (s - cap) % cap, dims=1))


def _fill_seq_shard(dst, src, s: int, cap: int) -> None:
    """``_fill_local`` of a cache whose sequence is sharded: the rank
    holding slots [lo, lo + n) of the ``cap`` writes prompt positions lo
    .. min(s, lo + n) - 1 there (slots past s keep what they held); past
    the window (s > cap) slot j takes the position p of the last ``cap``
    with p % cap == j, the reference's rolled ring.  The prompt's K/V are
    taken whole along the sequence on each rank, (B_local, s, R, H): the
    serve layouts already hold them so (activations replicated over
    'model'), so nothing moves; a sequence-sharded K/V would be gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.partitioning import shard_offset
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    whole = tuple(Replicate() if p == Shard(1) else p for p in pl)
    src = src.redistribute(mesh, whole).to_local()
    local = dst.to_local()
    n = local.shape[1]
    lo = shard_offset(pl, 1, mesh, cap)
    if s <= cap:
        hi = min(s, lo + n)
        if hi > lo:
            local[:, :hi - lo] = src[:, lo:hi]
        return
    shift = (s - cap) % cap
    pos = (torch.arange(lo, lo + n, device=src.device) - shift) % cap \
        + (s - cap)
    local.copy_(src.index_select(1, pos))


def place_state(policy, state, device=None):
    """A decode state placed by ``decode_state_specs`` as
    DTensors (unchanged without a mesh).  A state laid out on the ``meta``
    device becomes zero shards on ``device``, made shard by shard."""
    if policy is None or not policy.places:
        return state
    specs = decode_state_specs(state, policy)
    return _tree.map(
        lambda s, t: policy.zeros(t.shape, t.dtype, s, device)
        if t.device.type == "meta" else policy.distribute(t, s),
        specs, state)
