"""build(config) -> a uniform Model facade over every architecture family.

The port of the JAX package's ``models/model_zoo.py``; the facade exposes
what ``launch/`` and the tests need:

    model.init(generator)        -> params
    model.param_specs()          -> the reference's partition-spec tree
    model.loss(params, batch)    -> (scalar, aux)       [training]
    model.prefill(params, batch, max_len[, state]) -> (last logits,
                                 decode state)
    model.decode_state(batch_size, max_len) -> empty decode state
    model.decode_step(params, token, state) -> (logits, state)
    model.input_specs(shape)     -> meta tensors standing in for each input

A batch is a dict of tensors: ``tokens`` always; ``frames`` (B, enc_seq, D)
for the encoder-decoder; ``vision_embeds`` (B, vision_prefix, D) and
``positions`` (3, B, S) for the vlm.

With a sharding ``policy`` (``build(cfg, policy=...)``) the model places
its parameters (``place``: DTensors by ``param_specs``) and runs every
forward on them as the reference's model runs under its policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.sortspec import resolve_device
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    impl: Any                  # Transformer | EncDecTransformer

    @property
    def is_encdec(self) -> bool:
        return isinstance(self.impl, EncDecTransformer)

    @property
    def device(self) -> torch.device:
        return self.impl.device

    @property
    def policy(self):
        return self.impl.policy

    def init(self, gen: torch.Generator):
        return self.impl.init(gen)

    def param_specs(self):
        return self.impl.param_specs()

    def place(self, params, specs=None):
        """``params`` (whole tensors, the same on every rank) as DTensors
        placed by ``specs`` (default ``param_specs()``, sanitized against
        each leaf); unchanged without a policy or mesh."""
        pol = self.policy
        if pol is None or not pol.places:
            return params
        return pol.param_sharding(self.param_specs() if specs is None
                                  else specs, params)

    def loss(self, params, batch):
        return self.impl.loss(params, batch)

    def prefill(self, params, batch, max_len: int, state=None):
        """(last logits, decode state); ``state``: a decode state of this
        batch and ``max_len`` (an earlier prefill's) to fill in place."""
        if self.is_encdec:
            return self.impl.prefill(params, batch["frames"],
                                     batch["tokens"], max_len, state=state)
        return self.impl.prefill(params, batch["tokens"], max_len,
                                 positions=batch.get("positions"),
                                 vision_embeds=batch.get("vision_embeds"),
                                 state=state)

    def decode_state(self, batch_size: int, max_len: int):
        if self.is_encdec:
            raise NotImplementedError("enc-dec state comes from prefill")
        return self.impl.init_state(batch_size, max_len)

    def decode_step(self, params, token, state):
        return self.impl.decode_step(params, token, state)

    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Meta tensors (shape and dtype, no storage) for each input of the
        step function this shape exercises."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": spec(b, s)}
            if shape.kind == "train":
                specs["labels"] = spec(b, s)
            if self.is_encdec:
                specs["frames"] = spec(b, cfg.enc_seq, cfg.d_model,
                                       dtype=torch.bfloat16)
            if cfg.vision_prefix:
                specs["vision_embeds"] = spec(b, cfg.vision_prefix,
                                              cfg.d_model,
                                              dtype=torch.bfloat16)
                specs["positions"] = spec(3, b, s)
            return specs
        # decode: one new token against a seq_len-deep cache
        return {"token": spec(b, 1)}


def build(cfg: ModelConfig, *, device="cuda", remat: bool = True,
          policy=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``"cuda"``;
    ``"cuda"`` without a card raises ``RuntimeError``).  ``remat`` (the
    reference's default) keeps only each layer's inputs while a gradient
    is taken and runs the layer again in the backward; it changes no
    forward without a gradient.  ``policy``: a
    ``sharding.partitioning.ShardingPolicy`` (None: one device, as
    before)."""
    cls = EncDecTransformer if cfg.family == "encdec" else Transformer
    return Model(cfg=cfg, impl=cls(cfg, device=resolve_device(device),
                                   remat=remat, policy=policy))
