"""build(config) -> a uniform Model facade over the ported families.

The port of the JAX package's ``models/model_zoo.py``; the facade exposes
what ``launch/`` and the tests need:

    model.init(generator)        -> params (no partition specs)
    model.loss(params, batch)    -> (scalar, aux)       [training]
    model.prefill(params, batch, max_len) -> (last logits, decode state)
    model.decode_state(batch_size, max_len) -> empty decode state
    model.decode_step(params, token, state) -> (logits, state)
    model.input_specs(shape)     -> meta tensors standing in for each input
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.sortspec import resolve_device
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    impl: Any                  # Transformer

    @property
    def device(self) -> torch.device:
        return self.impl.device

    def init(self, gen: torch.Generator):
        return self.impl.init(gen)

    def loss(self, params, batch):
        return self.impl.loss(params, batch)

    def prefill(self, params, batch, max_len: int):
        return self.impl.prefill(params, batch["tokens"], max_len)

    def decode_state(self, batch_size: int, max_len: int):
        return self.impl.init_state(batch_size, max_len)

    def decode_step(self, params, token, state):
        return self.impl.decode_step(params, token, state)

    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Meta tensors (shape and dtype, no storage) for each input of the
        step function this shape exercises."""
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")

        if shape.kind == "train":
            return {"tokens": spec(b, s), "labels": spec(b, s)}
        if shape.kind == "prefill":
            return {"tokens": spec(b, s)}
        # decode: one new token against a seq_len-deep cache
        return {"token": spec(b, 1)}


def build(cfg: ModelConfig, *, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default ``"cuda"``;
    ``"cuda"`` without a card raises ``RuntimeError``)."""
    return Model(cfg=cfg, impl=Transformer(cfg, device=resolve_device(device)))
