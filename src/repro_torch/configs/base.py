"""Model/shape configuration system and the architecture registry.

The port's copy of the JAX package's ``configs/base.py``: the same
dataclasses and fields, so a configuration means the same model in both
packages.  ``param_dtype`` answers in torch dtypes.  Every architecture
of ``ARCH_IDS`` is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves them, and each also
provides a ``smoke()`` reduction (same family, tiny dims) for CPU tests.

Input-shape cells are ``ShapeSpec`` instances:
  train_4k     seq 4096  x global batch 256   -> train_step
  prefill_32k  seq 32768 x global batch 32    -> prefill_step
  decode_32k   cache 32768, batch 128         -> serve_step (1 new token)
  long_500k    cache 524288, batch 1          -> serve_step (sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # "auto": the k-aware planner prices the router top-k per (n_experts,
    # top_k); any registered backend name forces one engine
    router_method: str = "auto"
    first_dense_layers: int = 0         # leading layers use a dense MLP


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0                  # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"             # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"
    rope_theta: float = 10000.0
    rope_type: str = "standard"          # standard | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w split of head_dim/2
    tie_embeddings: bool = False
    emb_scale: bool = False              # gemma: scale embeddings by sqrt(d)
    logits_softcap: float = 0.0
    window: int = 0                      # local attention window (0 = global)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                     # encoder frames (frontend stub length)
    # vlm frontend stub
    vision_prefix: int = 0               # leading positions fed by patch embeds
    dtype: str = "bfloat16"
    max_seq: int = 8192                  # positional guardrail only (no abs emb)
    # backend for sampling/routing sorts and top-k; "auto" = planner pick
    sort_method: str = "auto"
    flash_prefill: bool = False          # prefill attention through K6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 512 (Megatron-style padding);
        padded slots are masked to -1e30 in ``logits_from_hidden``."""
        if self.vocab_size % 512 == 0 or self.vocab_size < 4096:
            return self.vocab_size
        return ((self.vocab_size + 511) // 512) * 512

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Mixer for layer i: attn | ssm | rglru."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.rglru is not None:
            pat = self.rglru.block_pattern
            return pat[i % len(pat)]
        return "attn"

    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        gated = self.mlp_type in ("swiglu", "geglu")
        mlp = d * f * (3 if gated else 2)
        total = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += attn
            elif kind == "ssm":
                s = self.ssm
                din = s.expand * d
                nheads = din // s.head_dim
                total += d * (2 * din + 2 * s.d_state + nheads) + din * d
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                total += d * w * 2 + w * d + 3 * w * self.rglru.conv_width \
                    + 2 * w * w
            if self.moe is not None and i >= self.moe.first_dense_layers \
                    and kind != "ssm":
                fe = self.moe.d_ff_expert
                per = d * fe * (3 if gated else 2)
                total += per * (self.moe.n_experts + self.moe.n_shared_experts)
                total += d * self.moe.n_experts
            elif kind == "attn" or kind == "rglru":
                total += mlp if kind == "attn" else 0
            total += 2 * d  # norms
        total += v * d * (1 if self.tie_embeddings else 2)
        enc_attn = 4 * d * d + mlp
        total += self.n_enc_layers * (enc_attn + attn)  # enc + cross-attn approx
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters: MoE counts only top-k experts."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        d = self.d_model
        gated = self.mlp_type in ("swiglu", "geglu")
        per = d * self.moe.d_ff_expert * (3 if gated else 2)
        n_moe_layers = self.n_layers - self.moe.first_dense_layers
        inactive = per * (self.moe.n_experts - self.moe.top_k) * n_moe_layers
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int = 1            # gradient-accumulation steps (train only)

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "whisper_tiny", "deepseek_67b", "minitron_4b", "gemma_2b",
    "nemotron_4_340b", "moonshot_v1_16b", "dbrx_132b",
    "recurrentgemma_2b", "qwen2_vl_72b", "mamba2_13b",
)

# display name -> module id
ALIASES = {
    "whisper-tiny": "whisper_tiny", "deepseek-67b": "deepseek_67b",
    "minitron-4b": "minitron_4b", "gemma-2b": "gemma_2b",
    "nemotron-4-340b": "nemotron_4_340b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b", "dbrx-132b": "dbrx_132b",
    "recurrentgemma-2b": "recurrentgemma_2b", "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-1.3b": "mamba2_13b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def cell_is_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell applies: a 524288-deep
    decode only for a sub-quadratic architecture (the reference's rule)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k dense KV unsupported"
    return True, ""
