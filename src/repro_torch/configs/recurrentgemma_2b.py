"""recurrentgemma-2b [hybrid]: 26L, d=2560, 10H (MQA kv=1), ff=7680,
vocab=256000; RG-LRU : local-attention 2:1, window 2048.

[arXiv:2402.19427 Griffin]  Sub-quadratic -> runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, mlp_type="geglu", norm_type="rmsnorm",
    tie_embeddings=True, emb_scale=True, window=2048, max_seq=525312,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                      block_pattern=("rglru", "rglru", "attn")),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, mlp_type="geglu", norm_type="rmsnorm",
        tie_embeddings=True, emb_scale=True, window=8, max_seq=64,
        rglru=RGLRUConfig(lru_width=64, conv_width=4,
                          block_pattern=("rglru", "rglru", "attn")),
    )
