"""minitron-4b [dense]: 32L, d=3072, 24H (GQA kv=8), ff=9216, vocab=256000.

[arXiv:2407.14679]  Pruned Nemotron-4: RoPE, squared-ReLU MLP (non-gated).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab_size=256000, mlp_type="relu2", norm_type="layernorm",
    rope_theta=10000.0, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=256, mlp_type="relu2", norm_type="layernorm", max_seq=64,
    )
