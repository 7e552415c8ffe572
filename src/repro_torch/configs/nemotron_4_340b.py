"""nemotron-4-340b [dense]: 96L, d=18432, 96H (GQA kv=8), ff=73728,
vocab=256000.  [arXiv:2402.16819]  Squared-ReLU MLP, RoPE, LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, mlp_type="relu2", norm_type="layernorm",
    rope_theta=10000.0, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384,
        vocab_size=256, mlp_type="relu2", norm_type="layernorm", max_seq=64,
    )
