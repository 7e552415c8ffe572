"""deepseek-67b [dense]: 95L, d=8192, 64H (GQA kv=8), ff=22016, vocab=102400.

[arXiv:2401.02954]  Llama architecture: RMSNorm, RoPE, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102400, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=10000.0, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=256, mlp_type="swiglu", norm_type="rmsnorm", max_seq=64,
    )
