"""qwen2-vl-72b [vlm]: 80L, d=8192, 64H (GQA kv=8), ff=29568, vocab=152064.

[arXiv:2409.12191]  M-RoPE backbone (t/h/w rotary sections); the vision
encoder is a stub — input_specs supplies merged patch embeddings for the
leading `vision_prefix` positions plus (3, B, S) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, mlp_type="swiglu", norm_type="rmsnorm",
    rope_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1000000.0,
    vision_prefix=1024, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=256, mlp_type="swiglu", norm_type="rmsnorm",
        rope_type="mrope", mrope_sections=(2, 3, 3), vision_prefix=4,
        max_seq=64,
    )
