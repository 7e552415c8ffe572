"""whisper-tiny [audio]: enc-dec, 4L, d=384, 6H (kv=6), ff=1536, vocab=51865.

[arXiv:2212.04356]  Conv/mel frontend is a stub: the encoder consumes
precomputed frame embeddings (B, 1500, 384) via input_specs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, mlp_type="gelu", norm_type="layernorm",
    rope_type="none", tie_embeddings=True, enc_seq=1500, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, mlp_type="gelu", norm_type="layernorm",
        rope_type="none", tie_embeddings=True, enc_seq=16, max_seq=64,
    )
