"""gemma-2b [dense]: 18L, d=2048, 8H (MQA kv=1), head_dim=256, ff=16384,
vocab=256000.  [arXiv:2403.08295]  GeGLU, embedding scaling, tied softmax.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp_type="geglu", norm_type="rmsnorm",
    tie_embeddings=True, emb_scale=True, rope_theta=10000.0, max_seq=33024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=192, vocab_size=256, mlp_type="geglu", norm_type="rmsnorm",
        tie_embeddings=True, emb_scale=True, max_seq=64,
    )
