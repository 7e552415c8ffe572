"""dbrx-132b [moe]: 40L, d=6144, 48H (GQA kv=8), expert ff=10752,
vocab=100352, MoE 16 experts top-4.

[hf:databricks/dbrx-base]  Fine-grained GLU experts, RoPE theta 5e5.  The
full configuration does not fit one card; the port runs its smoke
reduction.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, mlp_type="swiglu", norm_type="layernorm",
    rope_theta=500000.0, max_seq=33024,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                  capacity_factor=1.25),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, mlp_type="swiglu", norm_type="layernorm", max_seq=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      capacity_factor=4.0),
    )
