"""moonshot-v1-16b-a3b [moe]: 48L, d=2048, 16H (kv=16), expert ff=1408,
vocab=163840, MoE 64 experts top-6 (+2 shared), first layer dense.

[hf:moonshotai/Moonlight-16B-A3B]  DeepSeek-V3-style fine-grained MoE;
routing top-k and token grouping run through the port's sorting kernels.
As configured it has 28.39 B parameters (56.8 GB in bf16), 4.80 B active
a token (``n_params``, ``n_active_params``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=11264,
    vocab_size=163840, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=50000.0, max_seq=33024,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, capacity_factor=1.25,
                  first_dense_layers=1),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
        vocab_size=256, mlp_type="swiglu", norm_type="rmsnorm", max_seq=64,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, capacity_factor=4.0,
                      first_dense_layers=1),
    )
