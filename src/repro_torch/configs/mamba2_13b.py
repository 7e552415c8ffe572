"""mamba2-1.3b [ssm]: 48L, d=2048, attention-free, vocab=50280,
ssm_state=128.  [arXiv:2405.21060]  SSD (state-space duality) mixer;
sub-quadratic -> runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, norm_type="rmsnorm", rope_type="none",
    tie_embeddings=True, max_seq=525312,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=256, norm_type="rmsnorm", rope_type="none",
        tie_embeddings=True, max_seq=64,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=8),
    )
