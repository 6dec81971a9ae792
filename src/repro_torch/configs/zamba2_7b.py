"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; unverified].

81 layers = 13 groups of (5 mamba + 1 shared-weight attention application)
+ 3 trailing mamba layers.  The attention+MLP block weights are SHARED across
all 13 applications (zamba's hallmark); a learned per-group gate mixes the
shared block's output back into the backbone.
"""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="zamba2", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
        ssm_state=64, ssm_headdim=64, mamba_per_attn=5)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="zamba2", n_layers=7, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        ssm_state=16, ssm_headdim=16, mamba_per_attn=2, ssd_chunk=16,
        q_chunk=32, kv_chunk=32)
