"""mamba2-780m [ssm] — SSD state-space duality [arXiv:2405.21060; unverified]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="mamba2", n_layers=48, d_model=1536,
        n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50280,
        ssm_state=128, ssm_headdim=64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="mamba2", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=512,
        ssm_state=16, ssm_headdim=16, ssd_chunk=16)
