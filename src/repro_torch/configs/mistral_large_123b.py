"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
        n_heads=96, n_kv_heads=8, head_dim=128, d_ff=28672, vocab=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke", family="dense", n_layers=3,
        d_model=96, n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        q_chunk=32, kv_chunk=32)
