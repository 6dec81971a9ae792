"""granite-20b [dense] — llama-arch MQA code model [arXiv:2405.04324; hf]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab=49152)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
        q_chunk=32, kv_chunk=32)
