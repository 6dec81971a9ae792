"""unionlm-100m — the paper-native config: ~100M-param LM trained end-to-end
on the union-of-joins sample stream (examples/train_lm_on_union.py)."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="unionlm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
        q_chunk=128, kv_chunk=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="unionlm-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        q_chunk=32, kv_chunk=32)
