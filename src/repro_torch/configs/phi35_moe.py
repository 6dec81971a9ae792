"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400, vocab=32064,
        n_experts=16, top_k=2, moe_dff=6400)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        n_experts=4, top_k=2, moe_dff=128, moe_capacity_factor=8.0,
        q_chunk=32, kv_chunk=32)
