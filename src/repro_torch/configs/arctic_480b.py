"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128, d_ff=4864, vocab=32000,
        n_experts=128, top_k=2, moe_dff=4864, dense_residual=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        n_experts=8, top_k=2, moe_dff=64, dense_residual=True,
        moe_capacity_factor=8.0, q_chunk=32, kv_chunk=32)
