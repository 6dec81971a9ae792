"""gemma2-9b [dense] — local+global alternating, logit softcap [arXiv:2408.00118; hf]."""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="gemma2", n_layers=42, d_model=3584,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
        attn_softcap=50.0, final_softcap=30.0, window=4096,
        embed_scale=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke", family="gemma2", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        attn_softcap=50.0, final_softcap=30.0, window=32, embed_scale=True,
        q_chunk=32, kv_chunk=32)
