"""paligemma-3b [vlm] — SigLIP patch frontend STUBBED + gemma decoder [arXiv:2407.07726; hf].

Per the assignment, the vision frontend is a stub: ``input_specs()`` supplies
256 precomputed patch embeddings which prepend the text tokens; attention is
bidirectional over the patch prefix (prefix-LM) and causal elsewhere.
"""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
        frontend="patch", n_frontend_tokens=256, prefix_len=256,
        embed_scale=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
        frontend="patch", n_frontend_tokens=16, prefix_len=16,
        embed_scale=True, q_chunk=16, kv_chunk=16)
