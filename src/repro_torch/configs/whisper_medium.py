"""whisper-medium [audio] — enc-dec; conv/audio frontend STUBBED [arXiv:2212.04356; unverified].

Per the assignment, the modality frontend is a stub: ``input_specs()``
supplies precomputed 1500-frame embeddings (30 s of audio after the conv
stem); the transformer backbone (24L enc + 24L dec, d=1024) is real.
Decoder uses RoPE (framework-level long-context extension; the released
checkpoint's learned 448-position embedding does not constrain the backbone).
"""

from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51865,
        encdec=True, n_enc_layers=24, frontend="audio", n_frontend_tokens=1500)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        encdec=True, n_enc_layers=2, frontend="audio", n_frontend_tokens=16,
        q_chunk=16, kv_chunk=16)
