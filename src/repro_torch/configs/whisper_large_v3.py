"""whisper-large-v3: enc-dec audio, 32L decoder d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 — conv frontend STUB (input_specs provides frame
embeddings)  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncDecConfig, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        encdec=EncDecConfig(encoder_layers=32, encoder_seq=1500),
        rope_fraction=0.0, ffn="gelu", norm="layernorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        encdec=EncDecConfig(encoder_layers=2, encoder_seq=64),
        rope_fraction=0.0, ffn="gelu", norm="layernorm", pad_vocab_multiple=64,
    )
