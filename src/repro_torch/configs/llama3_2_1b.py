"""llama3.2-1b: dense 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        head_dim=64, ffn="swiglu", norm="rmsnorm",
        rope_theta=500_000.0, tie_embeddings=True, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32,
        ffn="swiglu", norm="rmsnorm", tie_embeddings=True,
        pad_vocab_multiple=64,
    )
