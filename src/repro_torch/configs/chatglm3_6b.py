"""chatglm3-6b: dense 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (half-dim), GQA  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=65024,
        rope_fraction=0.5, ffn="swiglu", norm="rmsnorm",
        qkv_bias=True, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        rope_fraction=0.5, qkv_bias=True,
        pad_vocab_multiple=64,
    )
