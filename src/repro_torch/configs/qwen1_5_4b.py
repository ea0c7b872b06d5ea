"""qwen1.5-4b: dense 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias  [hf:Qwen/Qwen1.5-4B family; hf]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True, ffn="swiglu", norm="rmsnorm",
        rope_theta=1_000_000.0, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=120, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        qkv_bias=True, ffn="swiglu", norm="rmsnorm",
        pad_vocab_multiple=64,
    )
