"""rwkv6-7b (Finch): attention-free 32L d_model=4096 d_ff=14336
vocab=65536 — data-dependent decay  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab_size=65536,
        attention="none",
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        norm="rmsnorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        attention="none",
        rwkv=RWKVConfig(head_dim=64, decay_lora=16, mix_lora=8),
        norm="rmsnorm", pad_vocab_multiple=64,
    )
