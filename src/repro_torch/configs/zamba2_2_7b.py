"""zamba2-2.7b: hybrid 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
        hybrid=HybridConfig(shared_every=6, shared_block_heads=32),
        norm="rmsnorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
        hybrid=HybridConfig(shared_every=2, shared_block_heads=4),
        norm="rmsnorm", pad_vocab_multiple=64,
    )
