"""chameleon-34b: early-fusion VLM 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536 — VQ image tokens share the text vocabulary, so the
modality frontend is the (stub) tokenizer; qk-norm for stability
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=65536,
        qk_norm=True, ffn="swiglu", norm="rmsnorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        qk_norm=True, ffn="swiglu", norm="rmsnorm", pad_vocab_multiple=64,
    )
