"""deepseek-v3-671b: MoE 61L d_model=7168 128H d_expert=2048 vocab=129280,
256 routed top-8, 1 shared — MLA, aux-loss-free sigmoid router, MTP
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        attention="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=256, experts_per_token=8, n_shared_experts=1,
                      d_expert=2048, first_dense_layers=3,
                      router="sigmoid_bias", capacity_factor=1.25),
        mtp_depth=1,
        ffn="swiglu", norm="rmsnorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                      qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=8, experts_per_token=2, n_shared_experts=1,
                      d_expert=64, first_dense_layers=1,
                      router="sigmoid_bias", capacity_factor=4.0),
        mtp_depth=1,
        ffn="swiglu", norm="rmsnorm", pad_vocab_multiple=64,
    )
