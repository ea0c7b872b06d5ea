"""deepseek-v2-236b: MoE 60L d_model=5120 128H d_expert=1536 vocab=102400,
160 routed experts top-6, 2 shared — MLA kv_lora=512  [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288, vocab_size=102400,
        attention="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=160, experts_per_token=6, n_shared_experts=2,
                      d_expert=1536, first_dense_layers=1,
                      router="softmax_topk", capacity_factor=1.25),
        ffn="swiglu", norm="rmsnorm", dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", family="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        attention="mla",
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                      qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=8, experts_per_token=2, n_shared_experts=2,
                      d_expert=64, first_dense_layers=1,
                      router="softmax_topk", capacity_factor=4.0),
        ffn="swiglu", norm="rmsnorm", pad_vocab_multiple=64,
    )
