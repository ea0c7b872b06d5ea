"""Model/config system for the assigned architectures.

One ``ModelConfig`` describes every family (dense / MoE+MLA / SSM / hybrid /
VLM / enc-dec audio); family-specific knobs live in optional sub-blocks.
Configs are plain frozen dataclasses — hashable, printable, diffable — and
each assigned architecture file in this package exports

    full()   -> the exact published configuration (dry-run only)
    smoke()  -> a reduced same-family configuration (CPU tests)

Shapes for the dry-run grid come from ``repro_torch.configs.shapes``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int | None  # None = full-rank queries
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    n_shared_experts: int = 0
    d_expert: int = 0  # expert hidden dim (deepseek "moe_intermediate_size")
    first_dense_layers: int = 1  # leading layers with dense FFN
    router: Literal["softmax_topk", "sigmoid_bias"] = "softmax_topk"
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters (zamba2)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # LoRA rank of the data-dependent decay
    mix_lora: int = 32  # LoRA rank of the token-shift mixers


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: SSM backbone + a shared attention block every k layers.

    The shared block's weights are reused at every application (one copy);
    its input is concat(hidden, initial embedding) projected back down.
    """

    shared_every: int = 6
    shared_block_heads: int = 32


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder."""

    encoder_layers: int = 32
    encoder_seq: int = 1500  # mel frames after the (stubbed) conv frontend
    frontend: Literal["stub"] = "stub"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention
    attention: Literal["gqa", "mla", "none"] = "gqa"
    head_dim: int | None = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the head dim
    # blocks
    ffn: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    qk_norm: bool = False  # chameleon
    tie_embeddings: bool = False
    # family sub-configs
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0
    # housekeeping
    pad_vocab_multiple: int = 256
    scan_layers: bool = True
    remat: Literal["none", "block"] = "block"
    dtype: str = "float32"  # activation/param dtype ("bfloat16" for dry-run)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D accounting."""
        d = self.d_model
        v = self.padded_vocab
        hd = self.resolved_head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        enc_layers = self.encdec.encoder_layers if self.encdec else 0
        for _ in range(enc_layers):
            n += 4 * d * d + 3 * d * self.d_ff  # enc block (swiglu approx)
        per_layer = 0
        if self.attention == "gqa" and self.family != "hybrid":
            # hybrid backbones are attention-free; the shared block's
            # attention is counted once below
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            per_layer += d * q + 2 * d * kv + q * d
        elif self.attention == "mla":
            m = self.mla
            qd = (m.qk_rope_head_dim + m.qk_nope_head_dim) * self.n_heads
            if m.q_lora_rank:
                per_layer += d * m.q_lora_rank + m.q_lora_rank * qd
            else:
                per_layer += d * qd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        if self.rwkv is not None:
            per_layer += 4 * d * d + 2 * d * self.d_ff  # time-mix + channel-mix
        elif self.ssm is not None and self.family in ("ssm", "hybrid"):
            di = self.ssm.expand * d
            per_layer += d * 2 * di + di * d + di * (2 * self.ssm.d_state)
        gates = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.ffn]
        if self.family == "hybrid":
            # Mamba2 backbone layers carry no FFN; the FFN lives in the ONE
            # shared attention block (weights reused at every application).
            n += self.n_layers * per_layer
            hd_s = d // self.hybrid.shared_block_heads
            shared = 4 * d * d + gates * d * self.d_ff + 2 * d * d
            n += shared
        elif self.moe is None:
            if self.rwkv is None:
                per_layer += gates * d * self.d_ff
            n += self.n_layers * per_layer
        else:
            mo = self.moe
            dense_ffn = gates * d * self.d_ff
            expert_ffn = gates * d * mo.d_expert
            moe_ffn = (mo.n_experts + mo.n_shared_experts) * expert_ffn
            n += mo.first_dense_layers * (per_layer + dense_ffn)
            n += (self.n_layers - mo.first_dense_layers) * (per_layer + moe_ffn)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed experts_per_token)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        gates = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.ffn]
        expert_ffn = gates * self.d_model * mo.d_expert
        n_moe_layers = self.n_layers - mo.first_dense_layers
        inactive = n_moe_layers * (mo.n_experts - mo.experts_per_token) * expert_ffn
        return full - inactive
