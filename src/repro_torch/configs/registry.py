"""Architecture registry: --arch <id> -> (full config, smoke config)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "stablelm_12b",
    "llama3_2_1b",
    "qwen1_5_4b",
    "chatglm3_6b",
    "deepseek_v2_236b",
    "deepseek_v3_671b",
    "rwkv6_7b",
    "zamba2_2_7b",
    "chameleon_34b",
    "whisper_large_v3",
)

# CLI aliases with the original punctuation
ALIASES = {
    "stablelm-12b": "stablelm_12b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-4b": "qwen1_5_4b",
    "chatglm3-6b": "chatglm3_6b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "chameleon-34b": "chameleon_34b",
    "whisper-large-v3": "whisper_large_v3",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS + tuple(ALIASES))}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def full_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).full()
    return _override(cfg, overrides)


def smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke()
    return _override(cfg, overrides)


def step_cost(arch: str, *, tokens_per_step: float = 2**20, opt_bytes: float = 18.0):
    """Per-step aggregate cost of training ``arch``: the bridge from the 10
    assigned model configs to the power layer's phase/scenario models.

    FLOPs use the standard 6*N_active*tokens accounting; HBM traffic is the
    per-step parameter/gradient/optimizer sweep (``opt_bytes`` bytes per
    parameter ~ bf16 params+grads + fp32 m/v read+write, amortized);
    collective bytes are a 2-pass bf16 ring all-reduce of the gradients.
    Returns ``repro_torch.power.phases.StepCost``.
    """
    from repro_torch.power.phases import StepCost

    cfg = full_config(arch)
    n_full = cfg.param_count()
    n_active = cfg.active_param_count()
    return StepCost(
        flops=6.0 * n_active * tokens_per_step,
        hbm_bytes=opt_bytes * n_full,
        collective_bytes=4.0 * n_full,
    )


def _override(cfg: ModelConfig, overrides) -> ModelConfig:
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
