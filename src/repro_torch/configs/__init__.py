"""Architecture configs (assigned pool) + registry, copied from the JAX
package so the port's workload derivation needs nothing of it."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALIASES, ARCH_IDS, full_config, smoke_config, step_cost

__all__ = ["ModelConfig", "ARCH_IDS", "ALIASES", "full_config", "smoke_config", "step_cost"]
