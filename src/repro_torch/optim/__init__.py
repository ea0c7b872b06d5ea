"""Optimizer substrate (counterpart of ``repro.optim``): AdamW with
global-norm clipping and a configurable state dtype, and the LR schedules.
The reference's int8 gradient compression (``optim/compression.py``) is
not called by the training loop and is not ported yet (ROADMAP.md)."""
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "linear_warmup",
]
