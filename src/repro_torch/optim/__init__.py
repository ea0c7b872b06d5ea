"""Optimizer substrate (counterpart of ``repro.optim``): AdamW with
global-norm clipping and a configurable state dtype, the LR schedules, and
int8 gradient compression with error feedback (a library function; the
training loop does not call it, as in the reference)."""
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import (
    CompressionState, Quantized, compress_int8, decompress_int8, init_compression,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "linear_warmup",
    "compress_int8", "decompress_int8", "CompressionState", "Quantized", "init_compression",
]
