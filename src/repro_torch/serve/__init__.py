"""Serving: the prefill/decode steps and the batched generation engine."""
from repro_torch.serve.engine import ServeEngine, build_decode_step, build_prefill_step

__all__ = ["ServeEngine", "build_decode_step", "build_prefill_step"]
