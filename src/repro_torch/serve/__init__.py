"""Serving: the prefill/decode steps and the batched generation engine,
plus the resume-safe power-conditioner operator service."""
from repro_torch.serve.conditioner import AuditLog, ConditionerService
from repro_torch.serve.engine import ServeEngine, build_decode_step, build_prefill_step

__all__ = ["AuditLog", "ConditionerService", "ServeEngine", "build_decode_step",
           "build_prefill_step"]
