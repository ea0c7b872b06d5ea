"""int8 gradient compression with error feedback (counterpart of
``repro.optim.compression``).

The cross-pod gradient all-reduce is the bandwidth bottleneck at 1000+
nodes; int8 quantization cuts its bytes 4x against float32 (2x against
bf16).  Error feedback keeps the quantization residual of each leaf in a
float32 state and adds it to the next step's gradient, so the sum of what
was sent tracks the sum of the true gradients within one quantization
step.

Gradients, values, scales and errors are dicts keyed by parameter names,
as ``adamw_update`` takes them.  Leaf by leaf: ``g32 = g.float() + e``,
``scale = max(max|g32|, 1e-12) / 127``, ``q = int8(clip(round(g32 /
scale), -127, 127))`` (``round`` half to even, as ``jnp.round``) and the
new error ``g32 - q * scale``; each operation is correctly rounded, so
the card, the CPU and the reference give the same bits.  The training
loop does not call it, as in the reference::

    q, state = compress_int8(grads, state)     # before the all-reduce
    grads = decompress_int8(q)                 # after
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


class Quantized(NamedTuple):
    values: dict  # int8 leaves
    scales: dict  # float32 0-d scale a leaf


class CompressionState(NamedTuple):
    error: dict  # float32 residual a leaf


def init_compression(params: dict) -> CompressionState:
    """A zero float32 error beside each leaf of ``params``."""
    return CompressionState(
        error={n: torch.zeros(p.shape, dtype=F32, device=p.device) for n, p in params.items()})


def _one(g: torch.Tensor, e: torch.Tensor):
    g32 = g.to(F32) + e
    # A tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which can round the scale one ulp off.
    levels = torch.full((), 127.0, dtype=F32, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / levels
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.to(F32) * scale


@torch.no_grad()
def compress_int8(grads: dict, state: CompressionState) -> tuple[Quantized, CompressionState]:
    """``(Quantized(values, scales), CompressionState(error))`` of
    ``grads`` with ``state``'s error fed back, leaf by leaf."""
    out = {n: _one(g, state.error[n]) for n, g in grads.items()}
    return (Quantized(values={n: o[0] for n, o in out.items()},
                      scales={n: o[1] for n, o in out.items()}),
            CompressionState(error={n: o[2] for n, o in out.items()}))


@torch.no_grad()
def decompress_int8(q: Quantized) -> dict:
    """The float32 gradients ``values * scale`` of ``q``."""
    return {n: v.to(F32) * q.scales[n] for n, v in q.values.items()}
