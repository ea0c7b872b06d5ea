"""Shared neural-net layers (counterpart of ``repro.models.layers``).

The JAX package keeps parameters as nested dicts of arrays built by
``init_*`` and consumed by ``*_fwd`` functions.  Here each parameter dict
is an ``nn.Module`` whose attributes carry the JAX leaf names (``kernel``,
``bias``, ``scale``, ``embedding``), so a parameter tree maps onto a
``state_dict`` key for key (``convert.lm_params_from_numpy``).  Module
constructors allocate uninitialised parameters; ``init_weights_`` fills a
module tree from a ``torch.Generator`` with the JAX package's scales.

Activations run in the config dtype, normalisation and softmax statistics
in float32, and bf16 rounds where the reference rounds: after every
``linear``, after ``apply_rope``'s float32 rotation, and on the tied
readout's logits before they are widened to float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# The RWKV-6 leaves (``repro.models.rwkv6.init_rwkv6``): a truncated normal
# at a fixed scale, or a constant.
TRUNC_SCALES = {"mu_base": 0.02, "mix_lora_a": 0.02, "mix_lora_b": 0.02, "decay_lora.a": 0.02,
                "decay_lora.b": 0.02, "mu_k": 0.02, "mu_r": 0.02, "u_bonus": 0.1}
CONSTANTS = {"bias": 0.0, "scale": 1.0, "decay_base": -6.0}


def leaf_rule(name: str, shape) -> tuple[str, float]:
    """``("normal", std)`` or ``("constant", value)``: the JAX package's
    initialiser of the parameter ``name`` (a dotted path) by its leaf name:
    ``kernel`` a normal truncated at 2 sigma scaled by 1/sqrt(d_in) (its
    second-to-last axis), ``embedding`` the same at 0.02, ``bias`` zeros,
    ``scale`` ones, and the RWKV-6 leaves of ``TRUNC_SCALES`` and
    ``CONSTANTS``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return "normal", 1.0 / math.sqrt(shape[-2])
    if leaf == "embedding":
        return "normal", 0.02
    for key in (".".join(name.split(".")[-2:]), leaf):
        if key in TRUNC_SCALES:
            return "normal", TRUNC_SCALES[key]
        if key in CONSTANTS:
            return "constant", CONSTANTS[key]
    raise ValueError(f"no initialiser for parameter {name!r}")


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` in registration order with the
    JAX package's initialisers (``leaf_rule``), drawn in float32 and cast
    to the parameter's type.  (The draws are PyTorch's, not
    ``jax.random``'s; tests carry weights across with numpy instead.)"""
    for name, p in module.named_parameters():
        kind, val = leaf_rule(name, p.shape)
        if kind == "constant":
            p.fill_(val)
        else:
            t = torch.empty(p.shape, dtype=F32, device=p.device)
            nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
            p.copy_(t * val)
    return module


# ------------------------------------------------------------------ linear


def linear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None):
    """``x @ kernel (+ bias)`` in the input type (one rounding per op, as
    the reference)."""
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


class Linear(nn.Module):
    """``{"kernel": (d_in, d_out), "bias"?: (d_out,)}`` (``init_linear``)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, dtype, device):
        super().__init__()
        self.kernel = _param((d_in, d_out), dtype, device)
        self.bias = _param((d_out,), dtype, device) if bias else None

    def forward(self, x):
        return linear(x, self.kernel, self.bias)


# ------------------------------------------------------------------- norms


class RMSNorm(nn.Module):
    """``{"scale": (d,)}``; ``x * rsqrt(mean(x^2) + eps) * scale`` through
    ``ops.rmsnorm`` (the CUDA kernel on the card)."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device)

    def forward(self, x):
        return ops.rmsnorm(x, self.scale, self.eps)


class LayerNorm(nn.Module):
    """``{"scale": (d,), "bias": (d,)}``; statistics in float32, the result
    in the input type."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device)

    def forward(self, x):
        xf = x.to(F32)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(F32) + self.bias.to(F32)).to(x.dtype)


def init_norm(d: int, kind: str, eps: float, *, dtype, device) -> nn.Module:
    """The ``init_norm``/``norm_fwd`` pair as a module of ``kind``
    ``"rmsnorm"`` or ``"layernorm"``."""
    if kind == "rmsnorm":
        return RMSNorm(d, eps, dtype=dtype, device=device)
    if kind == "layernorm":
        return LayerNorm(d, eps, dtype=dtype, device=device)
    raise ValueError(f"unknown norm {kind!r}")


# -------------------------------------------------------------------- RoPE


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """``(sin, cos)`` of shape ``(..., T, head_dim // 2)`` for integer
    positions, computed in float32 as the reference does (``theta ** (i /
    half)`` may differ from XLA's ``pow`` by an ulp)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=positions.device) / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, fraction: float = 1.0):
    """Rotate the first ``fraction`` of the head dim (llama-style half
    split; chatglm rotates half).  ``x`` is ``(B, T, H, D)``, ``sin``/``cos``
    ``(B?, T, rot // 2)``.  The rotation runs in float32 and each half is
    cast back to ``x.dtype``."""
    rot = int(x.shape[-1] * fraction)
    rot -= rot % 2
    half = rot // 2
    x1, x2, x_pass = x[..., :half], x[..., half:rot], x[..., rot:]
    s = sin[..., :half][..., None, :]
    c = cos[..., :half][..., None, :]
    xf1, xf2 = x1.to(F32), x2.to(F32)
    o1 = xf1 * c - xf2 * s
    o2 = xf2 * c + xf1 * s
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------- FFN


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


class FFN(nn.Module):
    """``init_ffn``/``ffn_fwd``: ``swiglu`` and ``geglu`` gate with
    ``w_gate``; ``gelu`` is ``w_down(gelu(w_up x))``."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, dtype, device):
        super().__init__()
        if kind not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown ffn {kind!r}")
        self.kind = kind
        kw = dict(dtype=dtype, device=device)
        self.w_gate = Linear(d_model, d_ff, **kw) if kind != "gelu" else None
        self.w_up = Linear(d_model, d_ff, **kw)
        self.w_down = Linear(d_ff, d_model, **kw)

    def forward(self, x):
        if self.kind == "swiglu":
            return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))
        if self.kind == "geglu":
            return self.w_down(_gelu(self.w_gate(x)) * self.w_up(x))
        return self.w_down(_gelu(self.w_up(x)))


# --------------------------------------------------------------- embedding


class Embedding(nn.Module):
    """``{"embedding": (vocab, d_model)}``: ``embed`` and the tied
    ``unembed`` readout."""

    def __init__(self, vocab: int, d_model: int, *, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, d_model), dtype, device)

    def embed(self, tokens):
        return self.embedding[tokens]

    def unembed(self, x):
        """Tied readout ``x @ E^T`` in ``x.dtype``, widened to float32."""
        return (x @ self.embedding.T.to(x.dtype)).to(F32)
