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

Under tensor parallelism (``sharding.fsdp.shard_model`` on a ``"model"``
axis above 1) a ``Linear`` holds its local columns (an up-projection) or
rows (a down-projection) and runs on them unchanged, so the ``FFN`` runs
on its ``d_ff / m`` local columns (its block adds the ranks' partial
outputs, ``blocks.decoder_block_fwd``), and the ``Embedding`` (its ``tp``
set) on its ``V / m`` local rows: ``embed`` is ``sharding.tp.embed`` and
``unembed`` gives this rank's vocab columns.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.sharding import tp as TP

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# A truncated normal at a fixed scale, or a constant: the RWKV-6 leaves
# (``repro.models.rwkv6.init_rwkv6``), the MoE router's kernel (0.02)
# and bias (zeros; ``repro.models.moe.init_moe``), and Mamba2's conv kernel
# (0.5), ``dt_bias`` (zeros) and ``d_skip`` (ones; ``repro.models.mamba2.
# init_mamba2``); the Zamba2 shared block's empty marker ``_sub_heads``;
# the encoder-decoder's learned decoder positions ``dec_pos`` (0.02;
# ``repro.models.encdec.init``).
TRUNC_SCALES = {"mu_base": 0.02, "mix_lora_a": 0.02, "mix_lora_b": 0.02, "decay_lora.a": 0.02,
                "decay_lora.b": 0.02, "mu_k": 0.02, "mu_r": 0.02, "u_bonus": 0.1,
                "router.kernel": 0.02, "conv.kernel": 0.5, "dec_pos": 0.02}
CONSTANTS = {"bias": 0.0, "scale": 1.0, "decay_base": -6.0, "dt_bias": 0.0, "d_skip": 1.0,
             "_sub_heads": 0.0}
# Deterministic vectors over the last axis: Mamba2's ``a_log = log(linspace(1,
# 16, H))`` (``("log_linspace", (1, 16))``; ``log_linspace``).
VECTORS = {"a_log": (1.0, 16.0)}
# The stacked routed experts' leaves ``(E, d_in, d_out)``, named without
# ``kernel`` and scaled as one (``init_moe``'s ``stack_init``).
EXPERT_LEAVES = ("experts.w_gate", "experts.w_up", "experts.w_down")


def log_linspace(lo: float, hi: float, n: int) -> torch.Tensor:
    """``log(linspace(lo, hi, n))`` in float64, rounded to float32 (the
    reference computes it in float32: the two may differ by an ulp)."""
    return torch.log(torch.linspace(lo, hi, n, dtype=torch.float64)).to(F32)


def leaf_rule(name: str, shape) -> tuple[str, object]:
    """``("normal", std)``, ``("constant", value)`` or ``("log_linspace",
    (lo, hi))`` (a vector over the last axis, ``log_linspace``): the JAX package's
    initialiser of the parameter ``name`` (a dotted path) by its leaf name:
    ``kernel`` (and the routed experts' ``w_gate``/``w_up``/``w_down``) a
    normal truncated at 2 sigma scaled by 1/sqrt(d_in) (its second-to-last
    axis), ``embedding`` the same at 0.02, ``bias`` zeros, ``scale`` ones,
    and the leaves of ``TRUNC_SCALES`` and ``CONSTANTS`` (the two-level
    name first: the router's ``kernel`` is drawn at 0.02)."""
    leaf = name.rsplit(".", 1)[-1]
    pair = ".".join(name.split(".")[-2:])
    if pair in TRUNC_SCALES:
        return "normal", TRUNC_SCALES[pair]
    if leaf == "kernel" or pair in EXPERT_LEAVES:
        return "normal", 1.0 / math.sqrt(shape[-2])
    if leaf == "embedding":
        return "normal", 0.02
    if leaf in VECTORS:
        return "log_linspace", VECTORS[leaf]
    for key in (pair, leaf):
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
        elif kind == "log_linspace":
            p.copy_(log_linspace(*val, p.shape[-1]).expand(p.shape))
        else:
            t = torch.empty(p.shape, dtype=F32, device=p.device)
            nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
            p.copy_(t.mul_(val))
            del t  # one float32 leaf at a time (an expert stack is ~15 GB)
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


def gelu(x):
    """``jax.nn.gelu`` (its default tanh form) as XLA evaluates it, ``x *
    (0.5 * (1 + tanh(c * (x + k * x^3))))`` with the constants ``c =
    sqrt(2 / pi)`` and ``k = 0.044715`` in ``x``'s type and every operation
    rounded to it (``x^3`` is ``x * (x * x)``).  In bf16 ``F.gelu``
    (computed in float32 with the exact constants, rounded once) differs
    from it in ~43 % of the elements, by up to an ulp; this form matches
    the JAX package's bits on the CPU."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=F32).to(x.dtype)
    k = torch.tensor(0.044715, dtype=F32).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


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
            return self.w_down(gelu(self.w_gate(x)) * self.w_up(x))
        return self.w_down(gelu(self.w_up(x)))


# --------------------------------------------------------------- embedding


class Embedding(nn.Module):
    """``{"embedding": (vocab, d_model)}``: ``embed`` and the tied
    ``unembed`` readout; with ``tp`` on this rank's vocab rows."""

    tp: TP.ModelShard | None = None

    def __init__(self, vocab: int, d_model: int, *, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, d_model), dtype, device)

    def embed(self, tokens):
        if self.tp is not None:
            return TP.embed(self.embedding, tokens, self.tp)
        return self.embedding[tokens]

    def unembed(self, x):
        """Tied readout ``x @ E^T`` in ``x.dtype``, widened to float32 (with
        ``tp``: this rank's vocab columns)."""
        return (x @ self.embedding.T.to(x.dtype)).to(F32)
