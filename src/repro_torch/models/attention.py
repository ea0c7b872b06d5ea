"""Grouped-query attention (counterpart of ``repro.models.attention``'s GQA
half): bias, partial RoPE and qk-norm, with the serve substrate's
interface

  * ``gqa_fwd(p, cfg, x, positions, cache=None)`` — training / prefill
    through ``ops.attention`` (the flash-attention kernel on the card);
    returns the fresh cache;
  * ``gqa_fwd(..., cache=KVCache)`` — token decode against a preallocated
    cache ``(B, S, Hkv, Dh)`` through ``_grouped_softmax_attention``.

The port writes new keys and values into the cache in place (the JAX
package returns updated arrays); the returned ``KVCache`` holds the same
tensors with the new length.  Within ``max_len`` both give the same
result; a write past the end, which ``jax.lax.dynamic_update_slice``
clamps to the last slots, raises here.  DeepSeek MLA is not ported yet
(ROADMAP.md queue 1 item 13, the ``moe`` family) and raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor
    v: torch.Tensor
    length: int  # filled prefix, a host integer


def _grouped_softmax_attention(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, S, Hkv, Dh)
    v: torch.Tensor,  # (B, S, Hkv, Dv)
    q_start: int,  # absolute position of q[:, 0]
    scale: float,
) -> torch.Tensor:
    """Decode/chunked-prefill attention with GQA grouping, causal across the
    cache: query ``i`` (absolute ``q_start + i``) attends keys at positions
    up to its own.  The products run in the input type (a bf16 product is
    rounded before it is widened to float32) and the probabilities are
    cast to ``v.dtype`` before the second product, as in the reference."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, dh)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k).to(F32) * scale
    rows = q_start + torch.arange(t, device=q.device)
    mask = torch.arange(s, device=q.device)[None, :] <= rows[:, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshe->bthge", probs.to(v.dtype), v)
    return out.reshape(b, t, h, v.shape[-1])


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + T] = new`` in place; raises past the end."""
    t, s = new.shape[1], cache.shape[1]
    if start < 0 or start + t > s:
        raise ValueError(
            f"cache write of {t} positions at {start} runs past max_len {s} (the JAX package "
            "clamps the start there; the port refuses)"
        )
    cache[:, start:start + t] = new.to(cache.dtype)


class GQAAttention(nn.Module):
    """``init_gqa``: ``wq``, ``wk``, ``wv`` (bias with ``cfg.qkv_bias``),
    ``wo``, and ``q_norm``/``k_norm`` RMSNorms over the head dim with
    ``cfg.qk_norm``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.attention!r} attention is not ported yet (ROADMAP.md queue 1 item 13)"
            )
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = L.Linear(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = L.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = L.Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = L.Linear(cfg.n_heads * hd, d, **kw)
        if cfg.qk_norm:
            self.q_norm = L.RMSNorm(hd, cfg.norm_eps, **kw)
            self.k_norm = L.RMSNorm(hd, cfg.norm_eps, **kw)

    def forward(self, x, positions, cache=None, *, causal=True):
        return gqa_fwd(self, self.cfg, x, positions, cache, causal=causal)


def gqa_fwd(
    p: GQAAttention,
    cfg,
    x: torch.Tensor,  # (B, T, D)
    positions: torch.Tensor,  # (B, T) absolute positions
    cache: KVCache | None = None,
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, KVCache]:
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = p.wq(x).reshape(b, t, cfg.n_heads, hd)
    k = p.wk(x).reshape(b, t, cfg.n_kv_heads, hd)
    v = p.wv(x).reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if cfg.rope_fraction > 0:
        sin, cos = L.rope_frequencies(int(hd * cfg.rope_fraction), cfg.rope_theta, positions)
        q = L.apply_rope(q, sin, cos, cfg.rope_fraction)
        k = L.apply_rope(k, sin, cos, cfg.rope_fraction)

    if cache is None:
        out = ops.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
        ).transpose(1, 2)
        new_cache = KVCache(k=k, v=v, length=t)
    else:
        idx = cache.length
        write_cache(cache.k, k, idx)
        write_cache(cache.v, v, idx)
        # Keys past idx + t are masked for every query; leaving them out
        # changes no probability (each would be exactly 0).
        out = _grouped_softmax_attention(
            q, cache.k[:, :idx + t], cache.v[:, :idx + t], idx, 1.0 / math.sqrt(hd)
        )
        new_cache = KVCache(k=cache.k, v=cache.v, length=idx + t)
    o = out.reshape(b, t, cfg.n_heads * hd)
    return p.wo(o), new_cache


def init_gqa_cache(cfg, batch: int, max_len: int, *, dtype, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def init_attention(cfg, *, dtype, device) -> nn.Module:
    return GQAAttention(cfg, dtype=dtype, device=device)


def attention_fwd(p, cfg, x, positions, cache=None, *, causal: bool = True):
    return gqa_fwd(p, cfg, x, positions, cache, causal=causal)


def init_cache(cfg, batch: int, max_len: int, *, dtype, device) -> KVCache:
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.attention!r} caches are not ported yet (ROADMAP.md queue 1 item 13)"
        )
    return init_gqa_cache(cfg, batch, max_len, dtype=dtype, device=device)
