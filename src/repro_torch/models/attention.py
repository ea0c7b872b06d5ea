"""Attention variants (counterpart of ``repro.models.attention``):
grouped-query attention with bias, partial RoPE and qk-norm, and DeepSeek
multi-head latent attention (MLA), with the serve substrate's interface

  * ``*_fwd(p, cfg, x, positions, cache=None)`` — training / prefill
    through ``ops.attention`` (the flash-attention kernel on the card);
    returns the fresh cache;
  * ``*_fwd(..., cache=KVCache)`` — token decode against a preallocated
    cache.

KV caches: GQA ``(B, S, Hkv, Dh)`` keys and values; MLA the compressed
``c_kv (B, S, kv_lora_rank)`` in the ``k`` slot and the shared RoPE key
``(B, S, qk_rope_head_dim)`` in the ``v`` slot.  MLA's prefill expands
keys and values per head (query/key head dim ``qk_nope + qk_rope``, value
head dim ``v_head_dim``; the flash kernel takes the narrower value zero-
padded); its decode is the absorbed form (``wk_b`` folded into the query,
``wv_b`` into the output) over the compressed cache.

Under tensor parallelism (``GQAAttention.tp``, set by
``sharding.fsdp.shard_model``) a rank runs ``n_heads / m`` query heads
(its ``wq`` columns, its chunk of the ``wq`` bias, its ``wo`` rows; the
block adds the ranks' partial outputs) and the KV heads they read
(``sharding.tp.kv_heads``): where ``m`` divides the KV heads, its own
``wk`` / ``wv`` columns; where it does not (chatglm3's 2 KV heads on 4
ranks, llama's 8 on 16) the rules still split the ``wk`` / ``wv`` output
dim, off head boundaries, so the rank gathers them whole over ``"model"``
inside the block (``tp.whole_kernel``; the gradient goes back by
reduce-scatter) and keeps the one KV head its query heads read.  Its
caches hold those KV heads (``init_gqa_cache(kv_heads=)``), one a rank
where ``m`` exceeds them: not the reference's ``cache_spec``, which
shards such a cache's sequence instead.  RoPE and the qk-norms act per
head, unchanged.

The port writes new keys and values into the cache in place (the JAX
package returns updated arrays); the returned ``KVCache`` holds the same
tensors with the new length.  Within ``max_len`` both give the same
result; a write past the end, which ``jax.lax.dynamic_update_slice``
clamps to the last slots, raises here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP

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
    ``cfg.qk_norm``.  With ``tp`` it runs on this rank's heads and its
    output is this rank's partial sum."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
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
    if p.tp is None:
        q = p.wq(x).reshape(b, t, cfg.n_heads, hd)
        k = p.wk(x).reshape(b, t, cfg.n_kv_heads, hd)
        v = p.wv(x).reshape(b, t, cfg.n_kv_heads, hd)
    else:
        q, k, v = _local_qkv(p, cfg, x)
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
    o = out.reshape(b, t, q.shape[2] * hd)
    return p.wo(o), new_cache


def _local_qkv(p: GQAAttention, cfg, x):
    """``(q, k, v)`` of this rank's query heads and the KV heads they read
    (``tp.kv_heads``), ``(B, T, heads, hd)`` each."""
    tp, (b, t, _), hd = p.tp, x.shape, cfg.resolved_head_dim
    q = L.linear(x, p.wq.kernel, TP.local(p.wq.bias, tp)).reshape(b, t, -1, hd)
    first, n = TP.kv_heads(cfg, tp)
    out = [q]
    for lin in (p.wk, p.wv):
        if cfg.n_kv_heads % tp.size == 0:
            y = L.linear(x, lin.kernel, TP.local(lin.bias, tp))
        else:
            cols = slice(first * hd, (first + n) * hd)
            bias = None if lin.bias is None else lin.bias[cols]
            y = L.linear(x, TP.whole_kernel(lin, tp)[:, cols], bias)
        out.append(y.reshape(b, t, n, hd))
    return tuple(out)


def init_gqa_cache(cfg, batch: int, max_len: int, *, dtype, device,
                   kv_heads: int | None = None) -> KVCache:
    """Zero caches of ``kv_heads`` KV heads (default: all of them)."""
    heads = cfg.n_kv_heads if kv_heads is None else kv_heads
    shape = (batch, max_len, heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


# ================================================================== MLA ====


class MLAAttention(nn.Module):
    """``init_mla``: ``wq_a``, ``q_a_norm`` and ``wq_b`` with
    ``q_lora_rank`` (else ``wq``), the joint KV compression ``wkv_a`` (to
    ``kv_lora_rank + qk_rope_head_dim``), ``kv_a_norm``, the per-head
    up-projections ``wk_b``, ``wv_b``, and ``wo``.  Both norms are RMSNorms
    whatever ``cfg.norm``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(dtype=dtype, device=device)
        if m.q_lora_rank:
            self.wq_a = L.Linear(d, m.q_lora_rank, **kw)
            self.q_a_norm = L.RMSNorm(m.q_lora_rank, cfg.norm_eps, **kw)
            self.wq_b = L.Linear(m.q_lora_rank, h * qk_dim, **kw)
        else:
            self.wq = L.Linear(d, h * qk_dim, **kw)
        self.wkv_a = L.Linear(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw)
        self.kv_a_norm = L.RMSNorm(m.kv_lora_rank, cfg.norm_eps, **kw)
        self.wk_b = L.Linear(m.kv_lora_rank, h * m.qk_nope_head_dim, **kw)
        self.wv_b = L.Linear(m.kv_lora_rank, h * m.v_head_dim, **kw)
        self.wo = L.Linear(h * m.v_head_dim, d, **kw)

    def forward(self, x, positions, cache=None, *, causal=True):
        return mla_fwd(self, self.cfg, x, positions, cache)


def _mla_q(p: MLAAttention, cfg, x, positions):
    """``(q_nope, q_rope, (sin, cos))``: the queries split at
    ``qk_nope_head_dim``, RoPE on the rope half only."""
    m = cfg.mla
    b, t, _ = x.shape
    if m.q_lora_rank:
        q = p.wq_b(p.q_a_norm(p.wq_a(x)))
    else:
        q = p.wq(x)
    q = q.reshape(b, t, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    sin, cos = L.rope_frequencies(m.qk_rope_head_dim, cfg.rope_theta, positions)
    return q_nope, L.apply_rope(q_rope, sin, cos, 1.0), (sin, cos)


def mla_fwd(
    p: MLAAttention,
    cfg,
    x: torch.Tensor,  # (B, T, D)
    positions: torch.Tensor,  # (B, T) absolute positions
    cache: KVCache | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Causal MLA.  Without a cache: the expanded prefill through
    ``ops.attention`` (q, k of head dim ``qk_nope + qk_rope``, v of
    ``v_head_dim``, scale ``1/sqrt(qk_nope + qk_rope)``), returning the
    compressed cache ``KVCache(k=c_kv, v=k_rope)``.  With one: the absorbed
    decode over the compressed cache, written in place at ``cache.length``;
    the two score products are added in the model's type before the float32
    softmax, and the probabilities cast to ``x.dtype``, as in the
    reference."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, (sin, cos) = _mla_q(p, cfg, x, positions)
    kv_a = p.wkv_a(x)
    c_kv = p.kv_a_norm(kv_a[..., :m.kv_lora_rank])
    k_rope = L.apply_rope(kv_a[..., None, m.kv_lora_rank:], sin, cos, 1.0)[:, :, 0, :]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)

    if cache is None:
        k_nope = p.wk_b(c_kv).reshape(b, t, h, m.qk_nope_head_dim)
        v = p.wv_b(c_kv).reshape(b, t, h, m.v_head_dim)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, m.qk_rope_head_dim)],
                           dim=-1)
        out = ops.attention(q_full.transpose(1, 2), k_full.transpose(1, 2), v.transpose(1, 2),
                            causal=True, scale=scale).transpose(1, 2)
        return p.wo(out.reshape(b, t, h * m.v_head_dim)), KVCache(k=c_kv, v=k_rope, length=t)

    idx = cache.length
    write_cache(cache.k, c_kv, idx)
    write_cache(cache.v, k_rope, idx)
    # Keys past idx + t are masked for every query (probability exactly 0).
    cc, cr = cache.k[:, :idx + t], cache.v[:, :idx + t]
    s = cc.shape[1]
    wk_b = p.wk_b.kernel.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_c = torch.einsum("bthd,rhd->bthr", q_nope, wk_b)
    logits = (torch.einsum("bthr,bsr->bhts", q_c, cc)
              + torch.einsum("bthd,bsd->bhts", q_rope, cr)).to(F32) * scale
    rows = idx + torch.arange(t, device=x.device)
    mask = torch.arange(s, device=x.device)[None, :] <= rows[:, None]
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", probs, cc)
    wv_b = p.wv_b.kernel.reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bthr,rhe->bthe", ctx, wv_b).reshape(b, t, h * m.v_head_dim)
    return p.wo(out), KVCache(k=cache.k, v=cache.v, length=idx + t)


def init_mla_cache(cfg, batch: int, max_len: int, *, dtype, device) -> KVCache:
    m = cfg.mla
    return KVCache(k=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
                   v=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
                   length=0)


def init_attention(cfg, *, dtype, device) -> nn.Module:
    if cfg.attention == "mla":
        return MLAAttention(cfg, dtype=dtype, device=device)
    return GQAAttention(cfg, dtype=dtype, device=device)


def attention_fwd(p, cfg, x, positions, cache=None, *, causal: bool = True):
    if cfg.attention == "mla":
        return mla_fwd(p, cfg, x, positions, cache)
    return gqa_fwd(p, cfg, x, positions, cache, causal=causal)


def init_cache(cfg, batch: int, max_len: int, *, dtype, device,
               kv_heads: int | None = None) -> KVCache:
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype=dtype, device=device)
    return init_gqa_cache(cfg, batch, max_len, dtype=dtype, device=device, kv_heads=kv_heads)
