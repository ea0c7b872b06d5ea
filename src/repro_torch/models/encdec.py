"""Whisper-style encoder-decoder backbone, the ``audio`` family
(counterpart of ``repro.models.encdec``).

As in the reference the conv/mel frontend is a stub: ``encode`` takes
precomputed frame embeddings ``(B, T_enc, D)``, adds sinusoidal positions
and runs the bidirectional encoder blocks (layernorm, GQA self-attention
through ``ops.attention`` with ``causal=False``, the GELU FFN); the decoder
adds learned positions (``dec_pos``) to the token embeddings and runs
blocks of causal self-attention, cross-attention to the encoder memory and
the FFN, then ``ln_f`` and the untied ``lm_head``.  With ``cfg.remat ==
"block"`` each encoder and decoder block is an activation checkpoint while
a graph is recorded (``transformer._run_stack``), as the reference's
``jax.checkpoint`` of each scanned body.

Cross-attention is plain PyTorch in the reference's rounding order
(``_full_attention``), as the reference computes it in ``jnp`` outside any
Pallas kernel; so is the layernorm.  The flash kernel runs the encoder's
and the decoder's self-attention.

Decode state (``EncDecState``): the decoder self-attention's KV caches
stacked over layers, updated in place as the port's other caches are
(``attention.write_cache``), and every layer's cross K/V, computed once
from the encoder memory by ``init_decode_state``.

Under tensor parallelism (``shard_model`` on a ``"model"`` axis above 1;
``EncDec.tp``) the encoder blocks are ``blocks.decoder_block_fwd``'s
Megatron layout; a decoder block reads each of its three norms through
``sharding.tp.copy_to_model`` and sums the ranks' partial outputs of the
self-attention, the cross-attention (``wq`` / ``wk`` / ``wv`` on this
rank's heads, the keys and values over the replicated memory, ``wo`` on
its rows) and the FFN.  The memory enters the decoder through one
``copy_to_model`` (every block's cross K/V read it on their heads).  The
embedding looks up this rank's vocab rows (``dec_pos`` is replicated),
the training readout gives its vocab columns of the untied ``lm_head``
(``tp.vocab_columns``) and the loss is ``tp.xent``; serving sums the
ranks' partial logits of their ``d`` rows of it
(``transformer._serve_readout``).  Served sharded, the
decode state holds this rank's rows of the batch and its heads' caches and
cross K/V, projected once on its heads, and every step returns the whole
logits on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import fsdp, tp as TP
from repro_torch.utils.devices import resolve_device

F64 = torch.float64
MAX_DEC_POS = 32_832  # learned decoder positions (whisper: 448; decode_32k needs 32768)


class CrossAttention(nn.Module):
    """``init_cross_attention``: ``wq``, ``wk``, ``wv``, ``wo`` (no bias);
    with ``tp`` on this rank's heads, its output this rank's partial
    sum."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = L.Linear(d, cfg.n_heads * hd, **kw)
        self.wk = L.Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wv = L.Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wo = L.Linear(cfg.n_heads * hd, d, **kw)


def cross_attention_fwd(p: CrossAttention, cfg, x: torch.Tensor, memory: torch.Tensor | None,
                        kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """``(out (B, Tq, D), (k, v))`` of the decoder stream ``x (B, Tq, D)``
    attending to ``memory (B, Tm, D)`` (its keys and values projected
    here) or to the precomputed ``kv`` ``(B, Tm, Hkv, hd)`` each (with
    ``tp``, this rank's heads: ``H / m`` and ``Hkv / m``)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = p.wq(x).reshape(b, t, -1, hd)
    k, v = cross_kv(p, cfg, memory) if kv is None else kv
    out = _full_attention(q, k, v, 1.0 / math.sqrt(hd))
    return p.wo(out.reshape(b, t, q.shape[2] * hd)), (k, v)


def cross_kv(p: CrossAttention, cfg, memory: torch.Tensor):
    """The cross-attention's keys and values ``(B, Tm, Hkv, hd)`` of
    ``memory`` (with ``tp``, this rank's KV heads)."""
    b, tm, _ = memory.shape
    hd = cfg.resolved_head_dim
    return p.wk(memory).reshape(b, tm, -1, hd), p.wv(memory).reshape(b, tm, -1, hd)


def _full_attention(q, k, v, scale: float) -> torch.Tensor:
    """Unmasked GQA attention, ``q (B, T, H, hd)``, ``k, v (B, S, Hkv,
    hd)``, rounded as the reference: the logits product in the input type
    (bf16 rounds it), widened to float32 and scaled, the float32 softmax
    cast to ``v``'s type before the second product."""
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, hd)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k).to(L.F32) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshe->bthge", probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)


# ------------------------------------------------------------- encoder ----


class EncoderBlock(B.DecoderBlock):
    """``{"ln1", "attn", "ln2", "ffn"}``: the pre-norm block with
    bidirectional self-attention; returns ``(x, fresh K/V, None)`` as
    ``blocks.DecoderBlock`` does."""

    def forward(self, x, positions):
        return B.decoder_block_fwd(self, self.cfg, x, positions, causal=False)


# ------------------------------------------------------------- decoder ----


class DecoderBlock(nn.Module):
    """``{"ln1", "attn", "ln_x", "xattn", "ln2", "ffn"}``: causal
    self-attention, cross-attention to the encoder memory, the FFN."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.attn = A.GQAAttention(cfg, **kw)
        self.ln_x = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.xattn = CrossAttention(cfg, **kw)
        self.ln2 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.ffn, **kw)

    def forward(self, x, positions, memory=None, self_cache=None, cross_kv=None):
        return decoder_block_fwd(self, self.cfg, x, positions, memory, self_cache, cross_kv)


def decoder_block_fwd(p: DecoderBlock, cfg, x, positions, memory=None,
                      self_cache: A.KVCache | None = None, cross_kv=None):
    """``(x, self-attention cache, None)``: the third slot, where the
    reference returns the cross K/V, is None as a dense block's aux is
    (``transformer._run_stack`` carries it; nothing reads the cross K/V,
    which ``init_decode_state`` computes once).  With tensor parallelism
    (``p.attn.tp``) each sublayer reads its norm's output through
    ``copy_to_model`` and its output is summed over ``"model"``."""
    tp = p.attn.tp
    h = TP.copy_to_model(p.ln1(x), tp)
    attn_out, new_cache = A.gqa_fwd(p.attn, cfg, h, positions, self_cache)
    x = x + TP.reduce_from_model(attn_out, tp)
    h = TP.copy_to_model(p.ln_x(x), tp)
    xout, _ = cross_attention_fwd(p.xattn, cfg, h, memory, cross_kv)
    x = x + TP.reduce_from_model(xout, tp)
    h = TP.copy_to_model(p.ln2(x), tp)
    return x + TP.reduce_from_model(p.ffn(h), tp), new_cache, None


# ------------------------------------------------------------ full model --


class EncDec(nn.Module):
    """``{"embed", "dec_pos", "enc_blocks", "ln_enc", "dec_blocks", "ln_f",
    "lm_head"}`` with uninitialised parameters on ``device`` (``init``
    fills them, ``convert`` copies them in); ``dec_pos`` is ``(MAX_DEC_POS,
    d_model)``.  ``tp``: its ``rules.ModelShard`` under tensor
    parallelism."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"family {cfg.family} is built by models.transformer")
        dev = resolve_device(device)
        kw = dict(dtype=L.dtype_of(cfg), device=dev)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.dec_pos = L._param((MAX_DEC_POS, cfg.d_model), kw["dtype"], dev)
        self.enc_blocks = nn.ModuleList(EncoderBlock(cfg, **kw)
                                        for _ in range(cfg.encdec.encoder_layers))
        self.ln_enc = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.ln_f = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.lm_head = L.Linear(cfg.d_model, cfg.padded_vocab, **kw)

    def forward(self, tokens, frames) -> T.ForwardOut:
        return forward(self, tokens, frames)


def init(cfg, *, device="cuda", generator: torch.Generator | None = None) -> EncDec:
    """An ``EncDec`` with the reference's initialisers, drawn on its device
    from ``generator`` (default: seed 0 on ``device``)."""
    model = EncDec(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=model.embed.embedding.device).manual_seed(0)
    return L.init_weights_(model, generator)


def sinusoids(t: int, d: int, device) -> torch.Tensor:
    """The encoder's sinusoidal positions ``(t, d)`` float32: ``[sin(pos *
    inv), cos(pos * inv)]`` with ``inv = exp(-log(10000) * i / (d / 2))``,
    the reference's expression with each float32 operation correctly
    rounded (computed in float64 and rounded to float32 after each one:
    exact for the products and the quotient, and for ``exp``, ``sin`` and
    ``cos`` but in ties too rare to meet).  XLA's own float32 ``exp`` and
    ``sin`` lie within an ulp of these, and under ``jit`` it reassociates
    the exponent's argument, so the reference's eager and jitted positions
    differ from each other by up to a float32 ulp of the angle (1.2e-4 at
    1499 rad); both are tested against this."""
    half = d // 2
    c = float(torch.tensor(-math.log(10000.0), dtype=L.F32))
    rnd = lambda x: x.to(L.F32).to(F64)
    arg = rnd(rnd(torch.arange(half, dtype=F64, device=device) * c) / half)
    inv = rnd(torch.exp(arg))
    ang = rnd(torch.arange(t, dtype=F64, device=device)[:, None] * inv[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(L.F32)


def _positions(b: int, t: int, start: int, device) -> torch.Tensor:
    return start + torch.arange(t, device=device).expand(b, t)


def encode(p: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """``frames (B, T_enc, D)`` stub-frontend embeddings -> the encoder
    memory ``(B, T_enc, D)``: the positions cast to the frames' type and
    added, the encoder blocks, ``ln_enc``."""
    b, t, _ = frames.shape
    x = frames + sinusoids(t, p.cfg.d_model, frames.device).to(frames.dtype)[None]
    x, _ = T._run_stack(p.cfg, p.enc_blocks, x, _positions(b, t, 0, frames.device))
    return p.ln_enc(x)


def _embed(p: EncDec, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """Token embeddings plus the learned positions ``start ..``; raises
    past ``MAX_DEC_POS`` (where the reference's dynamic slice clamps)."""
    t = tokens.shape[1]
    if start < 0 or start + t > MAX_DEC_POS:
        raise ValueError(f"decoder positions {start}..{start + t - 1} run past MAX_DEC_POS "
                         f"{MAX_DEC_POS}")
    return p.embed.embed(tokens) + p.dec_pos[start:start + t][None]


def forward(p: EncDec, tokens: torch.Tensor, frames: torch.Tensor) -> T.ForwardOut:
    """Float32 logits ``(B, T_dec, V)`` of ``tokens (B, T_dec)`` given
    ``frames (B, T_enc, D)``, from a fresh pass (the encoder, then the
    decoder blocks, each attending to the memory).  A sharded model
    gathers the leaves outside its stacks once here, each block its
    own."""
    with fsdp.gathered(p, skip=(p.enc_blocks, p.dec_blocks)):
        return _forward(p, tokens, frames)


def _forward(p: EncDec, tokens: torch.Tensor, frames: torch.Tensor) -> T.ForwardOut:
    memory = TP.copy_to_model(encode(p, frames), p.tp)
    b, t = tokens.shape
    x = _embed(p, tokens, 0)
    x, _ = T._run_stack(p.cfg, p.dec_blocks, x, _positions(b, t, 0, x.device), memory)
    return T.ForwardOut(logits=T._readout(p, p.ln_f(x)), aux_losses={}, mtp_logits=None)


def lm_loss(p: EncDec, tokens, labels, frames) -> tuple[torch.Tensor, dict]:
    """``(loss, {"lm_loss", "tokens", "total_loss"})``: the mean next-token
    cross entropy over the labels ``>= 0`` (``transformer._xent``; the
    global batch's on a sharded model, ``tokens`` and ``frames`` this
    rank's rows)."""
    loss, denom = T._xent(forward(p, tokens, frames).logits, labels, fsdp.data_group(p), p.tp)
    return loss, {"lm_loss": loss, "tokens": denom, "total_loss": loss}


class EncDecState(NamedTuple):
    self_kv: A.KVCache  # (L, B, max_len, Hkv, hd) each, stacked over layers
    cross_k: torch.Tensor  # (L, B, Tm, Hkv, hd)
    cross_v: torch.Tensor


def init_decode_state(p: EncDec, frames: torch.Tensor, batch: int, max_len: int) -> EncDecState:
    """Encode ``frames`` once and project every layer's cross K/V from the
    memory; empty self-attention caches of ``max_len`` positions.  A
    sharded model takes the whole batch of ``frames`` and keeps this rank's
    rows (``transformer._local_rows``) and its heads."""
    cfg = p.cfg
    mesh = fsdp.mesh_of(p)
    if mesh is not None:
        frames, batch = T._local_rows(frames, mesh), T._local_batch(batch, mesh)
    with fsdp.gathered(p, skip=(p.enc_blocks, p.dec_blocks)):
        memory = encode(p, frames)
    ck = cv = None
    for i, blk in enumerate(p.dec_blocks):
        with T._gathering(blk, mesh is not None):
            k, v = cross_kv(blk.xattn, cfg, memory)
        if ck is None:
            ck = k.new_empty((cfg.n_layers,) + tuple(k.shape))
            cv = v.new_empty(ck.shape)
        ck[i], cv[i] = k, v
    c = A.init_gqa_cache(cfg, batch, max_len, dtype=L.dtype_of(cfg), device=memory.device,
                         kv_heads=TP.kv_heads(cfg, p.tp)[1])
    lead = lambda x: x.new_zeros((cfg.n_layers,) + tuple(x.shape))
    return EncDecState(self_kv=A.KVCache(k=lead(c.k), v=lead(c.v), length=0),
                       cross_k=ck, cross_v=cv)


def decode_step(p: EncDec, tokens: torch.Tensor, state: EncDecState, pos_offset: int, *,
                prefill: bool = False) -> tuple[torch.Tensor, EncDecState]:
    """Advance the decoder over ``tokens (B, T_new)`` at positions
    ``pos_offset ..``; returns ``(logits, state)``.  ``prefill=True`` runs
    the self-attention through ``ops.attention`` (the flash kernel on the
    card) over the new tokens and then writes their keys and values into
    the caches; otherwise each layer attends over its cache.  The caches
    are updated in place and returned with the new length; the cross K/V
    are read.  A sharded model (``state`` from ``init_decode_state``) takes
    the whole batch of ``tokens``, serves this rank's rows on its heads,
    each block's weights gathered along ``"data"`` in turn, and returns the
    whole logits on every rank (``transformer.whole_logits``)."""
    mesh = fsdp.mesh_of(p)
    if mesh is None:
        return _decode_step(p, tokens, state, pos_offset, prefill)
    rows = T._local_rows(tokens, mesh)
    with fsdp.gathered(p, skip=(p.enc_blocks, p.dec_blocks)):
        logits, state = _decode_step(p, rows, state, pos_offset, prefill)
    return T.whole_logits(p, logits, tokens.shape[0]), state


def _decode_step(p: EncDec, tokens: torch.Tensor, state: EncDecState, pos_offset: int,
                 prefill: bool) -> tuple[torch.Tensor, EncDecState]:
    sharded = fsdp.mesh_of(p) is not None
    b, t = tokens.shape
    x = _embed(p, tokens, pos_offset)
    positions = _positions(b, t, pos_offset, x.device)
    kvs = state.self_kv
    for i, blk in enumerate(p.dec_blocks):
        cross = (state.cross_k[i], state.cross_v[i])
        with T._gathering(blk, sharded):
            if prefill:
                x, fresh, _ = blk(x, positions, cross_kv=cross)
                A.write_cache(kvs.k[i], fresh.k, kvs.length)
                A.write_cache(kvs.v[i], fresh.v, kvs.length)
            else:
                cache = A.KVCache(k=kvs.k[i], v=kvs.v[i], length=kvs.length)
                x, _, _ = blk(x, positions, self_cache=cache, cross_kv=cross)
    logits = T._serve_readout(p, p.ln_f(x))
    return logits, state._replace(self_kv=kvs._replace(length=kvs.length + t))
