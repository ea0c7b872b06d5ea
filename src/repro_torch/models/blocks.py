"""Block compositions (counterpart of ``repro.models.blocks``): the
pre-norm decoder block with a dense FFN or, for the ``moe`` family's MoE
layers, the MoE FFN (``models/moe.py``); the Mamba2 block wrapper; and the
Zamba2 shared attention block of the ``hybrid`` family.

Under tensor parallelism the decoder block is the Megatron layout the
reference's rules give GSPMD: the residual stream stays replicated over
``"model"`` (``constrain_activations``), ``sharding.tp.copy_to_model``
follows each norm (the columns of ``wq`` / ``wk`` / ``wv`` and of
``w_gate`` / ``w_up`` read it) and ``sharding.tp.reduce_from_model`` adds
the ranks' partial outputs of ``wo`` and ``w_down``.  The Mamba2 block
does the same around ``models/mamba2.py``'s tensor-parallel mixer, and the
Zamba2 shared block feeds that dense block from ``w_concat`` run
row-parallel on ``[x ; emb0]`` (``sharding.tp.row_linear``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.sharding import tp as TP


class DecoderBlock(nn.Module):
    """``{"ln1", "attn", "ln2", "ffn" | "moe"}``: ``x + attn(ln1 x)``, then
    ``x + ffn(ln2 x)`` (the MoE FFN with ``use_moe``)."""

    def __init__(self, cfg, *, dtype, device, use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.attn = A.init_attention(cfg, **kw)
        self.ln2 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        if use_moe:
            self.moe = MOE.MoE(cfg, **kw)
        else:
            self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.ffn, **kw)

    def forward(self, x, positions, cache=None, *, causal=True):
        return decoder_block_fwd(self, self.cfg, x, positions, cache, causal=causal)


def decoder_block_fwd(p: DecoderBlock, cfg, x, positions, cache: A.KVCache | None = None, *,
                      causal: bool = True):
    """Returns ``(x, cache, aux)`` like the reference: ``aux`` is the MoE
    layer's ``MoEAux``, None for a dense FFN.  With tensor parallelism
    (``p.attn.tp``) each sublayer reads its norm's output through
    ``copy_to_model`` and its output is summed over ``"model"``."""
    tp = getattr(p.attn, "tp", None)
    h = TP.copy_to_model(p.ln1(x), tp)
    attn_out, new_cache = A.attention_fwd(p.attn, cfg, h, positions, cache, causal=causal)
    x = x + TP.reduce_from_model(attn_out, tp)
    h = p.ln2(x)
    if hasattr(p, "moe"):
        out, aux = p.moe(h)
        return x + out, new_cache, aux
    return x + TP.reduce_from_model(p.ffn(TP.copy_to_model(h, tp)), tp), new_cache, None


class MambaBlock(nn.Module):
    """``{"ln", "mamba"}``: ``x + mamba(ln x)``; returns ``(x, SSMState)``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.mamba = M.Mamba2(cfg, **kw)

    def forward(self, x, state: M.SSMState | None = None):
        tp = self.mamba.tp
        out, new_state = self.mamba(TP.copy_to_model(self.ln(x), tp), state)
        return x + TP.reduce_from_model(out, tp), new_state


def shared_sub_config(cfg):
    """The dense one-layer config of the Zamba2 shared block (the
    reference's ``sub``): ``hybrid.shared_block_heads`` query and key/value
    heads of ``d_model / heads`` each, the model's FFN and norms."""
    return ModelConfig(
        name=cfg.name + "-shared", family="dense",
        n_layers=1, d_model=cfg.d_model, n_heads=cfg.hybrid.shared_block_heads,
        n_kv_heads=cfg.hybrid.shared_block_heads, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, norm=cfg.norm, norm_eps=cfg.norm_eps,
        ffn=cfg.ffn, rope_theta=cfg.rope_theta, dtype=cfg.dtype,
    )


class SharedBlock(nn.Module):
    """``{"w_concat": (2 d, d), "block", "_sub_heads"}``: one dense decoder
    block whose weights every visit shares, fed ``w_concat(concat(x,
    emb0))`` (the Zamba2 concatenated residual), its output added to ``x``.
    ``_sub_heads`` is the reference's empty float32 marker leaf, carried so
    that the two trees match leaf for leaf; nothing reads it.  With ``tp``
    ``w_concat`` runs on this rank's rows (``tp.row_linear``) and the block
    on its heads and ``d_ff`` columns."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.sub = shared_sub_config(cfg)
        kw = dict(dtype=dtype, device=device)
        self.w_concat = L.Linear(2 * cfg.d_model, cfg.d_model, **kw)
        self.block = DecoderBlock(self.sub, **kw)
        self._sub_heads = L._param((0,), torch.float32, device)

    def forward(self, x, emb0, positions, cache: A.KVCache | None = None):
        """``(x + block(w_concat [x ; emb0]), the block's cache)``."""
        h = TP.row_linear(torch.cat([x, emb0], dim=-1), self.w_concat, self.tp)
        out, new_cache, _ = self.block(h, positions, cache)
        return x + out, new_cache
