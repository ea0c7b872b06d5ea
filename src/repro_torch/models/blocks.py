"""The pre-norm decoder block (counterpart of ``repro.models.blocks``'s
``init_decoder_block``/``decoder_block_fwd``) with a dense FFN.

The MoE FFN, the Mamba2 block and the Zamba2 shared block are not ported
yet: they come with the ``moe`` and ``hybrid`` family slices (ROADMAP.md
queue 1 item 13); ``DecoderBlock(use_moe=True)`` raises.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention as A
from repro_torch.models import layers as L


class DecoderBlock(nn.Module):
    """``{"ln1", "attn", "ln2", "ffn"}``: ``x + attn(ln1 x)``, then
    ``x + ffn(ln2 x)``."""

    def __init__(self, cfg, *, dtype, device, use_moe: bool = False):
        super().__init__()
        if use_moe:
            raise NotImplementedError("MoE blocks are not ported yet (ROADMAP.md queue 1 item 13)")
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.attn = A.init_attention(cfg, **kw)
        self.ln2 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.ffn, **kw)

    def forward(self, x, positions, cache=None, *, causal=True):
        return decoder_block_fwd(self, self.cfg, x, positions, cache, causal=causal)


def decoder_block_fwd(p: DecoderBlock, cfg, x, positions, cache: A.KVCache | None = None, *,
                      causal: bool = True):
    """Returns ``(x, cache, aux)`` like the reference; ``aux`` (the MoE
    router statistics) is always None here."""
    h = p.ln1(x)
    attn_out, new_cache = A.attention_fwd(p.attn, cfg, h, positions, cache, causal=causal)
    x = x + attn_out
    return x + p.ffn(p.ln2(x)), new_cache, None
