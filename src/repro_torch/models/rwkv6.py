"""RWKV-6 "Finch" block (counterpart of ``repro.models.rwkv6``):
data-dependent token-shift mixing and data-dependent decay in the time
mix, the squared-ReLU channel mix.

The recurrence runs through ``ops.rwkv6_scan`` (the CUDA kernel on the
card); the ``ln_x`` group-norm stand-in and the block norms through
``ops.rmsnorm``.  Decode carries ``RWKVState``: the last normed token of
each mix for the token shift and the float32 (H, hd, hd) recurrence state.

Parameter names and shapes follow the reference's tree
(``init_rwkv6``), so ``convert.lm_params_from_numpy`` carries its weights
across.  ``decay_base`` and ``u_bonus`` are float32 in every model, as
there.  bf16 rounds where the reference rounds: after each ``linear``,
``tanh(x @ mix_lora_a)``, the mixing einsum, each ``x + delta * mix``,
the decay LoRA, the squared ReLU and the gates; the decay
``exp(-exp(w_log))`` is computed in float32 and rounded to the model's
type (with ``u_bonus``) before the scan, which widens both again.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor  # (B, 1, D) last normed token seen by the time mix
    shift_cm: torch.Tensor  # (B, 1, D) last normed token seen by the channel mix
    wkv: torch.Tensor  # (B, H, hd, hd) float32 recurrence state
    length: int  # tokens consumed, a host integer


def heads(cfg) -> tuple[int, int]:
    """``(H, hd)``: the recurrence's heads and head dim."""
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


class LoRA(nn.Module):
    """``{"a": (d, rank), "b": (rank, out)}``: ``tanh(x @ a) @ b``."""

    def __init__(self, d: int, rank: int, out: int, *, dtype, device):
        super().__init__()
        self.a = L._param((d, rank), dtype, device)
        self.b = L._param((rank, out), dtype, device)

    def forward(self, x):
        return torch.tanh(x @ self.a) @ self.b


class TimeMix(nn.Module):
    """The reference's ``time`` subtree."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, r = cfg.d_model, cfg.rwkv
        h, hd = heads(cfg)
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.mu_base = L._param((5, d), dtype, device)
        self.mix_lora_a = L._param((d, 5 * r.mix_lora), dtype, device)
        self.mix_lora_b = L._param((5, r.mix_lora, d), dtype, device)
        self.wr = L.Linear(d, d, **kw)
        self.wk = L.Linear(d, d, **kw)
        self.wv = L.Linear(d, d, **kw)
        self.wg = L.Linear(d, d, **kw)
        self.decay_base = L._param((d,), F32, device)
        self.decay_lora = LoRA(d, r.decay_lora, d, **kw)
        self.u_bonus = L._param((h, hd), F32, device)
        self.ln_x = L.RMSNorm(d, cfg.norm_eps, **kw)
        self.wo = L.Linear(d, d, **kw)

    def forward(self, x, state: RWKVState | None = None):
        """``(out, x[:, -1:], wkv)`` for ``x (B, T, D)``, the normed stream."""
        b, t, d = x.shape
        h, hd = heads(self.cfg)
        prev = state.shift_tm if state is not None else x.new_zeros((b, 1, d))
        delta = torch.cat([prev, x[:, :-1]], dim=1) - x
        # Data-dependent mixing coefficients of r, k, v, w, g.
        lora_in = torch.tanh(x @ self.mix_lora_a).reshape(b, t, 5, -1)
        mix = self.mu_base + torch.einsum("btfr,frd->btfd", lora_in, self.mix_lora_b)
        xr, xk, xv, xw, xg = (x + delta * mix[:, :, i] for i in range(5))
        r = self.wr(xr).view(b, t, h, hd)
        k = self.wk(xk).view(b, t, h, hd)
        v = self.wv(xv).view(b, t, h, hd)
        gl = self.wg(xg)
        g = gl * torch.sigmoid(gl)  # jax.nn.silu, rounded per op as there
        w_log = self.decay_base + self.decay_lora(xw).to(F32)
        w = torch.exp(-torch.exp(w_log)).to(x.dtype).view(b, t, h, hd)
        # The (B, T, H, hd) projections go to the scan as (B, H, T, hd)
        # views; the kernel reads them in place and writes o in r's layout.
        out, wkv = ops.rwkv6_scan(
            r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), w.transpose(1, 2),
            self.u_bonus.to(x.dtype), None if state is None else state.wkv,
        )
        out = self.ln_x(out.transpose(1, 2).reshape(b, t, d)) * g
        return self.wo(out), x[:, -1:], wkv


class ChannelMix(nn.Module):
    """The reference's ``channel`` subtree."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.mu_k = L._param((d,), dtype, device)
        self.mu_r = L._param((d,), dtype, device)
        self.wk = L.Linear(d, cfg.d_ff, **kw)
        self.wv = L.Linear(cfg.d_ff, d, **kw)
        self.wr = L.Linear(d, d, **kw)

    def forward(self, x, state: RWKVState | None = None):
        """``(out, x[:, -1:])`` for ``x (B, T, D)``, the normed stream."""
        b, _, d = x.shape
        prev = state.shift_cm if state is not None else x.new_zeros((b, 1, d))
        delta = torch.cat([prev, x[:, :-1]], dim=1) - x
        xk = x + delta * self.mu_k
        xr = x + delta * self.mu_r
        kv = self.wv(torch.square(torch.relu(self.wk(xk))))
        return torch.sigmoid(self.wr(xr)) * kv, x[:, -1:]


class RWKV6Block(nn.Module):
    """``{"ln1", "ln2", "time", "channel"}`` (the reference's stacked block
    leaves): ``x + time(ln1 x)``, then ``x + channel(ln2 x)``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.ln2 = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.time = TimeMix(cfg, **kw)
        self.channel = ChannelMix(cfg, **kw)

    def forward(self, x, state: RWKVState | None = None) -> tuple[torch.Tensor, RWKVState]:
        h1 = self.ln1(x)
        tm, shift_tm, wkv = self.time(h1, state)
        x = x + tm
        h2 = self.ln2(x)
        cm, shift_cm = self.channel(h2, state)
        x = x + cm
        length = (state.length if state is not None else 0) + x.shape[1]
        # The shift states hold the normed streams the mixes consume.
        return x, RWKVState(shift_tm=shift_tm, shift_cm=shift_cm, wkv=wkv, length=length)


def init_rwkv_state(cfg, batch: int, *, dtype, device) -> RWKVState:
    """A zero state for one layer."""
    h, hd = heads(cfg)
    d = cfg.d_model
    return RWKVState(
        shift_tm=torch.zeros((batch, 1, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, 1, d), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
        length=0,
    )
