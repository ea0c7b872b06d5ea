"""Mamba-2 (SSD) block, the zamba2 backbone (counterpart of
``repro.models.mamba2``).

The state-space dual form with a scalar decay per head:

    h_t = a_t * h_{t-1} + b_t x_t^T     (per head: state (d_state, head_dim))
    y_t = c_t^T h_t  + D x_t

``ssd_chunked`` computes it chunk by chunk with the reference's algorithm
(the quadratic form inside a chunk, the recurrence across chunks), in
plain float32 PyTorch: the reference has no kernel for it either.  The
product inside a chunk contracts ``(c_t . b_s) * decay(s -> t)`` against
``x`` as one batched matmul over ``s`` a head, so no ``(B, nc, L, L, H,
P)`` tensor is formed.  A single token (a decode step) takes the direct
recurrence (``ssd_step``) with the same ``exp(log a)`` decay: the
reference pads it to a whole chunk, which computes the same sums.

A causal short conv (``d_conv``) precedes the SSM.  It is the reference's
window form, every output the float32 sum of ``d_conv`` products over a
window of ``[conv state ; xbc]`` rounded once to the model's type; a
window is an ``unfold`` view, whose backward sums each input's windows in
a fixed order (no atomics), so a training step repeats bit for bit.

Decode carries ``SSMState``: the conv state ``(B, d_conv - 1, conv_ch)``
in the model's type and the float32 SSM state ``(B, H, d_state,
head_dim)``.  Parameter names follow the reference's tree
(``init_mamba2``); ``a_log``, ``dt_bias`` and ``d_skip`` are float32 in
every model, as there.  ``softplus`` is the reference's ``logaddexp(x,
0)``; ``y`` is rounded to the model's type before the ``silu(z)`` gate;
``out_norm`` runs through ``ops.rmsnorm`` (the kernel on the card); both
``silu`` gates round as the reference's (``silu``).

Under tensor parallelism (``Mamba2.tp``, set by ``sharding.fsdp.
shard_model``; ``blocks.MambaBlock`` reads the norm's output through
``sharding.tp.copy_to_model`` and sums the partial outputs) a rank runs on
``H / m`` heads.  The rules split ``w_in``'s fused ``[z | x | B | C | dt]``
output dim evenly, across the segments: its product is gathered whole
(``tp.whole_columns``) and the rank keeps its heads' columns of z, x and
dt and the whole B and C (``tp.segments``).  The window-sum conv runs over
those channels with the same columns of the replicated kernel, ``a_log``,
``dt_bias`` and ``d_skip`` are read on its heads, the SSD runs on its
heads, ``out_norm`` over whole rows (``tp.norm_columns``: the one-process
bits forward and backward) cut back to its columns, and ``w_out``
on its rows.  Its decode state holds its rows' conv channels (x of its
heads, B and C) and its heads' SSM state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP

F32 = torch.float32
NEG_BIG = -1e30


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, conv_ch) in the model's type
    ssm: torch.Tensor  # (B, H, d_state, head_dim) float32
    length: int  # tokens consumed, a host integer


def dims(cfg, tp: TP.ModelShard | None = None) -> tuple:
    """``(ssm config, d_inner, n_heads, conv_ch)``; with ``tp`` this rank's
    ``d_inner``, heads and conv channels (x of its heads, B and C)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model // (1 if tp is None else tp.size)
    return s, d_inner, d_inner // s.head_dim, d_inner + 2 * s.d_state


def init_ssm_state(cfg, batch: int, *, dtype, device, tp: TP.ModelShard | None = None) -> SSMState:
    s, _, n_heads, conv_ch = dims(cfg, tp)
    return SSMState(conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
                    ssm=torch.zeros((batch, n_heads, s.d_state, s.head_dim), dtype=F32,
                                    device=device),
                    length=0)


class Conv(nn.Module):
    """``{"kernel": (d_conv, conv_ch)}``."""

    def __init__(self, d_conv: int, ch: int, *, dtype, device):
        super().__init__()
        self.kernel = L._param((d_conv, ch), dtype, device)


class Mamba2(nn.Module):
    """``init_mamba2``: ``w_in`` (the fused ``[z, x, B, C, dt]``
    projection), ``conv``, ``a_log``, ``dt_bias``, ``d_skip``,
    ``out_norm`` and ``w_out``; with ``tp`` on this rank's heads, its
    output this rank's partial sum."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        s, d_inner, n_heads, conv_ch = dims(cfg)
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.w_in = L.Linear(d, 2 * d_inner + 2 * s.d_state + n_heads, **kw)
        self.conv = Conv(s.d_conv, conv_ch, **kw)
        self.a_log = L._param((n_heads,), F32, device)
        self.dt_bias = L._param((n_heads,), F32, device)
        self.d_skip = L._param((n_heads,), F32, device)
        self.out_norm = L.RMSNorm(d_inner, cfg.norm_eps, **kw)
        self.w_out = L.Linear(d_inner, d, **kw)

    def forward(self, x, state: SSMState | None = None):
        return mamba2_fwd(self, self.cfg, x, state)


def ssd_chunked(x, a, b, c, chunk: int, h0):
    """The SSD scan, ``x (B, T, H, P)``, ``a (B, T, H)`` in (0, 1], ``b, c
    (B, T, N)``, ``h0 (B, H, N, P)``, all float32 (the reference's
    ``_ssd_chunked``).  A ragged ``T`` is padded to whole chunks (``a``
    with 1, the others with 0).  Returns ``y (B, T, H, P)`` and the final
    state ``(B, H, N, P)``."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    pad = -t % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    la = torch.log(torch.clamp(a.reshape(bsz, nc, chunk, h), min=1e-20))
    cum = torch.cumsum(la, dim=2)  # inclusive cumulative log-decay (B, nc, L, H)

    # Inside a chunk: y[t] = sum_{s <= t} decay(s -> t) (c_t . b_s) x_s.  The
    # masked (t < s) log-decays are positive and are clamped before exp, so
    # no inf reaches the gradient.
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, L_t, L_s, H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    gamma = torch.exp(torch.where(mask[None, None, :, :, None], dec, NEG_BIG))
    cb = torch.einsum("bgtn,bgsn->bgts", cc, bc)
    w = (cb[..., None] * gamma).permute(0, 1, 4, 2, 3)  # (B, nc, H, L_t, L_s)
    y_intra = torch.matmul(w, xc.permute(0, 1, 3, 2, 4))  # (B, nc, H, L, P)

    # Each chunk's contribution to the state at its end, and its total decay.
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # decay from step s to the chunk's end
    xw = (xc * tail[..., None]).permute(0, 1, 3, 2, 4)  # (B, nc, H, L, P)
    bx = torch.matmul(bc.transpose(2, 3)[:, :, None], xw)  # (B, nc, H, N, P)
    a_chunk = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    hprev, entering = h0.to(F32), []
    for g in range(nc):
        entering.append(hprev)
        hprev = hprev * a_chunk[:, g, :, None, None] + bx[:, g]
    h_prevs = torch.stack(entering, dim=1)  # (B, nc, H, N, P): the state entering each chunk

    # Across chunks: y[t] = (c_t decay(0 -> t)) . h_prev.
    cw = cc[:, :, None] * torch.exp(cum).permute(0, 1, 3, 2)[..., None]  # (B, nc, H, L, N)
    y_inter = torch.matmul(cw, h_prevs)  # (B, nc, H, L, P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, nc * chunk, h, p)[:, :t]
    return y, hprev


def ssd_step(x, a, b, c, h0):
    """One step of the recurrence, ``x (B, 1, H, P)``, ``a (B, 1, H)``,
    ``b, c (B, 1, N)``, ``h0 (B, H, N, P)``, float32: ``ssd_chunked`` on a
    single token (the reference pads it to a chunk, whose padded steps
    decay by exactly 1 and add 0), with its decay ``exp(log(max(a,
    1e-20)))``.  Returns ``y (B, 1, H, P)`` and the new state."""
    decay = torch.exp(torch.log(torch.clamp(a[:, 0], min=1e-20)))  # (B, H)
    xb, bb, cb = x[:, 0], b[:, 0], c[:, 0]
    y_intra = torch.sum(cb * bb, dim=-1)[:, None, None] * xb  # (c . b) x: (B, H, P)
    y_inter = decay[..., None] * torch.einsum("bn,bhnp->bhp", cb, h0)
    h = h0 * decay[..., None, None] + bb[:, None, :, None] * xb[:, :, None, :]
    return (y_intra + y_inter)[:, None], h


def silu(x):
    """``jax.nn.silu`` as XLA evaluates it, ``x * (1 / (1 + exp(-x)))``
    with every operation rounded to ``x``'s type.  In bf16 ``F.silu``
    (computed in float32, rounded once) differs from it in about a third
    of the elements, by an ulp, which the block's two gates would carry
    into every layer."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` goes linear
    above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_fwd(p: Mamba2, cfg, x: torch.Tensor, state: SSMState | None = None):
    """``(out (B, T, D), SSMState)`` of ``x (B, T, D)`` from ``state`` (None:
    zeros).  The returned conv state is a view of this call's window
    input."""
    tp = p.tp
    s, d_inner, n_heads, conv_ch = dims(cfg, tp)
    bsz, t, _ = x.shape
    n = s.d_state
    zxbcdt = TP.whole_columns(x, p.w_in, "kernel", tp)
    kernel = p.conv.kernel
    if tp is None:
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
        dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    else:
        whole = d_inner * tp.size
        z, xs, b, c, dt = TP.segments(zxbcdt, [(whole, True), (whole, True), (n, False),
                                               (n, False), (n_heads * tp.size, True)], tp)
        xbc = torch.cat([xs, b, c], dim=-1)
        kernel = torch.cat(TP.segments(kernel, [(whole, True), (n, False), (n, False)], tp), -1)
    if state is None:
        prev = xbc.new_zeros((bsz, s.d_conv - 1, conv_ch))
        h0 = torch.zeros((bsz, n_heads, s.d_state, s.head_dim), dtype=F32, device=x.device)
    else:
        prev, h0 = state.conv, state.ssm

    full = torch.cat([prev, xbc], dim=1)  # (B, T + d_conv - 1, CH)
    windows = full.to(F32).unfold(1, s.d_conv, 1)  # (B, T, CH, d_conv), a view
    conv = torch.sum(windows * kernel.T.to(F32), dim=-1).to(x.dtype)
    conv_out = silu(conv)
    new_conv = full[:, full.shape[1] - (s.d_conv - 1):]

    xs = conv_out[..., :d_inner].reshape(bsz, t, n_heads, s.head_dim)
    b_in = conv_out[..., d_inner:d_inner + s.d_state].to(F32)
    c_in = conv_out[..., d_inner + s.d_state:].to(F32)
    dt_act = _softplus(dt.to(F32) + TP.local(p.dt_bias, tp))  # (B, T, H)
    a = torch.exp(-dt_act * torch.exp(TP.local(p.a_log, tp)))  # decay in (0, 1)
    xf = xs.to(F32)
    x_scaled = xf * dt_act[..., None]
    if t == 1:
        y, h_f = ssd_step(x_scaled, a, b_in, c_in, h0)
    else:
        y, h_f = ssd_chunked(x_scaled, a, b_in, c_in, s.chunk, h0)
    y = y + xf * TP.local(p.d_skip, tp)[None, None, :, None]
    y = y.reshape(bsz, t, d_inner).to(x.dtype)
    y = y * silu(z)
    out = p.w_out(TP.norm_columns(p.out_norm, y, tp))
    length = (state.length if state is not None else 0) + t
    return out, SSMState(conv=new_conv, ssm=h_f, length=length)
