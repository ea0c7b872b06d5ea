"""Top-level language model for the ``dense``, ``vlm`` and ``ssm``
families (counterpart of ``repro.models.transformer``).

``init(cfg)`` builds a randomly initialised ``Transformer``; ``forward``
returns float32 logits over ``cfg.padded_vocab`` (the padded ids are not
masked, as in the reference); ``lm_loss`` is the training loss;
``init_decode_state`` and ``decode_step`` run prefill and cached decode.
The reference scans stacked per-layer leaves; the port keeps one
``DecoderBlock`` (``RWKV6Block`` for ``ssm``) per layer in an
``nn.ModuleList``.  With
``cfg.remat == "block"`` (the reference's ``_maybe_remat``) each block is
an activation checkpoint while a graph is recorded: its activations are
recomputed in the backward pass, so the flash forward and the block's
norms run twice per training step.  ``constrain_activations`` and
``maybe_constrain`` are identities on one device and are dropped (sharding
comes with ``sharding/rules.py``).

The ``ssm`` family (RWKV-6) serves but does not train: the reference's
kernel route for its recurrence has no gradient, so ``lm_loss`` (and
``train.build_train_step``) raise for it (``check_training``).  The
``moe`` and ``hybrid`` families (and ``audio``, in ``models/encdec.py`` of
the reference) are not ported yet and raise, naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.utils.devices import resolve_device

_NOT_PORTED = {
    "moe": "the moe family (MLA attention, MoE FFN, MTP; ROADMAP.md queue 1 item 13)",
    "hybrid": "the hybrid family (Mamba2 + Zamba2 shared block; ROADMAP.md queue 1 item 13)",
    "audio": "the audio family (encoder-decoder; ROADMAP.md queue 1 item 13)",
}


def check_serving(cfg) -> None:
    """Raise for the families the port cannot build and serve yet."""
    if cfg.family not in ("dense", "vlm", "ssm"):
        raise NotImplementedError(f"{_NOT_PORTED.get(cfg.family, cfg.family)} is not ported yet")


def check_training(cfg) -> None:
    """Raise for the families the port cannot train: those it cannot serve,
    and ``ssm``, whose recurrence has no backward kernel (nor has the
    reference's kernel route; ROADMAP.md, open question)."""
    check_serving(cfg)
    if cfg.family == "ssm":
        raise NotImplementedError(
            "ssm training is not ported: rwkv6_scan has no backward kernel, as the reference's "
            "kernel route has none (ROADMAP.md, open question)")


class ForwardOut(NamedTuple):
    logits: torch.Tensor  # (B, T, V) float32
    aux_losses: dict
    mtp_logits: torch.Tensor | None


class Transformer(nn.Module):
    """``{"embed", "ln_f", "lm_head"?, "blocks"}`` with uninitialised
    parameters on ``device`` (``init`` fills them, ``convert`` copies
    them in)."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        check_serving(cfg)
        dev = resolve_device(device)
        kw = dict(dtype=L.dtype_of(cfg), device=dev)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.ln_f = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.lm_head = None if cfg.tie_embeddings else L.Linear(cfg.d_model, cfg.padded_vocab, **kw)
        block = R.RWKV6Block if cfg.family == "ssm" else B.DecoderBlock
        self.blocks = nn.ModuleList(block(cfg, **kw) for _ in range(cfg.n_layers))

    def forward(self, tokens, *, embeddings=None) -> ForwardOut:
        return forward(self, tokens, embeddings=embeddings)


def init(cfg, *, device="cuda", generator: torch.Generator | None = None) -> Transformer:
    """A ``Transformer`` with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``)."""
    model = Transformer(cfg, device=device)
    dev = model.embed.embedding.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return L.init_weights_(model, generator)


def _readout(p: Transformer, h: torch.Tensor) -> torch.Tensor:
    if p.lm_head is None:
        return p.embed.unembed(h)
    return p.lm_head(h).to(torch.float32)


def _checkpointed(blk: B.DecoderBlock, mode: str | None):
    """``blk``'s output as a function of its input, run under the ``ops``
    mode ``mode``.  The recompute of an activation checkpoint runs from the
    backward pass, on autograd's thread for CUDA tensors, where the
    caller's ``ops.forced`` context is not set; re-entering the mode read
    at the first run keeps the recompute on the same kernels or plain
    versions (else it could save other tensors, or mix the two)."""

    def run(x, positions):
        with ops.forced(mode):
            return blk(x, positions)[0]

    return run


def forward(p: Transformer, tokens: torch.Tensor, *, embeddings=None) -> ForwardOut:
    """Logits of ``tokens (B, T)`` (or of the modality-stub ``embeddings
    (B, T, D)``) from a fresh causal pass (for ``ssm``, from a zero
    state)."""
    b, t = tokens.shape[:2]
    x = p.embed.embed(tokens) if embeddings is None else embeddings
    if p.cfg.family == "ssm":
        for blk in p.blocks:
            x, _ = blk(x)
        return ForwardOut(logits=_readout(p, p.ln_f(x)), aux_losses={}, mtp_logits=None)
    positions = torch.arange(t, device=x.device).expand(b, t)
    remat = p.cfg.remat == "block" and torch.is_grad_enabled()
    mode = ops.current_mode()
    for blk in p.blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _checkpointed(blk, mode), x, positions, use_reentrant=False)
        else:
            x, _, _ = blk(x, positions)
    return ForwardOut(logits=_readout(p, p.ln_f(x)), aux_losses={}, mtp_logits=None)


def lm_loss(p: Transformer, tokens: torch.Tensor, labels: torch.Tensor, *,
            embeddings=None) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy over the labels ``>= 0`` (-100 =
    ignore); returns ``(total_loss, metrics)`` with ``lm_loss``,
    ``tokens`` (the count of valid labels) and ``total_loss``, as the
    reference.  The dense/vlm families have no auxiliary losses; ``ssm``
    raises (``check_training``)."""
    check_training(p.cfg)
    out = forward(p, tokens, embeddings=embeddings)
    loss, denom = _xent(out.logits, labels)
    return loss, {"lm_loss": loss, "tokens": denom, "total_loss": loss}


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean nll over valid labels, valid count)``.  The gold logit is a
    ``gather``: exactly the reference's masked sum over the vocab axis
    (whose only non-zero term is the gold logit), which the reference
    writes so for a vocab sharded across devices.  On one device the
    gather saves materialising a second (B, T, V) float32 tensor and its
    gradient."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    denom = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(nll) / denom, denom


def init_decode_state(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """``{"blocks": KVCache}`` with per-layer caches stacked on axis 0,
    ``(n_layers, B, max_len, Hkv, Dh)``, as the reference lays them out;
    for ``ssm`` ``{"blocks": RWKVState}`` with the shift states ``(n_layers,
    B, 1, D)`` and the float32 ``wkv`` ``(n_layers, B, H, hd, hd)``
    stacked the same way (``max_len`` is not read: the state has a fixed
    size)."""
    check_serving(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        s = R.init_rwkv_state(cfg, batch, dtype=L.dtype_of(cfg), device=dev)
        n = cfg.n_layers
        stack = lambda t: t.new_zeros((n,) + tuple(t.shape))
        return {"blocks": R.RWKVState(shift_tm=stack(s.shift_tm), shift_cm=stack(s.shift_cm),
                                      wkv=stack(s.wkv), length=0)}
    c = A.init_cache(cfg, batch, max_len, dtype=L.dtype_of(cfg), device=dev)
    shape = (cfg.n_layers,) + tuple(c.k.shape)
    return {"blocks": A.KVCache(k=c.k.new_zeros(shape), v=c.v.new_zeros(shape), length=0)}


def decode_step(
    p: Transformer,
    tokens: torch.Tensor,  # (B, T_new): 1 for decode, more for prefill
    state: dict,
    pos_offset: int,  # absolute position of tokens[:, 0]
    *,
    prefill: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Advance the model over ``tokens`` with caches; returns ``(logits,
    state)``.  ``prefill=True`` runs attention through the training path
    (``ops.attention``, the flash kernel on the card) over the new tokens
    and then writes their keys and values into the cache; otherwise each
    layer attends over its cache.  The cache tensors are updated in place
    and returned with the new length.  For ``ssm`` each block advances its
    recurrence from its layer's state, which is then overwritten in place
    (``prefill`` is not read, as in the reference)."""
    b, t = tokens.shape
    x = p.embed.embed(tokens)
    if p.cfg.family == "ssm":
        st: R.RWKVState = state["blocks"]
        for i, blk in enumerate(p.blocks):
            x, ns = blk(x, R.RWKVState(shift_tm=st.shift_tm[i], shift_cm=st.shift_cm[i],
                                       wkv=st.wkv[i], length=st.length))
            st.shift_tm[i].copy_(ns.shift_tm)
            st.shift_cm[i].copy_(ns.shift_cm)
            st.wkv[i].copy_(ns.wkv)
        return _readout(p, p.ln_f(x)), {"blocks": st._replace(length=st.length + t)}
    positions = pos_offset + torch.arange(t, device=x.device).expand(b, t)
    kvs: A.KVCache = state["blocks"]
    for i, blk in enumerate(p.blocks):
        if prefill:
            x, fresh, _ = blk(x, positions, None)
            A.write_cache(kvs.k[i], fresh.k, kvs.length)
            A.write_cache(kvs.v[i], fresh.v, kvs.length)
        else:
            x, _, _ = blk(x, positions, A.KVCache(k=kvs.k[i], v=kvs.v[i], length=kvs.length))
    new_state = {"blocks": A.KVCache(k=kvs.k, v=kvs.v, length=kvs.length + t)}
    return _readout(p, p.ln_f(x)), new_state
