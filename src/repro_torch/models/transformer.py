"""Top-level language model for the ``dense``, ``vlm``, ``ssm``, ``moe``
and ``hybrid`` families (counterpart of ``repro.models.transformer``).

``init(cfg)`` builds a randomly initialised ``Transformer``; ``forward``
returns float32 logits over ``cfg.padded_vocab`` (the padded ids are not
masked, as in the reference); ``lm_loss`` is the training loss;
``init_decode_state`` and ``decode_step`` run prefill and cached decode.
The reference scans stacked per-layer leaves; the port keeps one
``DecoderBlock`` (``RWKV6Block`` for ``ssm``) per layer in an
``nn.ModuleList``; the ``moe`` family (DeepSeek-V2/V3) keeps two,
``dense_blocks`` (the leading ``first_dense_layers``) and ``moe_blocks``,
and with ``mtp_depth`` an ``mtp`` head (``proj``, one dense ``block``,
``ln``); the ``hybrid`` family (Zamba2) keeps ``groups``, a list of
``n_layers / shared_every`` lists of ``shared_every`` ``MambaBlock``s, and
the one ``shared`` attention block visited after each group.  With
``cfg.remat == "block"`` (the reference's ``_maybe_remat``) each block is
an activation checkpoint while a graph is recorded: its activations are
recomputed in the backward pass, so the flash forward and the block's
norms run twice per training step.  On a model that
``sharding.fsdp.shard_model`` placed on a mesh, each block (group) reads
its sharded weights through ``fsdp.gathered`` inside the body that is
checkpointed, so the recompute gathers them again, and ``forward`` gathers
the leaves outside the stacks (the embedding, ``lm_head``) once; the batch
arrives split by ``rules.shard_batch`` (the reference's
``constrain_activations``; its ``maybe_constrain`` annotates GSPMD and has
nothing to do here) and ``lm_loss`` is the global batch's.  On a
``"model"`` axis above 1 (every family but ``moe``,
``rules.check_mesh_family``) the model runs tensor parallel
(``sharding/tp.py``; the blocks in ``blocks.decoder_block_fwd``,
``blocks.MambaBlock`` / ``SharedBlock`` and ``rwkv6.RWKV6Block``): the
embedding looks up this rank's vocab rows, ``forward``'s logits are this
rank's vocab columns (the reference keeps them vocab-sharded), ``_xent``
is the vocab-parallel ``tp.xent``, and ``decode_step`` serves on this
rank's heads and rows of the batch and returns the whole logits on every
rank.

The ``moe`` family trains as the reference does: ``lm_loss`` adds the
averaged ``load_balance`` and ``router_z`` terms and ``0.3 x`` the MTP
cross entropy to the total, and with ``remat="block"`` each dense and MoE
block is a checkpoint whose ``MoEAux`` comes out beside its output (the
MTP block is not checkpointed).  ``recomputing()`` tells code that runs
inside a block (a hook, a patched function) the backward's recompute from
the forward.  The ``ssm`` family (RWKV-6) serves and trains as the
reference does: its loss is the plain cross entropy, with
``remat="block"`` each block is one checkpoint (the reference's
``_maybe_remat(rwkv_body)``), and under a recording graph the recurrence
runs the plain forms that the reference trains through
(``ops.rwkv6_scan``), since neither package's kernel has a backward.  The
``hybrid`` family serves and trains as the
reference does: with ``remat="block"`` each group (its Mamba blocks and
the shared block's visit) is one checkpoint, the reference's
``_maybe_remat(group_body)``; its loss is the plain cross entropy.  The
``audio`` family (Whisper) is the encoder-decoder of ``models/encdec.py``,
as in the reference: ``Transformer`` refuses it, and ``encdec`` reuses
``_run_stack``, ``_readout`` and ``_xent`` from here.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import rwkv6 as R
from repro_torch.sharding import fsdp, rules, tp as TP
from repro_torch.utils.devices import resolve_device

# The module lists whose per-layer leaves the reference stacks on leading
# layer axes (its scan layout), and how many: ``blocks`` (dense, vlm, ssm),
# for moe ``dense_blocks`` and ``moe_blocks``, for audio ``enc_blocks`` and
# ``dec_blocks``, one axis each; for hybrid ``groups``, two ``(n_groups,
# shared_every)``.  The MTP head and the hybrid ``shared`` block are not
# stacked.
STACK_DEPTH = {"blocks": 1, "dense_blocks": 1, "moe_blocks": 1, "groups": 2, "enc_blocks": 1,
               "dec_blocks": 1}
STACKS = tuple(STACK_DEPTH)


def check_serving(cfg, mesh=None) -> None:
    """Raise for a family the port does not know (``audio`` is built by
    ``models/encdec.py``), and with ``mesh`` for one that does not run on
    it (``rules.check_mesh_family``: a ``"model"`` axis above 1 serves every
    family but ``moe`` where it divides the heads, ``d_ff`` and the
    vocab)."""
    if cfg.family not in ("dense", "vlm", "ssm", "moe", "hybrid", "audio"):
        raise NotImplementedError(f"the {cfg.family} family is not ported")
    if mesh is not None:
        rules.check_mesh_family(mesh, cfg)


def check_training(cfg, mesh=None) -> None:
    """Raise for the families the port cannot train (on ``mesh``): those it
    cannot serve.  Every family the port serves trains, as in the
    reference."""
    check_serving(cfg, mesh)


class ForwardOut(NamedTuple):
    logits: torch.Tensor  # (B, T, V) float32
    aux_losses: dict
    mtp_logits: torch.Tensor | None


class MTPHead(nn.Module):
    """The single-depth multi-token-prediction head (deepseek-v3): ``proj``
    ``(2 d, d)``, one dense decoder ``block`` and ``ln``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.proj = L.Linear(2 * cfg.d_model, cfg.d_model, **kw)
        self.block = B.DecoderBlock(cfg, **kw)
        self.ln = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)


class Transformer(nn.Module):
    """``{"embed", "ln_f", "lm_head"?, "blocks"}`` (``moe``: ``"dense_blocks",
    "moe_blocks", "mtp"?`` in place of ``"blocks"``; ``hybrid``: ``"groups",
    "shared"``) with uninitialised
    parameters on ``device`` (``init`` fills them, ``convert`` copies
    them in).  ``tp``: its ``rules.ModelShard`` under tensor
    parallelism."""

    tp: TP.ModelShard | None = None

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        check_serving(cfg)
        if cfg.family == "audio":
            raise ValueError("the audio family is built by models.encdec (EncDec)")
        dev = resolve_device(device)
        kw = dict(dtype=L.dtype_of(cfg), device=dev)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.ln_f = L.init_norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.lm_head = None if cfg.tie_embeddings else L.Linear(cfg.d_model, cfg.padded_vocab, **kw)
        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            self.dense_blocks = nn.ModuleList(B.DecoderBlock(cfg, **kw) for _ in range(nd))
            self.moe_blocks = nn.ModuleList(B.DecoderBlock(cfg, use_moe=True, **kw)
                                            for _ in range(cfg.n_layers - nd))
            self.mtp = MTPHead(cfg, **kw) if cfg.mtp_depth else None
            return
        if cfg.family == "hybrid":
            k_every = cfg.hybrid.shared_every
            self.groups = nn.ModuleList(
                nn.ModuleList(B.MambaBlock(cfg, **kw) for _ in range(k_every))
                for _ in range(cfg.n_layers // k_every))
            self.shared = B.SharedBlock(cfg, **kw)
            return
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
    """Float32 logits of ``h``; under tensor parallelism this rank's vocab
    columns (tied: its embedding rows; untied: ``tp.vocab_columns`` of the
    ``lm_head`` the rules store split along ``d``)."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        h = TP.copy_to_model(h, tp)
        if p.lm_head is not None:
            return L.linear(h, TP.vocab_columns(p.lm_head, tp)).to(torch.float32)
    if p.lm_head is None:
        return p.embed.unembed(h)
    return p.lm_head(h).to(torch.float32)


def _serve_readout(p: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits of ``h`` for serving, whole over the vocab on every
    rank of the ``"model"`` axis.  The untied ``lm_head``, which the rules
    store split along ``d``, runs on this rank's ``d`` columns of ``h``
    against its rows, the partial logits summed over the axis
    (``tp.reduce_from_model``: at a decode step ``B x V`` float32, where
    ``tp.vocab_columns`` would gather the whole kernel); the tied readout's
    vocab columns are gathered (``tp.gather_logits``)."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return _readout(p, h)
    if p.lm_head is not None:
        part = L.linear(TP.local(h, tp, -1), p.lm_head.kernel)
        return TP.reduce_from_model(part, tp).to(torch.float32)
    return TP.gather_logits(_readout(p, h), tp)


_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar("recomputing", default=False)


def recomputing() -> bool:
    """True inside the recompute of a checkpointed block (run from the
    backward pass), False in its first run and outside any block."""
    return _RECOMPUTING.get()


def _checkpointed(fn):
    """``fn`` (a block's or a group's body) run under the ``ops`` mode and
    ``rwkv6_scan`` algorithm of the caller's context, read now.  The
    recompute of an activation checkpoint runs from the backward pass, on
    autograd's thread for CUDA tensors, where the caller's ``ops.forced``
    context is not set; re-entering the mode and algorithm read at the
    first run keeps the recompute on the same kernels or plain versions
    (else it could save other tensors, or mix the two).  Every run after
    the first is a recompute (``recomputing()``)."""
    mode, algorithm = ops.current_mode(), ops.current_algorithm()
    runs = []

    def run(*args):
        token = _RECOMPUTING.set(bool(runs))
        runs.append(None)
        try:
            with ops.forced(mode, algorithm=algorithm):
                return fn(*args)
        finally:
            _RECOMPUTING.reset(token)

    return run


def _block_out_aux(blk: B.DecoderBlock):
    """``(output, aux)`` of ``blk`` as a function of its inputs, its
    sharded weights gathered within."""
    def body(x, positions, *extra):
        with fsdp.gathered(blk):
            out, _, aux = blk(x, positions, *extra)
        return out, aux

    return body


def _run_stack(cfg, blocks, x, positions, *extra) -> tuple[torch.Tensor, list]:
    """``blocks`` in order from ``x``, each called ``blk(x, positions,
    *extra)`` (``extra``: the encoder-decoder's memory): the output and each
    block's aux (its ``MoEAux``, None for a dense FFN).  With ``cfg.remat ==
    "block"`` while a graph is recorded, each block is an activation
    checkpoint (the reference's ``_maybe_remat``), its aux carried out
    beside its output.  A sharded block gathers its weights inside the
    checkpoint (``_block_out_aux``)."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    auxes = []
    for blk in blocks:
        body = _block_out_aux(blk)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _checkpointed(body), x, positions, *extra, use_reentrant=False)
        else:
            x, aux = body(x, positions, *extra)
        auxes.append(aux)
    return x, auxes


def forward(p: Transformer, tokens: torch.Tensor, *, embeddings=None) -> ForwardOut:
    """Logits of ``tokens (B, T)`` (or of the modality-stub ``embeddings
    (B, T, D)``) from a fresh causal pass (for ``ssm``, from a zero
    state).  A sharded model gathers the leaves outside its stacks once
    here, each block its own."""
    with fsdp.gathered(p, skip=_stacks(p)):
        return _forward(p, tokens, embeddings)


def _stacks(p) -> list:
    """The modules of ``p`` that gather their own weights: the block
    stacks and the hybrid ``shared`` block (visited inside each group)."""
    return [getattr(p, n, None) for n in STACKS + ("shared",)]


def _forward(p: Transformer, tokens: torch.Tensor, embeddings) -> ForwardOut:
    b, t = tokens.shape[:2]
    x = p.embed.embed(tokens) if embeddings is None else embeddings
    if p.cfg.family == "ssm":
        return ForwardOut(logits=_readout(p, p.ln_f(_forward_rwkv(p, x))), aux_losses={},
                          mtp_logits=None)
    positions = torch.arange(t, device=x.device).expand(b, t)
    if p.cfg.family == "moe":
        return _forward_moe(p, tokens, x, positions)
    if p.cfg.family == "hybrid":
        return ForwardOut(logits=_readout(p, p.ln_f(_forward_groups(p, x, positions))),
                          aux_losses={}, mtp_logits=None)
    x, _ = _run_stack(p.cfg, p.blocks, x, positions)
    return ForwardOut(logits=_readout(p, p.ln_f(x)), aux_losses={}, mtp_logits=None)


def _forward_rwkv(p: Transformer, x) -> torch.Tensor:
    """The ``ssm`` stack from the embedding ``x``, each block from a zero
    state.  With ``remat == "block"`` while a graph is recorded each block
    is one activation checkpoint (the reference's
    ``_maybe_remat(rwkv_body)``)."""
    remat = p.cfg.remat == "block" and torch.is_grad_enabled()
    for blk in p.blocks:
        def body(h, blk=blk):
            with fsdp.gathered(blk):
                return blk(h)[0]

        x = (torch.utils.checkpoint.checkpoint(_checkpointed(body), x, use_reentrant=False)
             if remat else body(x))
    return x


def _group_body(p: Transformer, group):
    """A hybrid group as a function of ``(x, emb0, positions)``: its Mamba
    blocks from a zero state, then the shared block's visit, their sharded
    weights gathered within."""
    def body(x, emb0, positions):
        with fsdp.gathered(*group, p.shared):
            for blk in group:
                x, _ = blk(x)
            return p.shared(x, emb0, positions)[0]

    return body


def _forward_groups(p: Transformer, x, positions) -> torch.Tensor:
    """The ``hybrid`` stack from the embedding ``x`` (also ``emb0``, the
    shared block's second input): each group then the shared block.  With
    ``remat == "block"`` while a graph is recorded each group is one
    activation checkpoint (the reference's ``_maybe_remat(group_body)``)."""
    remat = p.cfg.remat == "block" and torch.is_grad_enabled()
    emb0 = x
    for group in p.groups:
        body = _group_body(p, group)
        if remat:
            x = torch.utils.checkpoint.checkpoint(_checkpointed(body), x, emb0, positions,
                                                  use_reentrant=False)
        else:
            x = body(x, emb0, positions)
    return x


def _forward_moe(p: Transformer, tokens, x, positions) -> ForwardOut:
    """The ``moe`` forward: the dense stack, then the MoE stack (each block
    checkpointed as ``forward``'s), whose ``MoEAux`` is averaged over its
    layers (the two losses scaled by their weights), and with an MTP head
    (not checkpointed, as the reference's) the logits of token t + 2 from
    ``[h_t ; embed(token t + 1)]`` (the last position's next embedding wraps
    to the first, as ``jnp.roll``)."""
    cfg = p.cfg
    x, _ = _run_stack(cfg, p.dense_blocks, x, positions)
    x, auxes = _run_stack(cfg, p.moe_blocks, x, positions)
    lb, zl, load, drop = (torch.stack(v) for v in zip(*auxes))
    aux = {"load_balance": torch.mean(lb) * cfg.moe.router_aux_weight,
           "router_z": torch.mean(zl) * cfg.moe.router_z_weight,
           "expert_load": torch.mean(load, dim=0), "dropped_fraction": torch.mean(drop)}
    h_final = p.ln_f(x)
    mtp_logits = None
    if p.mtp is not None:
        emb_next = torch.roll(p.embed.embed(tokens), -1, dims=1)
        hm = p.mtp.proj(torch.cat([h_final, emb_next], dim=-1))
        hm, _, _ = p.mtp.block(hm, positions)
        mtp_logits = _readout(p, p.mtp.ln(hm))
    return ForwardOut(logits=_readout(p, h_final), aux_losses=aux, mtp_logits=mtp_logits)


def lm_loss(p: Transformer, tokens: torch.Tensor, labels: torch.Tensor, *,
            embeddings=None) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy over the labels ``>= 0`` (-100 =
    ignore) plus the ``moe`` family's auxiliary terms, as the reference:
    returns ``(total_loss, metrics)`` with ``lm_loss``, ``tokens`` (the
    count of valid labels), every entry of ``forward``'s ``aux_losses``
    (``load_balance`` and ``router_z`` are added to the total,
    ``expert_load`` and ``dropped_fraction`` reported), with an MTP head
    ``mtp_loss`` (the cross entropy of ``mtp_logits`` against the labels
    rolled one step left, the last column ignored; ``0.3 x`` it is added)
    and ``total_loss`` (``dense``, ``vlm``, ``ssm`` and ``hybrid``: the
    cross entropy alone).  On a sharded model ``tokens`` are this rank's
    rows and the loss, ``lm_loss`` and ``tokens`` are the global batch's
    (``_xent``)."""
    check_training(p.cfg)
    out = forward(p, tokens, embeddings=embeddings)
    group = fsdp.data_group(p)
    loss, denom = _xent(out.logits, labels, group, p.tp)
    metrics = {"lm_loss": loss, "tokens": denom}
    total = loss
    for k, v in out.aux_losses.items():
        if k in ("load_balance", "router_z"):
            total = total + v
        metrics[k] = v
    if out.mtp_logits is not None:
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_labels[:, -1] = -100
        mtp_loss, _ = _xent(out.mtp_logits, mtp_labels, group)
        total = total + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["total_loss"] = total
    return total, metrics


def _xent(logits: torch.Tensor, labels: torch.Tensor, group=None,
          tp: TP.ModelShard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean nll over valid labels, valid count)``.  The gold logit is a
    ``gather``: exactly the reference's masked sum over the vocab axis
    (whose only non-zero term is the gold logit), which the reference
    writes so for a vocab sharded across devices.  On one device the
    gather saves materialising a second (B, T, V) float32 tensor and its
    gradient.

    With the ``"data"`` axis's ``group`` (a sharded model; ``labels`` this
    rank's rows) the mean is the global batch's, as the reference's mean
    over its global batch: the count is summed over the ranks (one
    all-reduce; the ranks' counts differ where labels hold -100), each
    rank divides its sum of nll by it, and the ranks' quotients are summed
    (``fsdp.global_sum``, whose gradient is each rank's own share).  So
    the loss is another association of the same sum: within float32
    rounding of the one-process loss, not bit for bit past one rank.
    With ``tp`` (``logits`` this rank's vocab columns) it is the
    vocab-parallel ``tp.xent``."""
    if tp is not None:
        return TP.xent(logits, labels, tp, group)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    count = torch.sum(valid)
    if group is None:
        denom = torch.clamp(count, min=1)
        return torch.sum(nll) / denom, denom
    denom = torch.clamp(fsdp.global_sum(count, group), min=1)
    return fsdp.global_sum(torch.sum(nll) / denom, group), denom


def init_decode_state(cfg, batch: int, max_len: int, *, device="cuda", mesh=None) -> dict:
    """``{"blocks": KVCache}`` with per-layer caches stacked on axis 0,
    ``(n_layers, B, max_len, Hkv, Dh)``, as the reference lays them out;
    for ``ssm`` ``{"blocks": RWKVState}`` with the shift states ``(n_layers,
    B, 1, D)`` and the float32 ``wkv`` ``(n_layers, B, H, hd, hd)``
    stacked the same way (``max_len`` is not read: the state has a fixed
    size); for ``moe`` ``{"dense": KVCache, "moe": KVCache}``, each stack's
    compressed MLA caches ``(n, B, max_len, kv_lora_rank)`` and ``(n, B,
    max_len, qk_rope_head_dim)``; for ``hybrid`` ``{"groups": SSMState,
    "shared": KVCache}``, the Mamba states stacked ``(n_groups,
    shared_every, ...)`` (conv in the model's type, ssm float32) and one
    cache a visit of the shared block, ``(n_groups, B, max_len, H, Dh)``.
    ``audio`` raises: its state holds the encoder's memory
    (``encdec.init_decode_state``).  With ``mesh`` (a sharded model's) the
    state holds this rank's rows of the batch (``_local_rows``) and, on a
    ``"model"`` axis above 1, what this rank's heads need: the KV heads its
    query heads read (``tp.kv_heads``; the hybrid shared block's too), the
    RWKV recurrence of its heads (the shift states whole: its mixes read all
    of ``D``), Mamba2's SSM state of its heads and its conv channels (x of
    its heads, B and C whole).  Not the reference's ``decode_state_specs``,
    which splits the shift states' ``D`` and the conv channels evenly."""
    check_serving(cfg, mesh)
    tp = None
    if mesh is not None:
        _check_sharded_decode(cfg)
        tp = rules.model_shard(mesh)
        batch = _local_batch(batch, mesh)
    if cfg.family == "audio":
        raise ValueError("the audio family's decode state is encdec.init_decode_state")
    dev = resolve_device(device)
    dtype = L.dtype_of(cfg)
    if cfg.family == "moe":
        c = A.init_cache(cfg, batch, max_len, dtype=dtype, device=dev)
        nd = cfg.moe.first_dense_layers
        stacked = lambda n: A.KVCache(k=c.k.new_zeros((n,) + tuple(c.k.shape)),
                                      v=c.v.new_zeros((n,) + tuple(c.v.shape)), length=0)
        return {"dense": stacked(nd), "moe": stacked(cfg.n_layers - nd)}
    if cfg.family == "hybrid":
        k_every = cfg.hybrid.shared_every
        n_groups = cfg.n_layers // k_every
        s = M.init_ssm_state(cfg, batch, dtype=dtype, device=dev, tp=tp)
        c = A.init_cache(cfg, batch, max_len, dtype=dtype, device=dev,
                         kv_heads=TP.kv_heads(B.shared_sub_config(cfg), tp)[1])
        lead = lambda t, *n: t.new_zeros(n + tuple(t.shape))
        return {"groups": M.SSMState(conv=lead(s.conv, n_groups, k_every),
                                     ssm=lead(s.ssm, n_groups, k_every), length=0),
                "shared": A.KVCache(k=lead(c.k, n_groups), v=lead(c.v, n_groups), length=0)}
    if cfg.family == "ssm":
        s = R.init_rwkv_state(cfg, batch, dtype=dtype, device=dev, tp=tp)
        n = cfg.n_layers
        stack = lambda t: t.new_zeros((n,) + tuple(t.shape))
        return {"blocks": R.RWKVState(shift_tm=stack(s.shift_tm), shift_cm=stack(s.shift_cm),
                                      wkv=stack(s.wkv), length=0)}
    c = A.init_cache(cfg, batch, max_len, dtype=dtype, device=dev,
                     kv_heads=TP.kv_heads(cfg, tp)[1])
    shape = (cfg.n_layers,) + tuple(c.k.shape)
    return {"blocks": A.KVCache(k=c.k.new_zeros(shape), v=c.v.new_zeros(shape), length=0)}


def _check_sharded_decode(cfg) -> None:
    if cfg.family == "moe":
        raise ValueError(f"{cfg.name}: the moe family serves sharded only with global router "
                         "statistics and expert parallelism (ROADMAP.md items 9b.9 and 9b.10)")


def _local_batch(batch: int, mesh) -> int:
    """The rows of a batch of ``batch`` that a rank serves: its chunk over
    ``"data"`` where ``rules.batch_spec`` splits the batch, else all."""
    n = rules.axis_sizes(mesh)["data"]
    return batch // n if rules.batch_spec(mesh, batch) == rules.P("data") else batch


def _local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``x (B, ...)`` for serving (``_local_batch``)."""
    n = _local_batch(x.shape[0], mesh)
    return x if n == x.shape[0] else x.chunk(x.shape[0] // n, 0)[rules.axis_index(mesh, "data")]


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
    (``prefill`` is not read, as in the reference).  For ``moe`` the dense
    stack runs before the MoE stack, each on its own caches.  For
    ``hybrid`` each Mamba block advances from its state, overwritten in
    place, and each visit of the shared block attends over its own cache
    (on prefill through ``ops.attention``, its keys and values then
    written).  A sharded model (``fsdp.shard_model``, any family but
    ``moe``; ``state`` from ``init_decode_state(mesh=)``) takes the whole
    batch of ``tokens``, serves this rank's rows (``_local_rows``) on its
    heads, its weights gathered along ``"data"`` a block at a time as
    ``forward`` gathers them (the hybrid shared block once a call), and
    returns the whole logits on every rank (``whole_logits``)."""
    mesh = fsdp.mesh_of(p)
    if mesh is None:
        return _decode_step(p, tokens, state, pos_offset, prefill)
    _check_sharded_decode(p.cfg)
    rows = _local_rows(tokens, mesh)
    with fsdp.gathered(p, skip=_stacks(p)):
        logits, new_state = _decode_step(p, rows, state, pos_offset, prefill)
    return whole_logits(p, logits, tokens.shape[0]), new_state


def whole_logits(p, logits: torch.Tensor, batch: int) -> torch.Tensor:
    """A sharded model's logits of this rank's rows (``_serve_readout``'s,
    whole over the vocab), whole on every rank: gathered over the rows
    where the ``"data"`` axis split a batch of ``batch``."""
    if logits.shape[0] != batch:
        logits = rules.all_gather_dim(logits, 0, fsdp.mesh_of(p).get_group("data"),
                                      span="tp.gather")
    return logits


def _gathering(blk, sharded: bool):
    """``fsdp.gathered(blk)`` for a block of a sharded model, else
    nothing."""
    return fsdp.gathered(blk) if sharded else contextlib.nullcontext()


def _decode_step(p: Transformer, tokens: torch.Tensor, state: dict, pos_offset: int,
                 prefill: bool):
    """``decode_step`` on this rank's rows; a sharded model's blocks each
    gather their weights."""
    sharded = fsdp.mesh_of(p) is not None
    b, t = tokens.shape
    x = p.embed.embed(tokens)
    if p.cfg.family == "hybrid":
        return _decode_hybrid(p, x, state, pos_offset, prefill)
    if p.cfg.family == "ssm":
        st: R.RWKVState = state["blocks"]
        for i, blk in enumerate(p.blocks):
            with _gathering(blk, sharded):
                x, ns = blk(x, R.RWKVState(shift_tm=st.shift_tm[i], shift_cm=st.shift_cm[i],
                                           wkv=st.wkv[i], length=st.length))
            st.shift_tm[i].copy_(ns.shift_tm)
            st.shift_cm[i].copy_(ns.shift_cm)
            st.wkv[i].copy_(ns.wkv)
        return _serve_readout(p, p.ln_f(x)), {"blocks": st._replace(length=st.length + t)}
    positions = pos_offset + torch.arange(t, device=x.device).expand(b, t)
    stacks = ((p.dense_blocks, "dense"), (p.moe_blocks, "moe")) if p.cfg.family == "moe" else \
        ((p.blocks, "blocks"),)
    new_state = {}
    for blocks, key in stacks:
        kvs: A.KVCache = state[key]
        for i, blk in enumerate(blocks):
            with _gathering(blk, sharded):
                if prefill:
                    x, fresh, _ = blk(x, positions, None)
                    A.write_cache(kvs.k[i], fresh.k, kvs.length)
                    A.write_cache(kvs.v[i], fresh.v, kvs.length)
                else:
                    x, _, _ = blk(x, positions,
                                  A.KVCache(k=kvs.k[i], v=kvs.v[i], length=kvs.length))
        new_state[key] = A.KVCache(k=kvs.k, v=kvs.v, length=kvs.length + t)
    return _serve_readout(p, p.ln_f(x)), new_state


def _decode_hybrid(p: Transformer, x, state: dict, pos_offset: int, prefill: bool):
    """``decode_step`` of the ``hybrid`` family from the embedded tokens
    ``x``; a sharded model gathers each Mamba block's weights in turn and
    the shared block's once."""
    sharded = fsdp.mesh_of(p) is not None
    with _gathering(p.shared, sharded):
        return _decode_groups(p, x, state, pos_offset, prefill, sharded)


def _decode_groups(p: Transformer, x, state: dict, pos_offset: int, prefill: bool,
                   sharded: bool):
    b, t, _ = x.shape
    positions = pos_offset + torch.arange(t, device=x.device).expand(b, t)
    gs: M.SSMState = state["groups"]
    sh: A.KVCache = state["shared"]
    emb0 = x
    for g, group in enumerate(p.groups):
        for k, blk in enumerate(group):
            with _gathering(blk, sharded):
                x, ns = blk(x, M.SSMState(conv=gs.conv[g, k], ssm=gs.ssm[g, k],
                                          length=gs.length))
            gs.conv[g, k].copy_(ns.conv)
            gs.ssm[g, k].copy_(ns.ssm)
        if prefill:
            x, fresh = p.shared(x, emb0, positions)
            A.write_cache(sh.k[g], fresh.k, sh.length)
            A.write_cache(sh.v[g], fresh.v, sh.length)
        else:
            x, _ = p.shared(x, emb0, positions, A.KVCache(k=sh.k[g], v=sh.v[g], length=sh.length))
    new_state = {"groups": gs._replace(length=gs.length + t),
                 "shared": A.KVCache(k=sh.k, v=sh.v, length=sh.length + t)}
    return _serve_readout(p, p.ln_f(x)), new_state
