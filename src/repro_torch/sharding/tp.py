"""Tensor parallelism: the ``"model"`` axis of the spec rules' layout.

The reference places the parameters by ``rules.param_specs`` (up-projections'
output dims, down-projections' input dims and the vocab on ``"model"``),
keeps the activations between blocks batch-sharded on ``"data"`` and
replicated over ``"model"`` (``constrain_activations``), and the logits
vocab-sharded (``_readout``'s ``maybe_constrain(logits, ("pod", "data"),
None, "model")``); GSPMD then inserts the collectives.  This module is the
explicit form of what it inserts, each piece an autograd Function over the
``"model"`` group of a ``rules.ModelShard`` through ``rules``' collectives
(gloo for ranks that share one card and on the CPU, nccl across cards).
The families that run it are those ``rules.check_mesh_family`` admits:
``dense``, ``vlm``, ``ssm``, ``hybrid`` and ``audio``.

Between a block's norm and its output a rank works on its own heads,
columns or rows: ``copy_to_model`` stands after each norm, so every
gradient that a rank's part sends back into that stretch (through a
replicated leaf too) is its part alone, and the parts are summed there or
by ``fsdp.reduce_grads``; the output comes back replicated through
``reduce_from_model`` (partial sums) or ``gather_output`` (whole columns).

* ``copy_to_model``: the identity forward, the gradient all-reduced (sum)
  backward.  It stands at the input of every column-parallel projection
  (after ``ln1`` and ``ln2``, before the readout), where each rank's
  columns read the replicated activation.  Span ``tp.copy``.
* ``reduce_from_model``: the sum over the ranks forward, the identity
  backward.  It stands at the output of ``wo`` and ``w_down``.  The
  choice GSPMD leaves open: each rank's partial product is its GEMM's
  output in the activation dtype (one rounding, as the one-process GEMM's
  output), and the partials are added in float32 and rounded to the
  activation dtype once.  Span ``tp.reduce``.
* ``gather_columns``: an activation's last dim gathered whole inside that
  stretch (``fsdp.gather`` over the model group: an all-gather forward, the
  gradient reduce-scattered backward), where a rank needs columns it does
  not compute: a fused output the rules split off its segments
  (``mix_lora_a``, ``w_in``: ``whole_columns``, then ``segments``), and
  the squared-ReLU key of RWKV's channel mix.  Spans ``tp.gather`` /
  ``tp.reduce``.
* ``norm_columns``: a norm over a width the ranks' columns split (RWKV's
  ``ln_x``, Mamba2's ``out_norm``), on whole rows both ways: the columns
  gathered forward (``gather_output``) and the norm's output cut back to
  this rank's columns, whose gradient is all-gathered backward, so the
  ``rmsnorm`` kernel and its backward run on whole rows with the
  one-process bits on every rank, and the norm's scale gets the same
  gradient on every rank.  Span ``tp.gather``.
* ``gather_output``: the all-gather of a block's output columns into the
  replicated stream (RWKV's channel mix, which the rules leave split on
  ``d``: its ``wv`` is an up kernel); backward, this rank's chunk of the
  replicated gradient.
* ``row_linear``: a down kernel read on a replicated input (Zamba2's
  ``w_concat`` over ``[x ; emb0]``): this rank's rows of the input
  against its rows of the kernel, summed by ``reduce_from_model``.
* ``embed``: the vocab-parallel lookup; a rank looks up the tokens in its
  rows, zeros elsewhere, and ``reduce_from_model`` adds the ranks' rows
  (one non-zero term a token: exact).
* ``xent``: the vocab-parallel cross entropy of ``transformer._xent``: the
  maximum over the vocab all-reduced (no gradient), the sum of ``exp``
  and the gold logit (the reference's masked sum over the vocab, one
  non-zero term) summed over the ranks, then the global batch's mean over
  ``"data"`` as ``_xent`` composes it (``fsdp.global_sum``).
* ``gather_logits``: the all-gather of the tied readout's logits over the
  vocab, for serving: every rank samples the same token from the same
  generator.  The untied ``lm_head`` serves by the activation route
  instead (``transformer._serve_readout``: this rank's ``d`` columns of
  the stream against its rows of the kernel, the partial logits summed by
  ``reduce_from_model``).
* ``whole_kernel`` / ``vocab_columns``: a model-sharded weight gathered
  whole along ``"model"`` inside the block that reads it (``fsdp.gather``
  over the model group: an all-gather forward, a reduce-scatter of the
  gradient backward).  ``wk`` / ``wv`` where the KV heads do not divide the
  axis (the rules split their output dim off head boundaries), and the
  untied ``lm_head``, whose rules split ``d`` on ``"model"`` (the embed
  role reads ``shape[-2]`` as the vocab) while the training readout runs
  on this rank's vocab columns (``xent``).

Every helper is the identity (or the plain product) without a ``tp``, so
the blocks read the same with and without tensor parallelism.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import fsdp, rules
from repro_torch.sharding.rules import ModelShard, shard_of

F32 = torch.float32


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        (total,) = rules.all_reduce_sum([grad.to(F32)], ctx.group, span="tp.copy")
        return total.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        (total,) = rules.all_reduce_sum([x.to(F32)], group, span="tp.reduce")
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """``x`` (replicated over ``"model"``) as the input of this rank's
    columns: its gradient, each rank's part, is summed over the axis."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """The sum over ``"model"`` of each rank's partial ``x``, added in
    float32 and rounded to ``x``'s dtype once; the gradient of each part is
    the sum's."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def local(x: torch.Tensor | None, tp: ModelShard | None, dim: int = 0) -> torch.Tensor | None:
    """This rank's contiguous chunk of ``x`` along ``dim`` (a bias the
    rules replicate, read on this rank's columns); ``x`` without a
    ``tp``."""
    return x if x is None or tp is None else x.chunk(tp.size, dim)[tp.rank]


class _GatherOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.size, ctx.rank = size, rank
        return rules.all_gather_dim(x, x.ndim - 1, group, span="tp.gather")

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, -1)[ctx.rank].contiguous(), None, None, None


def gather_columns(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """The ranks' columns of ``x`` concatenated along its last dim, read by
    this rank's part of a block: the gradient, each rank's part, is
    reduce-scattered (summed) back to the columns."""
    if tp is None:
        return x
    return fsdp.gather(x, x.ndim - 1, tp.group, spans=("tp.gather", "tp.reduce"))


def gather_output(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """The ranks' columns of a block's output concatenated along the last
    dim into the replicated stream: the gradient, the same on every rank,
    comes back as this rank's columns of it."""
    return x if tp is None else _GatherOutput.apply(x, tp.group, tp.size, tp.rank)


class _SplitColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.group = tp.group
        return local(x, tp, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return rules.all_gather_dim(grad, grad.ndim - 1, ctx.group, span="tp.gather"), None


def norm_columns(norm, x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """This rank's columns of ``norm`` over the whole rows of ``x``, this
    rank's columns of them: the rows gathered (``gather_output``), normed,
    and cut back to its columns, whose gradient is gathered whole again, so
    the norm's backward runs on whole rows, the same bits on every rank."""
    if tp is None:
        return norm(x)
    return _SplitColumns.apply(norm(gather_output(x, tp)), tp)


def whole_columns(x: torch.Tensor, owner, name: str, tp: ModelShard | None) -> torch.Tensor:
    """``x @ owner.<name>`` whole along its last dim: an up kernel's
    product on this rank's columns gathered (``gather_columns``) where the
    rules split its output dim, else the product with the whole kernel."""
    y = x @ getattr(owner, name)
    info = shard_of(owner._parameters[name])
    return y if tp is None or info is None or info.model_dim is None else gather_columns(y, tp)


def segments(x: torch.Tensor, parts, tp: ModelShard | None, dim: int = -1) -> list:
    """``x`` cut along ``dim`` into consecutive segments of ``parts``'
    ``(size, split)``: this rank's chunk of each ``split`` segment (its
    heads' columns), the others whole (Mamba2's ``[z | x | B | C | dt]``:
    z, x and dt split, B and C whole)."""
    out, start = [], 0
    for size, split in parts:
        seg = x.narrow(dim, start, size)
        out.append(local(seg, tp, dim) if split else seg)
        start += size
    return out


def row_linear(u: torch.Tensor, linear, tp: ModelShard | None) -> torch.Tensor:
    """``linear(u)`` for a replicated ``u`` and a down kernel: where the
    rules split its input rows on ``"model"``, this rank's columns of ``u``
    (its gradient summed by ``copy_to_model``) times its rows of the kernel,
    the partial products summed by ``reduce_from_model``; else the product
    with the whole kernel."""
    info = shard_of(linear._parameters["kernel"])
    if tp is None or info is None or info.model_dim is None:
        return linear(u)
    part = local(copy_to_model(u, tp), tp, -1) @ linear.kernel
    return reduce_from_model(part, tp)


def kv_heads(cfg, tp: ModelShard | None) -> tuple[int, int]:
    """``(first, count)``: the KV heads this rank's query heads read.  Where
    the axis divides them, the rank's own ``n_kv_heads / m``; else (``m`` a
    multiple of them) the one KV head of its query heads, which ``m /
    n_kv_heads`` ranks share."""
    if tp is None:
        return 0, cfg.n_kv_heads
    if cfg.n_kv_heads % tp.size == 0:
        n = cfg.n_kv_heads // tp.size
        return tp.rank * n, n
    return tp.rank // (tp.size // cfg.n_kv_heads), 1


def embed(table: torch.Tensor, tokens: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    """The vocab-parallel lookup of ``tokens`` in ``table``, this rank's
    ``(V / m, d)`` rows: the rows of the tokens it holds, summed over the
    axis."""
    v = table.shape[0]
    idx = tokens - tp.rank * v
    inside = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, v - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)), tp)


def xent(logits: torch.Tensor, labels: torch.Tensor, tp: ModelShard,
         group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``transformer._xent`` on this rank's vocab columns ``logits (B, T, V
    / m)`` (float32): ``(mean nll over valid labels, valid count)``, the
    same on every rank of the axis; with the ``"data"`` axis's ``group`` the
    global batch's (``labels`` this rank's rows).  ``logz`` is ``max +
    log(sum exp(l - max))`` with the maximum and the sum taken over the
    whole vocab; within float32 reassociation of the one-process
    ``logsumexp``."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    v = logits.shape[-1]
    top = rules.all_reduce_max(torch.amax(logits.detach(), dim=-1), tp.group)
    sumexp = reduce_from_model(torch.sum(torch.exp(logits - top[..., None]), dim=-1), tp)
    logz = top + torch.log(sumexp)
    idx = safe - tp.rank * v
    inside = (idx >= 0) & (idx < v)
    mine = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, mine, torch.zeros_like(mine)), tp)
    nll = (logz - gold) * valid
    count = torch.sum(valid)
    if group is None:
        denom = torch.clamp(count, min=1)
        return torch.sum(nll) / denom, denom
    denom = torch.clamp(fsdp.global_sum(count, group), min=1)
    return fsdp.global_sum(torch.sum(nll) / denom, group), denom


def gather_logits(logits: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """This rank's vocab columns gathered whole (no autograd)."""
    if tp is None:
        return logits
    return rules.all_gather_dim(logits, logits.ndim - 1, tp.group, span="tp.gather")


def whole_kernel(linear, tp: ModelShard) -> torch.Tensor:
    """``linear``'s kernel whole along the dim the rules put on ``"model"``
    (gathered over the axis with ``fsdp.gather``: its gradient is
    reduce-scattered back), or as it is where they replicate it.  Inside a
    block, where the read of a sharded kernel (``linear.kernel``) is its
    ``"data"``-gathered shard."""
    info = shard_of(linear._parameters["kernel"])
    kernel = linear.kernel
    if info is None or info.model_dim is None:
        return kernel
    return fsdp.gather(kernel, info.model_dim, tp.group, spans=("tp.gather", "tp.reduce"))


def vocab_columns(linear, tp: ModelShard) -> torch.Tensor:
    """This rank's vocab columns ``(d, V / m)`` of the untied ``lm_head``:
    the kernel (``(d / m, V)`` as the rules store it) gathered whole along
    ``d``, then this rank's chunk of the vocab."""
    return local(whole_kernel(linear, tp), tp, dim=1)
