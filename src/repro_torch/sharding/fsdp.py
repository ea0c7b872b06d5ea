"""FSDP: the ``"data"`` axis of the spec rules' layout, and the placement
of both axes.

The reference trains under ``jax.jit(build_train_step(...))`` with the
parameters and both AdamW moments placed by ``rules.param_specs`` and the
batch by ``rules.batch_spec`` (``launch/dryrun.py``'s ``build_cell``);
GSPMD then inserts the all-gathers of the weights and the reductions of
their gradients.  This module is the explicit form of that layout on a
``("data", "model")`` mesh (the ``"pod"`` axis is ROADMAP.md item 9b.8;
the ``"model"`` axis's collectives inside the model are ``sharding/tp.py``'s,
for the families ``rules.check_mesh_family`` admits):

* ``shard_model(model, mesh)`` keeps in each parameter only this rank's
  contiguous chunk along the dim that ``param_specs`` gives to ``"data"``
  (``full.chunk(n, dim)[rank]``) and, with a ``"model"`` axis above 1,
  along the dim it gives to ``"model"``; a leaf whose spec names neither
  (norm scales, biases, ``conv``, routers, dims that do not divide) stays
  whole.  The parameter names stay the port's, so
  ``adamw.reference_ndim``, ``param_specs`` and the checkpoint keys read
  them as before.  Each parameter carries its ``rules.DataShard``
  (``shard_of``), the model its mesh (``mesh_of``), and with tensor
  parallelism every module with a ``tp`` attribute (the embedding, the
  attention, the FFN, the model) its ``rules.ModelShard``.
* ``gather(shard, dim, group)`` is an autograd Function: an all-gather
  along ``dim`` forward, a reduce-scatter (sum) of the gradient back to
  the shard backward, so ``torch.autograd.grad`` with respect to the
  shards returns shard gradients.
* ``gathered(*modules, skip=())`` reads every sharded weight of
  ``modules`` through ``gather`` along ``"data"`` (its ``"model"`` chunk
  stays this rank's) for the duration of a block: the models
  enter it inside the body that ``transformer._run_stack`` (and the
  hybrid group, the RWKV block, the encoder-decoder's blocks) checkpoints,
  so remat's recompute gathers again and no full weight outlives its
  block, the memory behaviour GSPMD gives the reference.  The gathered
  tensor shadows the parameter in its module's ``__dict__``: the model
  code reads ``self.kernel`` unchanged and ``named_parameters`` still
  yields the shard.  A weight ``holding`` a full copy (the step's
  ``gather_small_weights_once``) is read from that copy instead.
* The gradient of a leaf whole along ``"data"`` is each rank's share of
  the batch: ``reduce_grads`` all-reduces it (sum) over ``"data"``, else the
  ranks' copies drift apart.  Of a leaf the rules replicate over
  ``"model"`` there are two kinds: one read on replicated rows (the
  ``ln1``, ``ln2`` and ``ln_f`` scales, RWKV-6's ``ln_x`` and Mamba2's
  ``out_norm`` scales, whisper's layernorm biases, ``dec_pos``) has the
  same gradient on every rank of the axis, while one
  read on a rank's own heads or columns (``rules.per_head``: the qk-norm
  scales, the q/k/v biases, and every other replicated leaf of the RWKV-6
  mixes and of Mamba2) holds that rank's part, which ``reduce_grads`` sums over
  ``"model"``.  ``sum_of_squares`` counts each
  replicated leaf once in the global norm.

The collectives are ``rules``' (``all_gather_dim``, ``reduce_scatter_dim``,
``all_reduce_sum``), each following its group's backend.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.sharding import rules
from repro_torch.sharding.rules import (
    DataShard, PartitionSpec, axis_index, axis_sizes, check_mesh_family,
    constrain_gathered_weight, model_shard, param_specs, per_head, shard_of,
)


def _axis_dim(spec: PartitionSpec, axis: str) -> int | None:
    dims = [d for d, s in enumerate(spec) if s == axis or (isinstance(s, tuple) and axis in s)]
    return dims[0] if dims else None


def data_dim(spec: PartitionSpec) -> int | None:
    """The tensor dim that ``spec`` gives to ``"data"``, or None."""
    return _axis_dim(spec, "data")


def model_dim(spec: PartitionSpec) -> int | None:
    """The tensor dim that ``spec`` gives to ``"model"``, or None."""
    return _axis_dim(spec, "model")


def data_dims(shapes, mesh) -> dict[str, int | None]:
    """``{name: data dim or None}`` of ``param_specs(shapes, mesh)``
    (``mesh`` a ``DeviceMesh`` or a mapping of axis sizes)."""
    return {n: data_dim(s) for n, s in param_specs(shapes, mesh).items()}


def local_shard(full: torch.Tensor, dim: int | None, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous chunk of ``full`` along ``dim`` of
    ``size`` (a view; ``full`` itself for a replicated leaf)."""
    return full if dim is None else full.chunk(size, dim)[rank]


def check_family(cfg) -> None:
    """Refuse the ``moe`` family and an MTP head under a mesh: their
    ``load_balance``, ``router_z``, ``expert_load`` and capacity groups
    need statistics over the global batch, which come with expert
    parallelism (ROADMAP.md item 9b)."""
    if cfg.family == "moe" or getattr(cfg, "mtp_depth", 0):
        raise ValueError(f"{cfg.name}: the moe family and MTP train under a mesh only with "
                         "global router statistics and expert parallelism (ROADMAP.md item 9b)")


def mesh_of(model) -> Any:
    """The mesh ``shard_model`` placed ``model`` on, or None."""
    return getattr(model, "fsdp_mesh", None)


def data_group(model) -> Any:
    """The ``"data"`` axis's process group of a sharded model, or None."""
    mesh = mesh_of(model)
    return None if mesh is None else mesh.get_group("data")


@torch.no_grad()
def shard_model(model, mesh):
    """Place ``model`` (a ``Transformer`` or ``EncDec``) on ``mesh`` in
    place: each parameter keeps this rank's chunk along its rules' data
    dim and, with a ``"model"`` axis above 1, its model dim (a world of one
    keeps it whole), and carries its ``DataShard``.  Every rank calls it on
    the same full weights.  Raises ``ValueError`` for a mesh the model's
    family does not run on (``rules.check_mesh_family``), for the ``moe``
    family and MTP, and for parameters not on the mesh's device type."""
    check_mesh_family(mesh, model.cfg)
    check_family(model.cfg)
    if mesh_of(model) is not None:
        raise ValueError("the model is already sharded")
    params = dict(model.named_parameters())
    wrong = sorted({p.device.type for p in params.values()} - {mesh.device_type})
    if wrong:
        raise ValueError(f"the mesh carries {mesh.device_type} tensors; the model's parameters "
                         f"lie on {wrong}")
    n, rank = axis_sizes(mesh)["data"], axis_index(mesh, "data")
    group, tp = mesh.get_group("data"), model_shard(mesh)
    for name, spec in param_specs(params, mesh).items():
        p, dim = params[name], data_dim(spec)
        mdim = None if tp is None else model_dim(spec)
        local = p.data
        if mdim is not None:
            local = local_shard(local, mdim, tp.size, tp.rank)
        if dim is not None and n > 1:
            local = local_shard(local, dim, n, rank)
        if local is not p.data:
            p.data = local.clone()
        p._fsdp = DataShard(dim=dim, size=n, rank=rank, group=group, model_dim=mdim, model=tp,
                            per_head=tp is not None and mdim is None and per_head(name))
    if tp is not None:
        for module in model.modules():
            if hasattr(type(module), "tp"):
                module.tp = tp
    model.fsdp_mesh = mesh
    return model


def shardings(model, opt_state=None):
    """The placements of a sharded model's parameters (``{name:
    DataShard}``), or of ``(params, opt_state)``: the moments placed as
    their parameters, the step replicated (the reference's ``opt_sh``).
    For ``Checkpointer.save`` / ``restore(shardings=)``."""
    if mesh_of(model) is None:
        raise ValueError("the model is not sharded (shard_model)")
    params = {n: shard_of(p) for n, p in model.named_parameters()}
    if opt_state is None:
        return params
    any_leaf = next(iter(params.values()))
    step = DataShard(dim=None, size=any_leaf.size, rank=any_leaf.rank, group=any_leaf.group,
                     model=any_leaf.model)
    return params, type(opt_state)(step=step, m=params, v=params)


# ------------------------------------------------------------- collectives


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, spans):
        ctx.dim, ctx.group, ctx.span = dim, group, spans[1]
        return rules.all_gather_dim(shard, dim, group, span=spans[0])

    @staticmethod
    def backward(ctx, grad):
        return rules.reduce_scatter_dim(grad, ctx.dim, ctx.group, span=ctx.span), None, None, None


def gather(shard: torch.Tensor, dim: int, group,
           spans: tuple[str, str] = ("fsdp.gather", "fsdp.reduce")) -> torch.Tensor:
    """The full leaf of ``shard``: an all-gather along ``dim`` over
    ``group``; its gradient is reduce-scattered (summed) back to the
    shard.  ``spans`` names the two collectives' ``core.profiling``
    spans."""
    return _Gather.apply(shard, dim, group, spans)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of each rank's ``x`` (a loss term of its
    rows, or a count; the same bits on every rank).  Its gradient with
    respect to this rank's ``x`` is one, so the backward pass carries each
    rank's share of the global loss into its own graph; the shards'
    reduce-scatter and ``reduce_grads`` sum the shares."""
    return _GlobalSum.apply(x, group)


def sum_of_squares(tree: dict, params: dict, slices) -> torch.Tensor:
    """The float32 sum of squares of every leaf of ``tree`` (gradients by
    the names of ``params``), each leaf summed over ``slices(leaf)`` in the
    leaves' order.  Of a sharded model's shards, the global gradient's:
    every rank sums its shards, and a leaf whole along an axis only on
    that axis's rank 0 (``reduce_grads`` left the same gradient on every
    rank of it: counted once); the partial sums are all-reduced over
    ``"data"``, then over ``"model"``.  A world of one sums exactly the
    one-process terms in their order; past one rank the ranks' partial
    sums reassociate it (float32 ulps), with the same bits on every
    rank."""
    terms = lambda names: (torch.sum(torch.square(tree[n][s].to(torch.float32)))
                           for n in names for s in slices(tree[n]))
    info = shard_of(next(iter(params.values())))
    if info is None:
        return sum(terms(tree))
    m_rank = 0 if info.model is None else info.model.rank
    mine = [n for n in tree
            if (info.rank == 0 or shard_of(params[n]).dim is not None)
            and (m_rank == 0 or shard_of(params[n]).model_dim is not None)]
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(tree.values())).device)
    total = global_sum(sum(terms(mine), zero), info.group)
    return total if info.model is None else global_sum(total, info.model.group)


# --------------------------------------------------------------- the reads


def _owners(modules, skip):
    """Every module under ``modules``, depth first, not entering those of
    ``skip``."""
    stop = {id(m) for m in skip if m is not None}
    todo = [m for m in reversed(modules) if m is not None]
    while todo:
        m = todo.pop()
        if id(m) in stop:
            continue
        yield m
        todo.extend(c for c in reversed(list(m._modules.values())) if c is not None)


@contextlib.contextmanager
def gathered(*modules, skip=()):
    """Within the block, each sharded parameter of ``modules`` (not those
    under the modules of ``skip``) reads as its full leaf: ``gather`` of
    its shard, or its held copy.  A no-op for a model that is not
    sharded."""
    installed = []
    try:
        for owner in _owners(modules, skip):
            for name, p in owner._parameters.items():
                info = None if p is None else shard_of(p)
                if info is None or info.dim is None:
                    continue
                full = info.held if info.held is not None else gather(p, info.dim, info.group)
                owner.__dict__[name] = full
                installed.append((owner, name))
        yield
    finally:
        for owner, name in installed:
            owner.__dict__.pop(name, None)


def gather_once(params: dict, mesh) -> dict:
    """``{name: full leaf}`` (no autograd history, requiring its own
    gradient) of every sharded leaf that is not a routed expert's: the
    reference's ``gather_small_weights_once``, through
    ``rules.constrain_gathered_weight``.  A sharded leaf has rank >= 2 (the
    rules replicate vectors)."""
    out = {}
    for name, p in params.items():
        info = shard_of(p)
        if info is not None and info.dim is not None and "experts" not in name.split("."):
            out[name] = constrain_gathered_weight(name, p, mesh).requires_grad_()
    return out


@contextlib.contextmanager
def holding(params: dict, held: dict):
    """``gathered`` reads the full leaves ``held`` (from ``gather_once``)
    in place of gathering their shards, within the block."""
    try:
        for name, full in held.items():
            shard_of(params[name]).held = full
        yield
    finally:
        for name in held:
            shard_of(params[name]).held = None


def reduce_grads(grads: dict, params: dict, held: dict) -> dict:
    """The global gradient of each shard and replicated leaf: the full
    gradients of ``held`` leaves reduce-scattered to their shards (once a
    step), the leaves whole along ``"data"`` all-reduced (sum) over it, and
    the ``per_head`` leaves then over ``"model"``, one collective a dtype
    each.  The shards' own gradients were reduce-scattered by ``gather``'s
    backward.  Every rank calls it with the same names in the same
    order."""
    out = dict(grads)
    for name in held:
        info = shard_of(params[name])
        out[name] = rules.reduce_scatter_dim(grads[name], info.dim, info.group)
    repl = [n for n, p in params.items() if shard_of(p).dim is None]
    if repl:
        group = shard_of(params[repl[0]]).group
        for n, g in zip(repl, rules.all_reduce_sum([out[n] for n in repl], group)):
            out[n] = g
    heads = [n for n, p in params.items() if shard_of(p).per_head]
    if heads:
        group = shard_of(params[heads[0]]).model.group
        for n, g in zip(heads, rules.all_reduce_sum([out[n] for n in heads], group,
                                                    span="tp.reduce")):
            out[n] = g
    return out
