"""Sharding rules and the process mesh.

Port of ``repro.sharding.rules`` on ``torch.distributed``.

* **The mesh.**  ``make_mesh`` builds a ``torch.distributed.DeviceMesh``
  with named axes over an initialised process group (``launch.mesh.
  init_world`` makes one with an explicit backend); ``region_mesh`` the
  ``(campus, data)`` mesh of the sharded region engine.  Each rank is one
  process; its coordinate on an axis (``axis_index``) picks its campus or
  its block of racks, and the axis's process group (``mesh.get_group``)
  carries the gathers (``all_gather_tree``).
* **Rack sharding.**  ``rack_block`` is this rank's contiguous block
  ``[lo, hi)`` of a campus's racks along ``RACK_AXIS``, ``shard_racks`` the
  block of a ``(T, R)`` trace.  The rack count must divide the axis, as
  GSPMD's even split needs.
* **The spec rules** (MaxText-style logical roles): leaf paths of a
  parameter tree map to roles, roles to mesh axes.  FSDP + TP for 2-D
  kernels ((in -> "data", out -> "model") for up-projections, the reverse
  for down/output projections), experts' leading axis on "model",
  embeddings vocab -> "model" and d_model -> "data", vectors replicated;
  a dim that does not divide its axis falls back to unsharded.  They are
  pure functions of ``(path, shape)`` and the mesh's axis sizes, so
  ``mesh`` may also be a mapping ``{axis name: size}``: the rules hold at
  production shape (16 x 16, 2 x 16 x 16) without 256 ranks.  They return
  the port's ``PartitionSpec`` (a tuple of axis names, ``None`` or a tuple
  of names per dim), and ``placements`` turns one into DTensor
  ``Shard`` / ``Replicate`` placements.

* **FSDP and tensor-parallel training and serving** (``sharding/fsdp.py``,
  ``sharding/tp.py``) place a model by these specs on a ``("data",
  "model")`` mesh (``check_fsdp_mesh``; the ``"pod"`` axis is ROADMAP.md
  item 9b.8).  ``check_mesh_family`` admits a ``"model"`` axis above 1 for
  every family but ``moe``, where it divides the heads, ``d_ff`` and the
  vocab.  The reference's GSPMD
  constraint helpers become explicit operations there: ``shard_batch``
  takes this rank's rows by ``batch_spec`` (the batch's ``in_shardings``
  and ``constrain_activations``, which keep activations batch-sharded and
  replicated over ``"model"``), and ``constrain_gathered_weight`` gathers a
  shard whole along ``"data"`` and keeps its ``"model"`` chunk (the step's
  ``gather_small_weights_once``).  ``maybe_constrain`` and
  ``constrain_to_mesh`` only annotate GSPMD's propagation and have no
  operation to port in an explicit layout; ``shard_map_compat`` covers jax
  API drift and has no counterpart either.  A sharded parameter carries
  its ``DataShard`` (``shard_of``): where it lies on both axes, which the
  step, the optimizer's norm and the checkpoint's reshard-on-restore read.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Any

import torch

from repro_torch.core import profiling
from repro_torch.utils.trees import tree_leaves, tree_map


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over several axes, major first) or ``None`` (unsharded).
    ``PartitionSpec()`` replicates.  Equal to the plain tuple of its
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# The mesh axes of the conditioning engines: a grid region's campuses (one
# campus a shard, ``region_mesh``) and a campus's racks, the data-parallel
# axis of the spec rules (ranks along it split a campus's racks, or repeat
# its campus in a region).
CAMPUS_AXIS = "campus"
RACK_AXIS = "data"


# ---------------------------------------------------------------- the mesh


def check_mesh(mesh, device_type: str | None = None):
    """``mesh`` if it is a ``DeviceMesh`` with named axes (else TypeError)
    whose device type is ``device_type`` (else ValueError), when given."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(
            "mesh must be a torch.distributed DeviceMesh with named axes "
            f"(sharding.make_mesh, sharding.region_mesh), got {type(mesh).__name__}")
    if device_type is not None and mesh.device_type != device_type:
        raise ValueError(f"the mesh carries {mesh.device_type} tensors; the config runs on "
                         f"{device_type}")
    return mesh


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    check_mesh(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(check_mesh(mesh).get_local_rank(axis))


def make_mesh(axis_shapes, axis_names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    initialised world, ranks in row-major order.  Every rank calls it with
    the same arguments.  The world's backend must carry ``device_type``
    tensors: nccl ``cuda``, gloo ``cpu`` and ``cuda`` (ranks that share a
    card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = tuple(int(n) for n in axis_shapes), tuple(str(a) for a in axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not name the {len(shape)} dims of {shape}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch.mesh.init_world)")
    world, backend = dist.get_world_size(), dist.get_backend()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh holds {math.prod(shape)} ranks; the world has {world}")
    if device_type == "cpu" and backend == "nccl":
        raise ValueError("an nccl world carries cuda tensors only; a cpu mesh needs gloo")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def region_mesh(n_campuses: int, *, device_type: str = "cuda"):
    """The 2-D ``(CAMPUS_AXIS, RACK_AXIS)`` mesh of the sharded region
    engine over the world: exactly ``n_campuses`` campus shards (one campus
    a shard keeps the POI sum in the sequential engine's left-to-right
    order), every other rank folded into the trailing rack axis."""
    import torch.distributed as dist

    if n_campuses <= 0:
        raise ValueError(f"n_campuses must be positive, got {n_campuses}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_campuses:
        raise ValueError(
            f"{world} ranks do not tile {n_campuses} campuses; run a world whose size is a "
            "campus multiple")
    return make_mesh((n_campuses, world // n_campuses), (CAMPUS_AXIS, RACK_AXIS),
                     device_type=device_type)


def rack_block(n_racks: int, mesh) -> tuple[int, int]:
    """This rank's contiguous block ``[lo, hi)`` of ``n_racks`` racks split
    evenly along ``RACK_AXIS``."""
    axis = RACK_AXIS
    size = axis_sizes(mesh).get(axis)
    if size is None:
        raise ValueError(f"mesh axes {tuple(axis_sizes(mesh))} lack the rack axis {axis!r}")
    if n_racks % size:
        raise ValueError(f"{n_racks} racks do not split evenly over the {size} ranks of mesh "
                         f"axis {axis!r}")
    per = n_racks // size
    lo = axis_index(mesh, axis) * per
    return lo, lo + per


def shard_racks(traces: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the trailing rack axis of a ``(T, R)`` trace,
    contiguous (a rank runs its block as a fleet of its own)."""
    lo, hi = rack_block(traces.shape[-1], mesh)
    return traces[..., lo:hi].contiguous()


def check_fsdp_mesh(mesh):
    """``mesh`` if a model trains or serves sharded on it: a ``"data"``
    axis, a ``"model"`` axis if any, nothing else.  The ``"pod"`` axis
    raises ``ValueError``: it is ROADMAP.md item 9b.8.  Which families run
    a ``"model"`` axis above 1 is ``check_mesh_family``'s."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"mesh axes {tuple(sizes)} lack the data axis 'data'")
    other = set(sizes) - {"data", "model"}
    if other:
        raise ValueError(f"mesh axes {sorted(other)}: the port runs on ('data', 'model') only; "
                         "the 'pod' axis is ROADMAP.md item 9b.8")
    return mesh


def model_splits(cfg) -> list[tuple[str, int]]:
    """``[(what, count)]``: what a ``"model"`` axis must divide for
    ``cfg``'s family to run on it: the heads a rank's attention or
    recurrence runs on (RWKV-6's ``d_model / head_dim``, Mamba2's ``d_inner
    / head_dim`` and the Zamba2 shared block's heads, the query heads of the
    others), ``d_ff`` and the padded vocab; for ``audio`` also the KV heads
    (its cross-attention reads them on each rank's heads)."""
    if cfg.family == "ssm":
        heads = [("RWKV heads", cfg.d_model // cfg.rwkv.head_dim)]
    elif cfg.family == "hybrid":
        heads = [("Mamba2 heads", cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim),
                 ("shared-block heads", cfg.hybrid.shared_block_heads)]
    elif cfg.family == "audio":
        heads = [("query heads", cfg.n_heads), ("KV heads", cfg.n_kv_heads)]
    else:
        heads = [("query heads", cfg.n_heads)]
    return heads + [("d_ff", cfg.d_ff), ("padded vocab", cfg.padded_vocab)]


def check_mesh_family(mesh, cfg):
    """``mesh`` if ``cfg``'s model runs on it (``check_fsdp_mesh``): a
    ``"model"`` axis of ``m`` > 1 is tensor parallelism, which the
    ``dense``, ``vlm``, ``ssm``, ``hybrid`` and ``audio`` families run when
    ``m`` divides each of ``model_splits(cfg)`` and, for ``dense`` and
    ``vlm``, the KV heads divide ``m`` or ``m`` them.  Anything else raises
    ``ValueError`` naming its ROADMAP.md item: the ``moe`` family 9b.9 /
    9b.10, a split that ``m`` does not divide 9b.7c."""
    check_fsdp_mesh(mesh)
    m = axis_sizes(mesh).get("model", 1)
    if m == 1:
        return mesh
    if cfg.family == "moe":
        raise ValueError(f"{cfg.name}: the moe family under a 'model' axis of {m} is expert "
                         "parallelism, ROADMAP.md items 9b.9 and 9b.10")
    for what, n in model_splits(cfg):
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} do not split over a 'model' axis of {m} "
                             "(ROADMAP.md item 9b.7c)")
    if cfg.family in ("dense", "vlm") and cfg.n_kv_heads % m and m % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: {cfg.n_kv_heads} KV heads neither divide nor are "
                         f"divided by a 'model' axis of {m} (ROADMAP.md item 9b.7c)")
    return mesh


def shard_batch(batch, mesh) -> dict:
    """This rank's rows of every ``(B, ...)`` tensor of ``batch`` (a dict)
    by ``batch_spec``: the explicit form of the batch's ``in_shardings``
    and of ``constrain_activations`` (each rank computes its own rows).
    A batch that does not split evenly over the data axis raises
    ``ValueError``: the reference would replicate it, and replicated rows
    would count once a rank in the global loss."""
    check_fsdp_mesh(mesh)
    n, rank = axis_sizes(mesh)["data"], axis_index(mesh, "data")
    out = {}
    for k, v in batch.items():
        if batch_spec(mesh, v.shape[0]) != P("data"):
            raise ValueError(f"a batch of {v.shape[0]} rows ({k!r}) does not split over the {n} "
                             "ranks of the data axis")
        out[k] = v.chunk(n, 0)[rank]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShard:
    """This rank's place on the mesh's ``"model"`` axis (size > 1): the
    axis's ``size``, this rank's ``rank`` on it and its process ``group``.
    ``fsdp.shard_model`` sets it as ``.tp`` on the modules that run on
    their local heads, columns, rows or vocab."""

    size: int
    rank: int
    group: Any


def model_group(mesh) -> Any:
    """The ``"model"`` axis's process group of ``mesh``, or None (no such
    axis)."""
    return check_mesh(mesh).get_group("model") if "model" in axis_sizes(mesh) else None


def model_shard(mesh) -> ModelShard | None:
    """``mesh``'s ``ModelShard``, or None where its ``"model"`` axis is 1 or
    absent."""
    m = axis_sizes(mesh).get("model", 1)
    return None if m == 1 else ModelShard(size=m, rank=axis_index(mesh, "model"),
                                          group=model_group(mesh))


@dataclasses.dataclass(eq=False)
class DataShard:
    """Where a parameter of a sharded model lies on the mesh (``fsdp.
    shard_model`` sets it as ``p._fsdp``): ``dim`` the tensor dim split
    over the ``"data"`` axis's ``size`` ranks (None: whole along it),
    ``rank`` this rank's coordinate on it, ``group`` its process group;
    ``model_dim`` the dim split over the ``"model"`` axis ``model`` (None:
    replicated over it, or no tensor parallelism).  ``per_head`` marks a
    model-replicated leaf that each rank reads on its own heads or columns
    only (``rules.per_head``: the ``q_norm`` / ``k_norm`` scales, the ``wq``
    / ``wk`` / ``wv`` biases, the RWKV-6 mixes' and Mamba2's replicated
    leaves): its gradient is summed over ``"model"``.  ``held`` is a gathered copy that
    ``fsdp.gathered`` reads instead of gathering (the step's
    ``gather_small_weights_once``)."""

    dim: int | None
    size: int
    rank: int
    group: Any
    held: torch.Tensor | None = None
    model_dim: int | None = None
    model: ModelShard | None = None
    per_head: bool = False

    @property
    def split(self) -> bool:
        """Whether the leaf is split over either axis."""
        return self.dim is not None or self.model_dim is not None


def shard_of(p: torch.Tensor) -> DataShard | None:
    """The ``DataShard`` of a parameter of a sharded model, else None."""
    return getattr(p, "_fsdp", None)


def constrain_gathered_weight(path, leaf: torch.Tensor, mesh) -> torch.Tensor:
    """``leaf``, this rank's shard of the parameter at ``path`` of a model
    that ``fsdp.shard_model`` placed on ``mesh``, gathered whole along
    ``"data"`` with its ``"model"`` placement kept (the rank's chunk along
    its model dim): "gather once, keep TP".  No autograd; a leaf whole
    along ``"data"`` comes back as it is (detached)."""
    check_fsdp_mesh(mesh)
    info = shard_of(leaf)
    if info is None:
        name = path if isinstance(path, str) else ".".join(path)
        raise ValueError(f"{name}: not a parameter of a sharded model (fsdp.shard_model)")
    if info.dim is None:
        return leaf.detach()
    return all_gather_dim(leaf, info.dim, info.group)


# ------------------------------------------------------------- collectives


def nccl(group) -> bool:
    """Whether ``group``'s backend is nccl (else gloo)."""
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


def _alone(group) -> bool:
    """Whether ``group`` holds this rank only (a mesh axis of size 1): its
    collectives are copies, made on the device (gloo would carry a CUDA
    tensor through the host and back)."""
    import torch.distributed as dist

    return dist.get_world_size(group) == 1


def all_gather_dim(x: torch.Tensor, dim: int, group, span: str = "fsdp.gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    autograd), timed as ``span``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    x = x.detach().contiguous()
    with profiling.span(span) as sync:
        if _alone(group):
            out = x.clone()
        elif nccl(group):
            out = x.new_empty((n,) + tuple(x.shape))
            dist.all_gather_into_tensor(out, x, group=group)
            shape = list(x.shape)
            shape[dim] *= n
            out = out.movedim(0, dim).reshape(shape)
        else:  # gloo: the list form (its tensor form does not take CUDA tensors)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            out = torch.cat(parts, dim=dim)
        sync(out)
    return out


def reduce_scatter_dim(g: torch.Tensor, dim: int, group, span: str = "fsdp.reduce") -> torch.Tensor:
    """The sum over the ranks of ``g``, this rank's chunk along ``dim``
    (no autograd), timed as ``span``."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    with profiling.span(span) as sync:
        if _alone(group):
            out = g.clone(memory_format=torch.contiguous_format)
        elif nccl(group):
            src = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
            out = g.new_empty(src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=group)
        else:  # gloo has no reduce-scatter of CUDA tensors: an all-reduce, then the slice
            buf = torch.empty_like(g, memory_format=torch.contiguous_format).copy_(g)
            dist.all_reduce(buf, group=group)
            out = buf.chunk(n, dim)[rank].contiguous()
        sync(out)
    return out


def all_reduce_sum(tensors: list, group, span: str = "fsdp.reduce") -> list:
    """Each tensor summed over the ranks (new tensors), one all-reduce a
    dtype over their flattened concatenation, timed as ``span``."""
    import torch.distributed as dist

    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    with profiling.span(span) as sync:
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            if not _alone(group):
                dist.all_reduce(flat, group=group)
            for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
            sync(flat)
    return out


def all_reduce_max(x: torch.Tensor, group, span: str = "tp.reduce") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (a new tensor, no
    autograd), timed as ``span``."""
    import torch.distributed as dist

    out = x.detach().clone(memory_format=torch.contiguous_format)
    with profiling.span(span) as sync:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        sync(out)
    return out


def all_gather_tree(tree, mesh, axis: str) -> list:
    """Every rank's ``tree`` along ``axis``, in axis order: one structure
    (this rank's), each rank's leaves with that rank's shapes.  The leaves'
    count, ranks and dtypes must agree across the axis; their shapes may
    differ.  Two collectives: the shapes, then every leaf's bytes in one
    buffer (copies, so the bits are kept), on the mesh's device type."""
    import torch.distributed as dist

    mesh = check_mesh(mesh)
    group, n = mesh.get_group(axis), axis_sizes(mesh)[axis]
    leaves = tree_leaves(tree)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    dims = torch.tensor([d for t in leaves for d in t.shape] or [0], dtype=torch.int64,
                        device=dev)
    all_dims = [torch.empty_like(dims) for _ in range(n)]
    dist.all_gather(all_dims, dims, group=group)
    pad8 = lambda b: -(-b // 8) * 8

    def layout(flat):
        it, out = iter(flat.tolist()), []
        for t in leaves:
            shape = tuple(next(it) for _ in range(t.ndim))
            out.append((shape, pad8(math.prod(shape) * t.element_size())))
        return out

    layouts = [layout(d) for d in all_dims]
    width = max(sum(b for _, b in lay) for lay in layouts) or 8
    buf = torch.zeros(width, dtype=torch.uint8, device=dev)
    off = 0
    for t, (_, nb) in zip(leaves, layout(dims)):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        buf[off:off + raw.numel()] = raw.to(dev)
        off += nb
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf, group=group)
    out = []
    for b, lay in zip(bufs, layouts):
        off, got = 0, []
        for t, (shape, nb) in zip(leaves, lay):
            nbytes = math.prod(shape) * t.element_size()
            got.append(b[off:off + nbytes].view(t.dtype).reshape(shape).to(t.device).clone())
            off += nb
        it = iter(got)
        out.append(tree_map(lambda _: next(it), tree))
    return out


# ------------------------------------------------------------ param rules


# role -> (axis assignment per tensor dim, counted from the LAST dim)
# (in_axis, out_axis) for 2D kernels.
_UP_KERNELS = (
    "wq", "wk", "wv", "wg", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a",
    "wk_b", "wv_b", "w_in", "wr", "mix_lora_a", "a",
)
_DOWN_KERNELS = ("wo", "w_down", "w_out", "w_concat", "b", "wv_cm")
_REPLICATE = ("scale", "bias", "a_log", "dt_bias", "d_skip", "decay_base",
              "mu_base", "mu_k", "mu_r", "u_bonus", "_sub_heads", "dec_pos")


# The leaves above that a tensor-parallel rank reads on its own heads only:
# the query/key/value biases (and a key/value kernel whose output dim does
# not split over "model"), and the qk-norm scales; and every leaf of the
# RWKV-6 mixes and of Mamba2 that the rules replicate (the token-shift
# mixes, the LoRAs, ``decay_base``, ``u_bonus``, the conv kernel, ``a_log``,
# ``dt_bias``, ``d_skip``, and ``mix_lora_a`` / ``w_in`` where "model" does
# not divide their output dim), all read after the block norm's
# ``tp.copy_to_model`` for this rank's heads or columns.  Their gradient on
# a rank is its part: it is summed over "model" (``fsdp.reduce_grads``).
# RWKV-6's ``ln_x`` and Mamba2's ``out_norm`` run on whole rows forward and
# backward (``tp.norm_columns``): their scales are read on replicated rows.
_PER_HEAD = re.compile(r"(^|\.)attn\.((wq|wk|wv)\.(bias|kernel)|(q_norm|k_norm)\.scale)$"
                       r"|(^|\.)(time|channel|mamba)\.(?!ln_x\.|out_norm\.)")


def per_head(name: str) -> bool:
    """Whether parameter ``name`` (a dotted path), where the rules
    replicate it over ``"model"``, is read on each rank's own heads or
    columns."""
    return bool(_PER_HEAD.search(name))


def _role_of(path: tuple[str, ...], ndim: int) -> str:
    names = list(path)
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "embedding" or (leaf == "kernel" and parent == "lm_head"):
        return "embed"
    if leaf in _REPLICATE or parent in ("conv",):
        return "replicate"
    if parent == "router":
        return "replicate"
    if "experts" in names:
        return "expert"
    if leaf == "kernel":
        if parent in _UP_KERNELS:
            return "up"
        if parent in _DOWN_KERNELS:
            return "down"
        return "replicate"
    if parent in ("mix_lora_b", "decay_lora"):
        return "replicate"
    if leaf in _UP_KERNELS or leaf in _DOWN_KERNELS:
        # raw arrays named like kernels (lora a/b mats)
        return "up" if leaf in _UP_KERNELS else "down"
    return "replicate"


def _fits(dim: int, mesh, axis: str | None) -> bool:
    if axis is None:
        return True
    return dim % axis_sizes(mesh)[axis] == 0


def param_spec(
    path: tuple[str, ...],
    shape: tuple[int, ...],
    mesh,
    *,
    notes: list | None = None,
) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (``path`` its names, e.g.
    ``("blocks", "attn", "wq", "kernel")``)."""
    ndim = len(shape)
    role = _role_of(path, ndim)
    none_prefix = (None,) * (ndim - 2)

    def note(msg):
        if notes is not None:
            notes.append(f"{'/'.join(path)}: {msg}")

    if role == "replicate" or ndim == 0:
        return P()
    if role == "embed":
        # (vocab, d) -> vocab on model (always padded to divide), d on data
        v_ax = "model" if _fits(shape[-2], mesh, "model") else None
        d_ax = "data" if _fits(shape[-1], mesh, "data") else None
        if v_ax is None:
            note("vocab dim not divisible; replicated")
        return P(*none_prefix, v_ax, d_ax)
    if role == "expert":
        # (..., E, in, out): E -> model (EP), in -> data (FSDP).
        if ndim < 3:
            return P()
        e_ax = "model" if _fits(shape[-3], mesh, "model") else None
        i_ax = "data" if _fits(shape[-2], mesh, "data") else None
        if e_ax is None:
            note("expert dim not divisible; replicated")
        return P(*(None,) * (ndim - 3), e_ax, i_ax, None)
    if ndim == 1:
        return P()
    if role == "up":
        i_ax = "data" if _fits(shape[-2], mesh, "data") else None
        o_ax = "model" if _fits(shape[-1], mesh, "model") else None
        if o_ax is None:
            note("up out-dim not divisible; unsharded")
        return P(*none_prefix, i_ax, o_ax)
    # down
    i_ax = "model" if _fits(shape[-2], mesh, "model") else None
    o_ax = "data" if _fits(shape[-1], mesh, "data") else None
    return P(*none_prefix, i_ax, o_ax)


def _shape_of(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, a shape's, or the shape of a ``(shape,
    dtype)`` pair (``convert.lm_tree_shapes``)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and leaf and isinstance(leaf[0], (tuple, torch.Size)):
        return tuple(leaf[0])
    return tuple(leaf)


def param_specs(shapes: Mapping, mesh, *, notes: list | None = None) -> dict:
    """``{dotted path: PartitionSpec}`` for ``{dotted path: leaf}``, a leaf
    a tensor, a shape or a ``(shape, dtype)`` pair (the layout of
    ``convert.lm_tree_shapes`` and ``named_parameters``)."""
    return {path: param_spec(tuple(path.split(".")), _shape_of(leaf), mesh, notes=notes)
            for path, leaf in shapes.items()}


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh axis in
    the mesh's order: ``Shard(d)`` on each axis that tensor dim ``d`` names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ------------------------------------------------------------ activations


def batch_spec(mesh, batch: int, *, pod: bool = False) -> PartitionSpec:
    """Sharding for (B, T, ...) activations/token batches.

    Batch shards over ("pod","data") when it divides; a batch of 1
    (long-context decode) leaves batch unsharded and relies on
    head/sequence sharding inside the model.
    """
    sizes = axis_sizes(mesh)
    axes = ("pod", "data") if pod and "pod" in sizes else ("data",)
    total = math.prod(sizes[a] for a in axes)
    if batch % total == 0:
        return P(axes if len(axes) > 1 else axes[0])
    if batch % sizes["data"] == 0:
        return P("data")
    return P(None)


def decode_state_specs(state: Any, mesh) -> Any:
    """PartitionSpecs for a decode state (KV caches / SSM states), the
    state's structure with a spec in place of each leaf.

    Leaf-name driven (the name is the NamedTuple field or dict key): KV
    ``k``/``v`` (stacked (L, B, S, H, hd) or MLA (L, B, S, R)) shard batch
    on "data" and heads on "model" when they divide, else the sequence dim;
    SSM/RWKV states shard heads/channels on "model"; ``length`` and other
    leaves of rank <= 1 (and non-tensor leaves) replicate.  Any
    non-divisible dim falls back to unsharded.
    """
    sizes = axis_sizes(mesh)
    dp, tp = sizes["data"], sizes["model"]

    def fit(dim, ax, n):
        return ax if dim % n == 0 and dim >= n else None

    def spec(name: str, leaf) -> PartitionSpec:
        if not isinstance(leaf, torch.Tensor):
            return P()
        shp = tuple(leaf.shape)
        nd = len(shp)
        if name == "length" or nd <= 1:
            return P()
        if name in ("k", "v", "cross_k", "cross_v"):
            if nd == 5:  # (L, B, S, H, hd)
                b_ax = fit(shp[1], "data", dp)
                h_ax = fit(shp[3], "model", tp)
                s_ax = None if h_ax else fit(shp[2], "model", tp)
                return P(None, b_ax, s_ax, h_ax, None)
            if nd == 4:  # MLA (L, B, S, R)
                return P(None, fit(shp[1], "data", dp), fit(shp[2], "model", tp), None)
            return P()
        if name == "wkv":  # (L, B, H, hd, hd)
            return P(None, fit(shp[1], "data", dp), fit(shp[2], "model", tp), None, None)
        if name == "ssm":  # (G, K, B, H, N, Ph)
            return P(None, None, fit(shp[2], "data", dp), fit(shp[3], "model", tp), None, None)
        if name == "conv":  # (G, K, B, W, CH)
            return P(None, None, fit(shp[2], "data", dp), None, fit(shp[4], "model", tp))
        if name in ("shift_tm", "shift_cm"):  # (L, B, 1, D)
            return P(None, fit(shp[1], "data", dp), None, fit(shp[3], "model", tp))
        # default: try batch-ish second dim
        return P(None, fit(shp[1], "data", dp), *([None] * (nd - 2)))

    def visit(name: str, x):
        if isinstance(x, Mapping):
            return type(x)((k, visit(str(k), v)) for k, v in x.items())
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(visit(f, v) for f, v in zip(x._fields, x)))
        if isinstance(x, (tuple, list)):
            return type(x)(visit(name, v) for v in x)
        return spec(name, x)

    return visit("", state)


def cache_spec(mesh, batch: int, kv_heads_or_none: int | None) -> PartitionSpec:
    """KV cache (B, S, H, D) or MLA (B, S, R): shard batch on data; heads on
    model when divisible, else the sequence dim."""
    sizes = axis_sizes(mesh)
    b_ax = "data" if batch % sizes["data"] == 0 else None
    if kv_heads_or_none is not None and kv_heads_or_none % sizes["model"] == 0:
        return P(b_ax, None, "model", None)
    if kv_heads_or_none is None:
        return P(b_ax, "model", None)
    return P(b_ax, "model", None, None)
