"""Train-step builder: loss + grad + AdamW, with microbatch gradient
accumulation (counterpart of ``repro.train.step``).

``build_train_step(cfg, opt_cfg, microbatches=...)`` returns

    step(model, opt_state, batch, step_idx) -> (model, opt_state, metrics)

which updates the model's parameters in place (``adamw_update``) and
returns the new optimizer state and the metrics of the reference:
``lm_loss``, ``tokens`` and ``total_loss`` of the last microbatch (for the
``moe`` family also ``load_balance``, ``router_z``, ``expert_load``,
``dropped_fraction`` and, with an MTP head, ``mtp_loss``), ``grad_norm``,
``lr`` and ``loss`` (the mean over microbatches).  Microbatching splits
the batch on the leading axis and accumulates the gradients in float32
buffers, as the reference's scan does (``.grad`` would accumulate in the
parameters' bf16).  A parameter that no path of the loss reaches (the
``sigmoid_bias`` router's bias, which enters only the top-k selection)
gets a zero gradient, as ``jax.value_and_grad`` gives it: it counts in
``grad_norm`` and AdamW still decays it.  After the update the
``sigmoid_bias`` router's bias of every MoE layer is nudged against the
skew of ``expert_load`` (the layer-averaged load of the last microbatch),
as the reference's aux-loss-free balancing does.

The ``ssm`` family (RWKV-6) trains with the plain cross entropy and, under
``remat="block"``, one checkpoint a block, its recurrence on the plain
forms the reference trains through (``ops.rwkv6_scan``); the ``hybrid``
family trains with the plain cross entropy
and, under ``remat="block"``, one checkpoint a group; the ``audio`` family
(``encdec.lm_loss``) reads the encoder frames from ``batch["frames"]``,
with one checkpoint an encoder and a decoder block.

A model that ``sharding.fsdp.shard_model`` placed on a mesh (it carries
the mesh; the step takes no other argument) trains as the reference's
jitted step under the rules' shardings, the global batch's step: every
rank is given the global batch and keeps its rows of each microbatch
(``rules.shard_batch``; microbatch i is the global batch's slice i, as
the reference's, so each microbatch's loss divides by the valid labels of
the same rows), the loss and metrics are the global ones on every rank
(``transformer._xent``), the shards' gradients come back reduce-scattered
from ``fsdp.gather``'s backward and the replicated leaves' are all-reduced
(``fsdp.reduce_grads``) before AdamW, whose norm sums over the ranks
(``adamw.global_norm``).  On a ``"model"`` axis above 1 the model runs
tensor parallel (``sharding/tp.py``): the ranks of the axis share their
rows of the batch, each computes on its heads, columns and vocab, and
``reduce_grads`` also sums over ``"model"`` the gradients of the
model-replicated leaves each rank reads on its own heads.  With
``gather_small_weights_once`` and ``microbatches > 1`` every sharded leaf
that is not a routed expert's is gathered once along ``"data"`` before the
microbatch loop, its ``"model"`` chunk kept (``rules.
constrain_gathered_weight``), its float32 gradient accumulated over the
microbatches and reduce-scattered once after them: the reference's
``gather_small_weights_once``.  Without a mesh it changes nothing, as on
the reference's one device.  The ``moe`` family and MTP do not shard
(``fsdp.check_family``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import encdec as ED, moe as MOE, transformer as T
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.sharding import fsdp, rules

F32 = torch.float32


def loss_fn(model: T.Transformer | ED.EncDec, batch: dict) -> tuple[torch.Tensor, dict]:
    if model.cfg.family == "audio":
        return ED.lm_loss(model, batch["tokens"], batch["labels"], batch["frames"])
    return T.lm_loss(model, batch["tokens"], batch["labels"])


def build_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    total_steps: int = 10_000,
    warmup_steps: int = 100,
    gather_small_weights_once: bool = False,
) -> Callable:
    T.check_training(cfg)

    def grads_of(model, names, params, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(model, opt_state, batch, step_idx):
        params = dict(model.named_parameters())
        names = list(params)
        dev = next(iter(params.values())).device
        mesh = fsdp.mesh_of(model)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        if microbatches > 1:
            parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
            if any(len(p) != microbatches or p[0].shape != p[-1].shape for p in parts.values()):
                raise ValueError(f"the batch does not split into {microbatches} microbatches")
            parts = [{k: v[i] for k, v in parts.items()} for i in range(microbatches)]
        else:
            parts = [batch]
        held = {}
        if mesh is not None:
            parts = [rules.shard_batch(part, mesh) for part in parts]
            if gather_small_weights_once and microbatches > 1:
                held = fsdp.gather_once(params, mesh)
        leaves = {**params, **held}
        with fsdp.holding(params, held):
            if microbatches > 1:
                grads = {n: torch.zeros(p.shape, dtype=F32, device=dev) for n, p in leaves.items()}
                loss = torch.zeros((), dtype=F32, device=dev)
                for part in parts:
                    mb_loss, metrics, mb_grads = grads_of(model, names, leaves, part)
                    for n, g in mb_grads.items():
                        grads[n].add_(g.to(F32) / microbatches)
                    loss = loss + mb_loss / microbatches
                    del mb_grads
            else:
                loss, metrics, grads = grads_of(model, names, leaves, parts[0])
        if mesh is not None:
            grads = fsdp.reduce_grads(grads, params, held)
        del held, leaves
        lr_scale = cosine_schedule(torch.as_tensor(step_idx, device=dev), total_steps, warmup_steps)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg, lr_scale)
        del grads
        if cfg.moe is not None and cfg.moe.router == "sigmoid_bias":
            for blk in model.moe_blocks:
                MOE.update_router_bias(blk.moe, cfg, metrics["expert_load"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step
