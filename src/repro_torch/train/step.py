"""Train-step builder: loss + grad + AdamW, with microbatch gradient
accumulation (counterpart of ``repro.train.step``).

``build_train_step(cfg, opt_cfg, microbatches=...)`` returns

    step(model, opt_state, batch, step_idx) -> (model, opt_state, metrics)

which updates the model's parameters in place (``adamw_update``) and
returns the new optimizer state and the metrics of the reference:
``lm_loss``, ``tokens`` and ``total_loss`` of the last microbatch,
``grad_norm``, ``lr`` and ``loss`` (the mean over microbatches).
Microbatching splits the batch on the leading axis and accumulates the
gradients in float32 buffers, as the reference's scan does (``.grad``
would accumulate in the parameters' bf16).

Not ported yet (ROADMAP.md): the audio family's loss and the moe family's
aux-loss-free router-bias nudge come with those families, and
``check_training`` raises for them; it raises for the ``ssm`` family too,
whose recurrence has no backward kernel.  ``gather_small_weights_once`` is a
sharding constraint of the reference's FSDP mesh; on one device it is an
identity.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.schedules import cosine_schedule

F32 = torch.float32


def loss_fn(model: T.Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
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
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))

    def train_step(model, opt_state, batch, step_idx):
        params = dict(model.named_parameters())
        names = list(params)
        dev = next(iter(params.values())).device
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        if microbatches > 1:
            parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
            if any(len(p) != microbatches or p[0].shape != p[-1].shape for p in parts.values()):
                raise ValueError(f"the batch does not split into {microbatches} microbatches")
            grads = {n: torch.zeros(p.shape, dtype=F32, device=dev) for n, p in params.items()}
            loss = torch.zeros((), dtype=F32, device=dev)
            for i in range(microbatches):
                mb_loss, metrics, mb_grads = grads_of(
                    model, names, params, {k: v[i] for k, v in parts.items()})
                for n, g in mb_grads.items():
                    grads[n].add_(g.to(F32) / microbatches)
                loss = loss + mb_loss / microbatches
                del mb_grads
        else:
            loss, metrics, grads = grads_of(model, names, params, batch)
        lr_scale = cosine_schedule(torch.as_tensor(step_idx, device=dev), total_steps, warmup_steps)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg, lr_scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step
