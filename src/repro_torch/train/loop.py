"""The training loop: step + data + checkpoints + fault tolerance +
EasyRider's PowerSim, composed (counterpart of ``repro.train.loop``).

``train()`` initialises a model (any family ``check_training`` lets
through: ``dense``, ``vlm``, ``ssm``, ``moe``, ``hybrid``, ``audio``) from ``tc.seed`` on
``device``, runs ``tc.steps`` steps of ``build_train_step`` on ``SyntheticLMDataset``
batches (``audio``: with the encoder frames of ``audio_frames``), saves
checkpoints (scheduled, and SoC-triggered emergency saves through
``PowerAwareCheckpointer``), resumes from the newest one with
``tc.resume``, and reports each step to ``power_sim``.

With ``mesh`` (a ``("data", "model")`` mesh, e.g.
``launch.mesh.make_host_mesh(model_parallel=)``, whose ``"model"`` axis
may exceed 1 for every family but ``moe``; every rank of the
world calls ``train`` alike) the model is sharded after ``init``
(``sharding.fsdp.shard_model``: every rank draws the same full weights
from ``tc.seed``, then keeps its shards on both axes), each step is
given the global batch of ``ds.batch_at(step)`` (``audio``: the global
frames) and keeps this rank's rows, and the
checkpoints are saved and restored through the shardings (rank 0 writes
the one-process layout; any world resumes from it).  ``PowerSim`` runs on
every rank, fed by its own steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import encdec as ED, layers as L, transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.power.integration import PowerSim
from repro_torch.sharding import fsdp
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import PowerAwareCheckpointer, StragglerMonitor
from repro_torch.train.step import build_train_step
from repro_torch.utils.devices import resolve_device


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    microbatches: int = 1
    seed: int = 0
    resume: bool = False


def audio_frames(cfg, batch: int, step: int, device) -> torch.Tensor:
    """The reference loop's stub-frontend frames of step ``step``:
    ``numpy.random.default_rng(step).normal(scale=0.02)`` of shape
    ``(batch, encoder_seq, d_model)`` in float64, rounded to float32 on the
    host and then to ``cfg.dtype`` on ``device``: the JAX package's
    ``jnp.asarray(..., bfloat16)`` rounds through float32 too (a double
    rounding, which moves ~1 element in 1.3e5 of a direct float64 -> bf16
    rounding by an ulp), so the bits are the reference's."""
    x = np.random.default_rng(step).normal(scale=0.02,
                                           size=(batch, cfg.encdec.encoder_seq, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(device).to(L.dtype_of(cfg))


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def train(
    cfg,
    data_cfg: DataConfig,
    opt_cfg: AdamWConfig,
    tc: TrainConfig,
    *,
    power_sim: PowerSim | None = None,
    callbacks: list[Callable] | None = None,
    device="cuda",
    mesh=None,
) -> dict:
    """Returns ``{"params": the trained Transformer (``audio``: EncDec),
    "opt_state", "history": [{"step", "loss", "grad_norm"}, ...],
    "first_loss", "last_loss": mean of the last five, "power_report"?}``."""
    dev = resolve_device(device)
    T.check_training(cfg, mesh)
    init = ED.init if cfg.family == "audio" else T.init
    model = init(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(tc.seed))
    if mesh is not None:
        fsdp.shard_model(model, mesh)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params, opt_cfg)
    shardings = None if mesh is None else fsdp.shardings(model, opt_state)
    step_fn = build_train_step(
        cfg, opt_cfg, microbatches=tc.microbatches, total_steps=tc.steps,
        warmup_steps=max(tc.steps // 10, 1),
    )

    start_step = 0
    ckpt = None
    if tc.checkpoint_dir:
        ckpt = PowerAwareCheckpointer(
            Checkpointer(tc.checkpoint_dir), every_steps=tc.checkpoint_every
        )
        if tc.resume and ckpt.ckpt.all_steps():
            start_step, (saved, opt_state) = ckpt.ckpt.restore(None, (params, opt_state),
                                                                shardings=shardings)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
            start_step += 1

    ds = SyntheticLMDataset(data_cfg)
    monitor = StragglerMonitor(n_hosts=_world_size())
    history: list[dict] = []
    losses = []
    t_prev = time.monotonic()
    for step in range(start_step, tc.steps):
        batch = ds.batch_at(step)
        if cfg.family == "audio":
            batch["frames"] = audio_frames(cfg, data_cfg.batch, step, dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        now = time.monotonic()
        monitor.observe([now - t_prev])
        t_prev = now

        is_ckpt_step = bool(
            tc.checkpoint_dir and tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0
        )
        if power_sim is not None:
            power_sim.on_step(checkpoint_stall=is_ckpt_step)
        if ckpt is not None:
            soc = power_sim.soc if power_sim is not None else None
            ckpt.maybe_save(step, (params, opt_state), soc=soc, shardings=shardings)
        if step % tc.log_every == 0 or step == tc.steps - 1:
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"])})
        for cb in callbacks or []:
            cb(step, metrics)

    if ckpt is not None:
        ckpt.ckpt.save(tc.steps - 1, (params, opt_state), blocking=True, shardings=shardings)
    out = {
        "params": model,
        "opt_state": opt_state,
        "history": history,
        "first_loss": losses[0] if losses else None,
        "last_loss": float(np.mean(losses[-5:])) if losses else None,
    }
    if power_sim is not None:
        out["power_report"] = power_sim.report()
    return out
