"""Training launcher: a smoke-scale config of a ``dense`` or ``vlm``
architecture, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 3 \\
        --device cpu --power-sim

The flags are the JAX launcher's (``repro.launch.train``) plus
``--device``.  The weights come from ``torch.Generator(...).manual_seed(0)``,
so the losses differ from the JAX launcher's.  ``--power-sim`` puts
EasyRider's ``PowerSim`` in the loop with the JAX launcher's step cost
(``power_sim_for``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import smoke_config
from repro_torch.configs.registry import ALIASES, ARCH_IDS
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.power.integration import PowerSim
from repro_torch.power.phases import HardwareConstants, PhaseModel, StepCost
from repro_torch.train import TrainConfig, train


def power_sim_for(cfg, batch: int, seq: int, *, device="cuda") -> PowerSim:
    """The launcher's ``PowerSim``: a 256-chip job whose step runs
    ``6 N tokens x 1e3`` FLOPs, 1 PB of HBM traffic and 200 TB of
    collectives (the reference launcher's cost model, scaled up so that a
    step lasts tens of seconds of simulated time)."""
    n = cfg.param_count()
    return PowerSim(
        StepCost(flops=6.0 * n * batch * seq * 1e3, hbm_bytes=1e15, collective_bytes=2e14),
        HardwareConstants(chips=256),
        PhaseModel(),
        device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help=f"one of {sorted(ALIASES) + list(ARCH_IDS)}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--power-sim", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    sim = power_sim_for(cfg, args.batch, args.seq, device=args.device) if args.power_sim else None
    res = train(
        cfg,
        DataConfig(batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size),
        AdamWConfig(lr=args.lr),
        TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                    checkpoint_dir=args.ckpt_dir, resume=args.resume,
                    microbatches=args.microbatches),
        power_sim=sim,
        device=args.device,
    )
    for rec in res["history"]:
        print(rec)
    if sim is not None:
        print("power:", res["power_report"])


if __name__ == "__main__":
    main()
