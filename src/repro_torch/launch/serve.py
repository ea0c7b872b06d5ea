"""Serving launcher: batched generation with a smoke-scale config of a
``dense``, ``vlm`` or ``ssm`` architecture, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu

The flags are the JAX launcher's (``repro.launch.serve``) plus
``--device``.  Weights, prompts and sampling come from seeded
``torch.Generator``s (seeds 0, 1 and 3, as the JAX launcher's keys), so
the tokens differ from the JAX launcher's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
from repro_torch.utils.devices import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    dev = resolve_device(args.device)
    seeded = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    params = T.init(cfg, device=dev, generator=seeded(0))
    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen_tokens + 8, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.requests, args.prompt_len),
                            generator=seeded(1), device=dev)
    out = engine.generate(prompts, args.gen_tokens, temperature=args.temperature,
                          generator=seeded(3))
    for i in range(args.requests):
        print(f"req{i}: {out[i, -args.gen_tokens:].tolist()}")


if __name__ == "__main__":
    main()
