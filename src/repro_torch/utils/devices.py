"""Device resolution for the port's entry points.

Every entry point that creates tensors takes an explicit ``device`` and
defaults to ``"cuda"``: the port is written for the GPU, and a missing
card is an error, never a quiet run on the CPU.  The CPU tests pass
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    no card is present.

    On first touching the card this also pins float32 matrix products to
    full FP32 (TF32 off for cuBLAS and cuDNN): the reference computes every
    quantity in FP32, and TF32 keeps only ~3 decimal digits, which the
    controller QP's KKT products would not survive at the tolerances the
    port is held to.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch defaults to device='cuda', but no CUDA device is "
                "available; pass device='cpu' explicitly to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
