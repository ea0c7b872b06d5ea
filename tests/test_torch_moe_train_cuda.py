"""One deepseek-v2 smoke training step on the card's kernels against the
same step on the plain versions (``-m cuda``; skips without a CUDA
device).  No JAX here: the kernels are held to the port's plain versions,
as ``chip_smoke.py`` phase 18b holds the full-width step.  On the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_train_cuda.py
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.cuda
def test_v2_smoke_step_on_the_kernels_matches_the_plain_versions():
    """bf16, ``remat="block"``, capacity factor 1.25, 4 x 128 tokens: the
    plain step's routing imposed on the kernel step (``routed_as``, the
    recompute replaying its forward), every kernel launched
    ``moe_train_launches`` times, the plain step launching none, and the
    step's numbers within ``MOE_TRAIN_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("the training kernels run only on a CUDA card")
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import _build, ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm"])
    dev = torch.device("cuda")
    base = smoke_config("deepseek_v2_236b")
    cfg = dataclasses.replace(base, dtype="bfloat16",
                              moe=dataclasses.replace(base.moe, capacity_factor=1.25))
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device=dev)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamWConfig(lr=1e-3)
    step = build_train_step(cfg, opt, total_steps=10, warmup_steps=1)
    ds = SyntheticLMDataset(DataConfig(batch=4, seq_len=128, vocab_size=cfg.vocab_size))
    batch = ds.batch_at(0)

    chip_smoke._reset_train_counts()
    with chip_smoke.capture_routing(model) as rp, ops.forced("ref"):
        _, st, mp = step(model, adamw_init(params, opt), batch, 0)
    assert set(chip_smoke._train_counts().values()) == {0}
    expert = int(torch.argmax(mp["expert_load"]))
    want = chip_smoke._moe_step_summary(model, st, mp, expert)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    with chip_smoke.routed_as(rp, model):
        _, st, mk = step(model, adamw_init(params, opt), batch, 0)
    assert chip_smoke._train_counts() == chip_smoke.moe_train_launches(cfg)
    got = chip_smoke._moe_step_summary(model, st, mk, expert)
    assert chip_smoke.compare_moe_train(got, want, 1e-3, chip_smoke.MOE_TRAIN_TOL) == []
