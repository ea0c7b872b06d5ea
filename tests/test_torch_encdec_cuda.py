"""The audio family's kernels on the card (``-m cuda``; each test skips
without a CUDA device): flash at the Whisper encoder's non-causal 1500
frames (a ragged last tile) forward and backward, and a whisper smoke
prefill, generation and training step on the kernels against the same on
the plain versions.  No JAX here: the kernels are held to the port's plain
versions, as ``chip_smoke.py`` phase 21 holds the full-width model.  On the
GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encdec_cuda.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.kernels import flash_attention as fa, ref as tref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the audio path's kernels run only on a CUDA card")
    from repro_torch.kernels import _build

    _build.build(["flash_attention", "flash_attention_bwd"])
    return torch.device("cuda")


@pytest.mark.cuda
def test_non_causal_flash_over_1500_frames_matches_plain():
    """Forward within one bf16 ulp of the float32 plain version (1e-5 on
    lse) at (1, 4, 1500, 64), non-causal; the backward on the tensor-core
    route within one bf16 ulp plus 1e-5 of the scale of the plain backward
    on the same residuals."""
    dev = _card()
    rng = np.random.default_rng(31)
    mk = lambda: torch.from_numpy(rng.standard_normal((1, 4, 1500, 64)).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    o_w, lse_w = tref.attention(q.float(), k.float(), v.float(), causal=False, with_lse=True)
    assert bool(((o.double() - o_w.double()).abs() <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
    assert float((lse - lse_w).abs().max()) <= 1e-5
    before = dict(fa.flash_bwd_dkv.route_launches)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.FlashAttention.apply(ql, kl, vl, False, None), (ql, kl, vl), do)
    assert fa.flash_bwd_dkv.route_launches["tensor cores"] == before["tensor cores"] + 1
    plain = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=64**-0.5)
    for g, p in zip(got, plain):
        g64, p64 = g.double(), p.double()
        sc = float(p64.abs().max())
        assert bool(((g64 - p64).abs() <= 2.0**-7 * p64.abs() + 1e-5 * sc).all())


@pytest.mark.cuda
def test_smoke_serve_and_step_on_the_kernels_match_the_plain_versions():
    """The whisper smoke config in bf16: the prefill's and the generation's
    launches (``whisper_launches``) and the prefill's logits within
    ``SERVE_PREFILL_TOL`` of the plain run's; one training step's launches
    and its loss and grad norm within ``TRAIN_TOL`` of the plain step's,
    from the same start."""
    dev = _card()
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import ServeEngine, build_prefill_step
    from repro_torch.train import build_train_step
    from repro_torch.train.loop import audio_frames

    cfg = dataclasses.replace(chip_smoke.whisper_train_config(), dtype="bfloat16")
    want = chip_smoke.whisper_launches(cfg)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device=dev)
    tok = torch.as_tensor(chip_smoke.serve_prompts(cfg.vocab_size, 2, 40, 1), device=dev)
    frames = audio_frames(cfg, 2, 3, dev)
    step = build_prefill_step(cfg)
    chip_smoke._reset_counts()
    logits, _ = step(model, tok, frames)
    assert chip_smoke._counts() == want["prefill"]
    with ops.forced("ref"):
        plain, _ = step(model, tok, frames)
    assert chip_smoke._max_err(logits, plain) <= chip_smoke.SERVE_PREFILL_TOL
    chip_smoke._reset_counts()
    out = ServeEngine(cfg, model, max_len=48, device=dev).generate(tok, 6, frames=frames)
    assert out.shape == (2, 46) and chip_smoke._counts() == want["generate"]

    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamWConfig(lr=1e-3)
    train_step = build_train_step(cfg, opt, total_steps=10, warmup_steps=1)
    batch = SyntheticLMDataset(DataConfig(batch=4, seq_len=128,
                                          vocab_size=cfg.vocab_size)).batch_at(0)
    batch["frames"] = audio_frames(cfg, 4, 0, dev)
    with ops.forced("ref"):
        _, _, mp = train_step(model, adamw_init(params, opt), batch, 0)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    chip_smoke._reset_train_counts()
    _, _, mk = train_step(model, adamw_init(params, opt), batch, 0)
    assert chip_smoke._train_counts() == want["train"]
    tol = chip_smoke.TRAIN_TOL
    assert abs(float(mk["loss"]) - float(mp["loss"])) <= tol["loss"]
    assert abs(float(mk["grad_norm"]) / float(mp["grad_norm"]) - 1) <= tol["grad_norm"]
