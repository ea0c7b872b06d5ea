"""The JAX package's numbers for ``chip_smoke.py``'s training check, and a
CPU check of the script's train comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_TRAIN``: llama3.2-1b at full
width but 2 layers (bf16, parameters from ``convert.random_lm_tree(cfg,
0)``), ``chip_smoke.TRAIN_REF``'s two AdamW steps on 2 x 64 tokens of the
synthetic data, through the JAX package's ``build_train_step`` on the CPU
(a few minutes, ~10 GB of memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_reference.py

With ``--port`` it also runs the port on the CPU on the same weights and
batches and prints its numbers and their comparison
(``chip_smoke.compare_train``).

As a test it runs the same comparison between the port on the CPU and the
JAX package at the llama3.2-1b smoke width in bf16, so the check's
sampling, its bf16 rounding points and its tolerances are exercised here.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(4)


def _jax_params(tree, dtype):
    """The tree as JAX arrays of ``dtype``, converting (and dropping) one
    numpy leaf at a time to bound the peak memory."""
    import jax.numpy as jnp

    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = _jax_params(v, dtype) if isinstance(v, dict) else jnp.asarray(v, dtype)
    return out


def _leaf(tree, path):
    node = tree
    for k in path.split("."):
        node = node[k]
    a = np.asarray(node.astype("float32") if hasattr(node, "astype") else node)
    return a[0] if path.startswith("blocks.") else a


def jax_train_summary(jcfg, tree) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.data import DataConfig, SyntheticLMDataset
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.step import build_train_step

    tr, ref = chip_smoke.TRAIN, chip_smoke.TRAIN_REF
    params = _jax_params(tree, jnp.dtype(jcfg.dtype))
    opt = AdamWConfig(lr=tr["lr"])
    state = adamw_init(params, opt)
    step = jax.jit(build_train_step(jcfg, opt, total_steps=tr["total_steps"],
                                    warmup_steps=tr["warmup_steps"]))
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=ref["batch"],
                                       seq_len=ref["seq_len"], vocab_size=jcfg.vocab_size))
    losses, norms, moments = [], [], []
    for i in range(ref["steps"]):
        params, state, metrics = step(params, state, ds.batch_at(i), jnp.asarray(i))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        moments.append(chip_smoke.train_samples(lambda p: _leaf(state.m, p)))
    sampled = chip_smoke.train_samples(lambda p: _leaf(params, p))
    return chip_smoke.train_summary(losses, norms, sampled, moments)


def port_train_summary(cfg, tree, device="cpu") -> dict:
    from repro_torch import convert

    model = convert.lm_params_from_numpy(tree, cfg, device=device)
    return chip_smoke.port_train_reference(model, cfg, torch.device(device))


def _ref_configs(n_layers=None, width="smoke"):
    from repro.configs import full_config as jfull, smoke_config as jsmoke
    from repro_torch.configs import full_config, smoke_config

    arch = chip_smoke.TRAIN["arch"]
    cfg, jcfg = (smoke_config(arch), jsmoke(arch)) if width == "smoke" else \
        (full_config(arch), jfull(arch))
    over = dict(dtype="bfloat16")
    if n_layers is not None:
        over["n_layers"] = n_layers
    return dataclasses.replace(cfg, **over), dataclasses.replace(jcfg, **over)


@pytest.fixture(scope="module")
def smoke_runs():
    from repro_torch import convert

    cfg, jcfg = _ref_configs()
    want = jax_train_summary(jcfg, convert.random_lm_tree(cfg, 0))
    got = port_train_summary(cfg, convert.random_lm_tree(cfg, 0))
    return cfg, got, want


def test_train_check_passes_on_cpu_at_smoke_width(smoke_runs):
    from repro_torch import convert

    cfg, got, want = smoke_runs
    assert chip_smoke.compare_train(got, want, chip_smoke.TRAIN["lr"]) == []
    ref = chip_smoke.TRAIN_REF
    assert len(got["loss"]) == len(got["m"]) == ref["steps"]
    assert all(len(got["params"][p]) == ref["samples"] for p in chip_smoke.TRAIN_LEAVES)
    # The weights moved: the compared parameters are the updated ones.
    init = chip_smoke.train_samples(lambda p: _leaf(convert.random_lm_tree(cfg, 0), p))
    moved = sum(a != b for p in ("embed.embedding", "blocks.attn.wq.kernel")
                for a, b in zip(got["params"][p], init[p]))
    assert moved >= ref["samples"]


def test_train_check_catches_a_wrong_step(smoke_runs):
    """A run whose loss is off, or whose updates went the wrong way, fails
    the comparison."""
    _, got, want = smoke_runs
    off = dict(got, loss=[x + 0.05 for x in got["loss"]])
    assert any("loss" in b for b in chip_smoke.compare_train(off, want, chip_smoke.TRAIN["lr"]))
    wq = "blocks.attn.wq.kernel"
    flipped = dict(got, params=dict(got["params"], **{wq: [-x for x in got["params"][wq]]}))
    assert any(wq in b for b in chip_smoke.compare_train(flipped, want, chip_smoke.TRAIN["lr"]))


if __name__ == "__main__":
    from repro_torch import convert

    cfg, jcfg = _ref_configs(n_layers=chip_smoke.TRAIN_REF["n_layers"], width="full")
    want = jax_train_summary(jcfg, convert.random_lm_tree(cfg, chip_smoke.TRAIN["seed"]))
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = port_train_summary(cfg, convert.random_lm_tree(cfg, chip_smoke.TRAIN["seed"]))
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_train(got, want,
                                                                   chip_smoke.TRAIN["lr"])))
        print("largest differences: " + json.dumps(chip_smoke.train_max_diff(got, want,
                                                                             chip_smoke.TRAIN["lr"])))
