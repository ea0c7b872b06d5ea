"""The JAX package's numbers for ``chip_smoke.py``'s zamba2 training check
(phase 20b), and CPU runs of the script's training comparisons.

Run as a script it records ``chip_smoke.JAX_HYBRID_TRAIN``: two steps of the
JAX package's jitted ``build_train_step`` on the zamba2 smoke config in
float32 (``chip_smoke.HYBRID_TRAIN_REF``: 4 layers, 4 x 128 tokens of the
synthetic data a step, AdamW and the schedule of ``chip_smoke.HYBRID``)
from ``convert.random_lm_tree(cfg, 0)``, on the CPU (under a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid_train_reference.py

With ``--port`` it also runs the port on the CPU and prints its numbers and
their comparison (``chip_smoke.compare_train`` under ``HYBRID_REF_TOL``).

As a test it checks that the recorded numbers are the JAX package's, runs
phase 20b's comparison with the port on the CPU (its plain versions),
shows that the comparison catches a wrong step, runs phase 20a's
comparison (``TRAIN_TOL`` on ``HYBRID_TRAIN_LEAVES``) at the smoke width in
bf16 (the port's bf16 step against the float32 step on the same weights;
the first moment at twice its bound), and counts the plain versions' calls of a prefill and
a training step against ``chip_smoke.hybrid_launches``.
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

LR = chip_smoke.TRAIN["lr"]
LEAVES = chip_smoke.HYBRID_TRAIN_LEAVES


def _leaf(tree, path):
    node = tree
    for k in path.split("."):
        node = node[k]
    a = np.asarray(node, np.float32)
    return a[0, 0] if path.startswith("groups.") else a


def jax_hybrid_train_summary(cfg, ref=chip_smoke.HYBRID_TRAIN_REF, weights=None) -> dict:
    """``chip_smoke.train_summary`` of ``ref``'s run of the port config
    ``cfg`` (its JAX twin) through the JAX package; ``weights`` (a dtype
    name): the initial weights rounded to it first."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.data import DataConfig, SyntheticLMDataset
    from repro.models import transformer as JT
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.step import build_train_step
    from repro_torch import convert

    tr = chip_smoke.TRAIN
    jcfg = dataclasses.replace(jsmoke(chip_smoke.HYBRID["arch"]), dtype=cfg.dtype)
    like = {".".join(k.key for k in p): l.dtype for p, l in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))[0]}
    tree = convert.random_lm_tree(cfg, tr["seed"])
    if weights is not None:
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, weights).astype(jnp.float32)),
                            tree)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, like[".".join(k.key for k in p)]), tree)
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
        moments.append(chip_smoke.train_samples(lambda p: _leaf(state.m, p), LEAVES))
    sampled = chip_smoke.train_samples(lambda p: _leaf(params, p), LEAVES)
    return chip_smoke.train_summary(losses, norms, sampled, moments)


@pytest.fixture(scope="module")
def port_run():
    return chip_smoke.port_hybrid_train_reference(chip_smoke.hybrid_train_config(),
                                                  torch.device("cpu"))


def test_recorded_numbers_are_the_jax_packages():
    """A fresh JAX run against the recorded one: the losses and grad norms
    to 1e-6, the rest under HYBRID_REF_TOL (XLA's threaded reductions on
    the CPU may sum in another order from run to run: a float32 ulp or
    two of an update)."""
    want = jax_hybrid_train_summary(chip_smoke.hybrid_train_config())
    got = chip_smoke.JAX_HYBRID_TRAIN
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-6)
    assert chip_smoke.compare_train(got, want, LR, chip_smoke.HYBRID_REF_TOL, LEAVES) == []


def test_port_on_cpu_passes_the_check(port_run):
    bad = chip_smoke.compare_train(port_run, chip_smoke.JAX_HYBRID_TRAIN, LR,
                                   chip_smoke.HYBRID_REF_TOL, LEAVES)
    assert bad == []
    assert len(port_run["loss"]) == chip_smoke.HYBRID_TRAIN_REF["steps"]


def test_the_check_catches_a_wrong_step(port_run):
    """A loss off by 1e-4, a moment off by 1 % of its leaf's largest and a
    parameter moved by one more lr each fail."""
    for what in ("loss", "m", "param"):
        bad_run = json.loads(json.dumps(port_run))
        if what == "loss":
            bad_run["loss"][1] += 1e-4
        elif what == "m":
            ms = bad_run["m"][0]["groups.mamba.w_in.kernel"]
            ms[3] += 0.01 * max(abs(x) for x in ms)
        else:
            bad_run["params"]["shared.block.attn.wq.kernel"][5] += 2.5 * LR * 2
        assert chip_smoke.compare_train(bad_run, chip_smoke.JAX_HYBRID_TRAIN, LR,
                                        chip_smoke.HYBRID_REF_TOL, LEAVES), what


def test_bf16_step_is_within_train_tol_of_float32():
    """Phase 20a's tolerance (``TRAIN_TOL``, bf16) against the bf16
    rounding of a whole step: one step of the zamba2 smoke config in bf16
    by the port on the CPU against the JAX package's float32 step on the
    same weights rounded to bf16.  The loss, the grad norm and the
    parameters are held to ``TRAIN_TOL``; the first moment to 2^-4 of the
    leaf's largest sampled |m|, twice ``TRAIN_TOL``'s: a Mamba leaf's
    moment in bf16 lies up to 4.9 % from the float32 one here, and the JAX
    package's own bf16 step lies further (11.7 %; it is held to lie at
    least as far as the port's).  On the card ``TRAIN_TOL`` holds the
    kernels against the plain versions at full width (1.2 % on an H100)."""
    cfg = dataclasses.replace(chip_smoke.hybrid_train_config(), dtype="bfloat16")
    ref = dict(chip_smoke.HYBRID_TRAIN_REF, steps=1)
    truth = jax_hybrid_train_summary(chip_smoke.hybrid_train_config(), ref, weights="bfloat16")
    jax_bf16 = jax_hybrid_train_summary(cfg, ref)
    got = chip_smoke.port_hybrid_train_reference(cfg, torch.device("cpu"), ref)
    tol = dict(chip_smoke.TRAIN_TOL, m=2.0**-4)
    assert chip_smoke.compare_train(got, truth, LR, tol, LEAVES) == []
    port_m = chip_smoke.train_max_diff(got, truth, LR, tol, LEAVES)["m"]
    jax_m = chip_smoke.train_max_diff(jax_bf16, truth, LR, tol, LEAVES)["m"]
    assert port_m <= jax_m


def test_plain_calls_match_the_launch_counts(monkeypatch):
    """On the CPU every rmsnorm and attention call takes its plain version:
    their counts in a prefill and in a ``build_train_step`` step with
    ``remat="block"`` are the kernel launches ``hybrid_launches`` expects
    on the card."""
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ref as tref
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import build_prefill_step
    from repro_torch.train import build_train_step

    calls = {"rmsnorm": 0, "flash_attention_fwd": 0}
    for name, key in (("rmsnorm", "rmsnorm"), ("attention", "flash_attention_fwd")):
        plain = getattr(tref, name)

        def spy(*a, _plain=plain, _key=key, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tref, name, spy)
    cfg = chip_smoke.hybrid_train_config()
    want = chip_smoke.hybrid_launches(cfg)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    build_prefill_step(cfg)(model, torch.zeros((2, 40), dtype=torch.int64), 48)
    assert calls == want["prefill"]
    calls.update(rmsnorm=0, flash_attention_fwd=0)
    opt = AdamWConfig(lr=LR)
    step = build_train_step(cfg, opt, total_steps=10, warmup_steps=1)
    ds = SyntheticLMDataset(DataConfig(batch=2, seq_len=40, vocab_size=cfg.vocab_size))
    step(model, adamw_init(dict(model.named_parameters()), opt), ds.batch_at(0), 0)
    assert calls == {k: want["train"][k] for k in calls}


if __name__ == "__main__":
    cfg = chip_smoke.hybrid_train_config()
    want = jax_hybrid_train_summary(cfg)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = chip_smoke.port_hybrid_train_reference(cfg, torch.device("cpu"))
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_train(
            got, want, LR, chip_smoke.HYBRID_REF_TOL, LEAVES)))
        print("largest: " + json.dumps(chip_smoke.train_max_diff(
            got, want, LR, chip_smoke.HYBRID_REF_TOL, LEAVES)))
