"""The JAX package's numbers for ``chip_smoke.py``'s whisper training check
(phase 21d), and CPU runs of the script's training comparisons.

Run as a script it records ``chip_smoke.JAX_WHISPER_TRAIN``: two steps of
the JAX package's jitted ``build_train_step`` on the whisper smoke config
in float32 (``chip_smoke.WHISPER_TRAIN_REF``: 2 encoder and 2 decoder
layers, 4 x 64 tokens of the synthetic data and the reference loop's 4 x
64 frames of the step, AdamW and the schedule of ``chip_smoke.WHISPER``)
from ``convert.random_lm_tree(cfg, 0)``, on the CPU (seconds):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_encdec_train_reference.py

With ``--port`` it also runs the port on the CPU and prints its numbers and
their comparison (``chip_smoke.compare_train`` under ``WHISPER_REF_TOL``).

As a test it checks that the recorded numbers are the JAX package's, runs
phase 21d's comparison with the port on the CPU (its plain versions),
shows that the comparison catches a wrong step and a wrong weight decay
(AdamW decays the stacked layernorm leaves, rank 2 in the reference's
tree, and ``dec_pos``, and not ``ln_enc``/``ln_f``), runs phase 21c's
comparison (``TRAIN_TOL`` on ``WHISPER_TRAIN_LEAVES``) at the smoke width
in bf16, and counts the plain versions' calls of a prefill, a generation
and a training step against ``chip_smoke.whisper_launches``.
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
LEAVES = chip_smoke.WHISPER_TRAIN_LEAVES


def _leaf(tree, path):
    node = tree
    for k in path.split("."):
        node = node[k]
    a = np.asarray(node, np.float32)
    return a[0] if path.startswith(("enc_blocks.", "dec_blocks.")) else a


def jax_whisper_train_summary(cfg, ref=chip_smoke.WHISPER_TRAIN_REF, weights=None) -> dict:
    """``chip_smoke.train_summary`` of ``ref``'s run of the port config
    ``cfg`` (its JAX twin) through the JAX package, with the reference
    loop's frames of each step; ``weights`` (a dtype name): the initial
    weights rounded to it first."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.data import DataConfig, SyntheticLMDataset
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.step import build_train_step
    from repro_torch import convert

    tr = chip_smoke.TRAIN
    jcfg = dataclasses.replace(jsmoke(chip_smoke.WHISPER["arch"]), dtype=cfg.dtype)
    dtype = jnp.dtype(cfg.dtype)
    tree = convert.random_lm_tree(cfg, tr["seed"])
    if weights is not None:
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, weights).astype(jnp.float32)),
                            tree)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    opt = AdamWConfig(lr=tr["lr"])
    state = adamw_init(params, opt)
    step = jax.jit(build_train_step(jcfg, opt, total_steps=tr["total_steps"],
                                    warmup_steps=tr["warmup_steps"]))
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=ref["batch"],
                                       seq_len=ref["seq_len"], vocab_size=jcfg.vocab_size))
    losses, norms, moments = [], [], []
    for i in range(ref["steps"]):
        batch = ds.batch_at(i)
        # repro/train/loop.py:77-81
        rng = np.random.default_rng(i)
        batch["frames"] = jnp.asarray(
            rng.normal(scale=0.02, size=(ref["batch"], jcfg.encdec.encoder_seq, jcfg.d_model)),
            dtype)
        params, state, metrics = step(params, state, batch, jnp.asarray(i))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        moments.append(chip_smoke.train_samples(lambda p: _leaf(state.m, p), LEAVES))
    sampled = chip_smoke.train_samples(lambda p: _leaf(params, p), LEAVES)
    return chip_smoke.train_summary(losses, norms, sampled, moments)


@pytest.fixture(scope="module")
def port_run():
    return chip_smoke.port_whisper_train_reference(chip_smoke.whisper_train_config(),
                                                   torch.device("cpu"))


def test_recorded_numbers_are_the_jax_packages():
    """A fresh JAX run against the recorded one: the losses and grad norms
    to 1e-6, the rest under WHISPER_REF_TOL (XLA's threaded reductions on
    the CPU may sum in another order from run to run)."""
    want = jax_whisper_train_summary(chip_smoke.whisper_train_config())
    got = chip_smoke.JAX_WHISPER_TRAIN
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-6)
    assert chip_smoke.compare_train(got, want, LR, chip_smoke.WHISPER_REF_TOL, LEAVES) == []


def test_port_on_cpu_passes_the_check(port_run):
    bad = chip_smoke.compare_train(port_run, chip_smoke.JAX_WHISPER_TRAIN, LR,
                                   chip_smoke.WHISPER_REF_TOL, LEAVES)
    assert bad == []
    assert len(port_run["loss"]) == chip_smoke.WHISPER_TRAIN_REF["steps"]


def test_the_check_catches_a_wrong_step(port_run):
    """A loss off by 1e-4, a moment off by 1 % of its leaf's largest and a
    parameter moved by one more lr each fail."""
    for what in ("loss", "m", "param"):
        bad_run = json.loads(json.dumps(port_run))
        if what == "loss":
            bad_run["loss"][1] += 1e-4
        elif what == "m":
            ms = bad_run["m"][0]["dec_blocks.xattn.wk.kernel"]
            ms[3] += 0.01 * max(abs(x) for x in ms)
        else:
            bad_run["params"]["enc_blocks.attn.wq.kernel"][5] += 2.5 * LR * 2
        assert chip_smoke.compare_train(bad_run, chip_smoke.JAX_WHISPER_TRAIN, LR,
                                        chip_smoke.WHISPER_REF_TOL, LEAVES), what


@pytest.mark.parametrize("flip", ["stacked norms undecayed", "final norms decayed"])
def test_the_check_catches_a_wrong_weight_decay(monkeypatch, flip):
    """The reference decays every leaf of rank >= 2 in its stacked tree: the
    per-layer layernorm scales and biases (rank 2 there) and ``dec_pos``
    are decayed, ``ln_enc`` and ``ln_f`` (rank 1) are not.  A port that
    took the stacked norms at their own rank 1 (undecayed), or decayed the
    final norms, fails the comparison on those leaves (and on the second
    step's loss and grad norm), while the other sampled leaves still
    pass."""
    from repro_torch.optim import adamw

    real = adamw.reference_ndim
    if flip == "stacked norms undecayed":
        wrong = lambda name, p: (1 if name.startswith(("enc_blocks.", "dec_blocks."))
                                 and ".ln" in name else real(name, p))
        hit = {"enc_blocks.ln1.scale", "dec_blocks.ln_x.scale"}
    else:
        wrong = lambda name, p: 2 if name.startswith(("ln_enc.", "ln_f.")) else real(name, p)
        hit = {"ln_enc.scale", "ln_f.scale"}
    monkeypatch.setattr(adamw, "reference_ndim", wrong)
    run = chip_smoke.port_whisper_train_reference(chip_smoke.whisper_train_config(),
                                                  torch.device("cpu"))
    bad = chip_smoke.compare_train(run, chip_smoke.JAX_WHISPER_TRAIN, LR,
                                   chip_smoke.WHISPER_REF_TOL, LEAVES)
    assert {b.split("[")[0] for b in bad if "[" in b} == hit


def test_bf16_step_is_within_train_tol_of_float32():
    """Phase 21c's tolerance (``TRAIN_TOL``, bf16) against the bf16
    rounding of a whole step: one step of the whisper smoke config in bf16
    by the port on the CPU against the JAX package's float32 step on the
    same weights rounded to bf16, held to ``TRAIN_TOL``, and lying no
    further from it than the JAX package's own bf16 step (in the first
    moment).  On the card ``TRAIN_TOL`` holds the kernels against the plain
    versions at full width."""
    cfg = dataclasses.replace(chip_smoke.whisper_train_config(), dtype="bfloat16")
    ref = dict(chip_smoke.WHISPER_TRAIN_REF, steps=1)
    truth = jax_whisper_train_summary(chip_smoke.whisper_train_config(), ref, weights="bfloat16")
    jax_bf16 = jax_whisper_train_summary(cfg, ref)
    got = chip_smoke.port_whisper_train_reference(cfg, torch.device("cpu"), ref)
    tol = chip_smoke.TRAIN_TOL
    assert chip_smoke.compare_train(got, truth, LR, tol, LEAVES) == []
    port_m = chip_smoke.train_max_diff(got, truth, LR, tol, LEAVES)["m"]
    jax_m = chip_smoke.train_max_diff(jax_bf16, truth, LR, tol, LEAVES)["m"]
    assert port_m <= max(jax_m, tol["m"])


def test_plain_calls_match_the_launch_counts(monkeypatch):
    """On the CPU every attention call takes its plain version (and no
    rmsnorm is called: whisper's norms are layernorms): their counts in a
    prefill, a generation and a ``build_train_step`` step with
    ``remat="block"`` are the kernel launches ``whisper_launches`` expects
    on the card."""
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ref as tref
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import ServeEngine, build_prefill_step
    from repro_torch.train import build_train_step
    from repro_torch.train.loop import audio_frames

    calls = {"rmsnorm": 0, "flash_attention_fwd": 0}
    for name, key in (("rmsnorm", "rmsnorm"), ("attention", "flash_attention_fwd")):
        plain = getattr(tref, name)

        def spy(*a, _plain=plain, _key=key, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tref, name, spy)
    cfg = chip_smoke.whisper_train_config()
    want = chip_smoke.whisper_launches(cfg)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    frames = audio_frames(cfg, 2, 0, "cpu")
    tok = torch.zeros((2, 12), dtype=torch.int64)
    build_prefill_step(cfg)(model, tok, frames)
    assert calls == want["prefill"]
    calls.update(rmsnorm=0, flash_attention_fwd=0)
    ServeEngine(cfg, model, max_len=20, device="cpu").generate(tok, 5, frames=frames)
    assert calls == want["generate"]
    calls.update(rmsnorm=0, flash_attention_fwd=0)
    opt = AdamWConfig(lr=LR)
    step = build_train_step(cfg, opt, total_steps=10, warmup_steps=1)
    ds = SyntheticLMDataset(DataConfig(batch=2, seq_len=12, vocab_size=cfg.vocab_size))
    step(model, adamw_init(dict(model.named_parameters()), opt),
         {**ds.batch_at(0), "frames": frames}, 0)
    assert calls == {k: want["train"][k] for k in calls}


if __name__ == "__main__":
    cfg = chip_smoke.whisper_train_config()
    want = jax_whisper_train_summary(cfg)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = chip_smoke.port_whisper_train_reference(cfg, torch.device("cpu"))
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_train(
            got, want, LR, chip_smoke.WHISPER_REF_TOL, LEAVES)))
        print("largest: " + json.dumps(chip_smoke.train_max_diff(
            got, want, LR, chip_smoke.WHISPER_REF_TOL, LEAVES)))
