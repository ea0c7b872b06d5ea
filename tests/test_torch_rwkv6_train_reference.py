"""The JAX package's numbers for ``chip_smoke.py``'s rwkv6 training check
(phase 22c), and CPU runs of the script's ssm training comparisons.

Run as a script it records ``chip_smoke.JAX_RWKV_TRAIN``: two steps of the
JAX package's jitted ``build_train_step`` on the rwkv6 smoke config in
float32 (``chip_smoke.RWKV_TRAIN_REF``: 2 layers, 4 x 128 tokens of the
synthetic data a step, AdamW and the schedule of ``chip_smoke.TRAIN``)
from ``convert.random_lm_tree(cfg, 0)``, on the CPU (under a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rwkv6_train_reference.py

With ``--port`` it also runs the port on the CPU and prints its numbers and
their comparison (``chip_smoke.compare_train`` under ``RWKV_REF_TOL``): the
largest differences are ``chip_smoke.RWKV_REF_MEASURED``.

As a test it checks that the recorded numbers are the JAX package's, runs
phase 22c's comparison with the port on the CPU (its plain versions),
shows that the comparison catches a wrong step and a wrong weight decay,
runs phase 22a's comparison (``TRAIN_TOL`` on ``RWKV_TRAIN_LEAVES``) at
the smoke width in bf16 (the port's bf16 step against the float32 step on
the same weights), and counts the plain versions' calls of a training step
against ``chip_smoke.rwkv_train_launches``.
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
LEAVES = chip_smoke.RWKV_TRAIN_LEAVES


def _leaf(tree, path):
    node = tree
    for k in path.split("."):
        node = node[k]
    a = np.asarray(node, np.float32)
    return a[0] if path.startswith("blocks.") else a


def jax_rwkv_train_summary(cfg, ref=chip_smoke.RWKV_TRAIN_REF, weights=None) -> dict:
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
    jcfg = dataclasses.replace(jsmoke(chip_smoke.RWKV_TRAIN["arch"]), dtype=cfg.dtype)
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
    return chip_smoke.port_rwkv_train_reference(chip_smoke.rwkv_ref_config(),
                                                torch.device("cpu"))


def test_recorded_numbers_are_the_jax_packages():
    """A fresh JAX run against the recorded one: the losses and grad norms
    to 1e-6, the rest under RWKV_REF_TOL (XLA's threaded reductions on the
    CPU may sum in another order from run to run)."""
    want = jax_rwkv_train_summary(chip_smoke.rwkv_ref_config())
    got = chip_smoke.JAX_RWKV_TRAIN
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-6)
    assert chip_smoke.compare_train(got, want, LR, chip_smoke.RWKV_REF_TOL, LEAVES) == []


def test_port_on_cpu_passes_the_check(port_run):
    """Phase 22c's comparison of the port on the CPU, whose largest
    differences are the recorded ``RWKV_REF_MEASURED``."""
    bad = chip_smoke.compare_train(port_run, chip_smoke.JAX_RWKV_TRAIN, LR,
                                   chip_smoke.RWKV_REF_TOL, LEAVES)
    assert bad == []
    assert len(port_run["loss"]) == chip_smoke.RWKV_TRAIN_REF["steps"]
    got = chip_smoke.train_max_diff(port_run, chip_smoke.JAX_RWKV_TRAIN, LR,
                                    chip_smoke.RWKV_REF_TOL, LEAVES)
    for k, v in chip_smoke.RWKV_REF_MEASURED.items():
        assert got[k] <= 2 * v + 1e-9, (k, got[k], v)


@pytest.mark.parametrize("what", ["loss", "m", "param", "decay"])
def test_the_check_catches_a_wrong_step(port_run, what):
    """A loss off by 1e-4, a moment off by 1 % of its leaf's largest, a
    parameter moved by one more lr and ``u_bonus`` left undecayed (its
    decay, 0.1 lr of the value a step, missing) each fail."""
    bad_run = json.loads(json.dumps(port_run))
    if what == "loss":
        bad_run["loss"][1] += 1e-4
    elif what == "m":
        ms = bad_run["m"][0]["blocks.channel.wk.kernel"]
        ms[3] += 0.01 * max(abs(x) for x in ms)
    elif what == "param":
        bad_run["params"]["blocks.time.wr.kernel"][5] += 2.5 * LR * 2
    else:
        from repro_torch import convert

        start = convert.random_lm_tree(chip_smoke.rwkv_ref_config(), 0)["blocks"]["time"]
        u0 = np.asarray(start["u_bonus"][0], np.float64).reshape(-1)
        idx = chip_smoke.train_indices(start["u_bonus"][0].shape,
                                       LEAVES.index("blocks.time.u_bonus"))
        lrs = [LR * s for s in (1.0, 1.0)]  # the warmed-up schedule's first steps
        bad_run["params"]["blocks.time.u_bonus"] = [
            p + sum(lr * 0.1 for lr in lrs) * x
            for p, x in zip(bad_run["params"]["blocks.time.u_bonus"], u0[idx])]
    assert chip_smoke.compare_train(bad_run, chip_smoke.JAX_RWKV_TRAIN, LR,
                                    chip_smoke.RWKV_REF_TOL, LEAVES), what


@pytest.mark.parametrize("seq_len", [128, 512])
def test_bf16_step_is_within_train_tol_of_float32(seq_len):
    """Phase 22a-b's tolerance (``TRAIN_TOL``, bf16) against the bf16
    rounding of a whole step: one step of the rwkv6 smoke config in bf16
    by the port on the CPU against the JAX package's float32 step on the
    same weights rounded to bf16, 2 sequences of ``seq_len`` tokens
    (RWKV_TRAIN_REF's and RWKV_TRAIN's).  The loss, the grad norm and the
    parameters are held to ``TRAIN_TOL``.  The first moment of a bf16 step
    lies up to 8.4 % of the leaf's largest sampled |m| from the float32
    one at smoke width (``blocks.time.decay_base``, whose gradient sums
    the whole sequence's decay terms), past ``TRAIN_TOL``'s 2^-5, and the
    JAX package's own bf16 step lies as far (8.3 %): it is held to 2^-3,
    and to at most 1.25 x the JAX package's distance (both round at the
    same points and sum in other orders; measured 0.0837 vs 0.0826 at 512
    tokens, 0.042 vs 0.059 at 128).  On the card ``TRAIN_TOL`` holds the
    kernels against the plain versions, both bf16, at full width, where
    only the rmsnorm kernel differs."""
    cfg = dataclasses.replace(chip_smoke.rwkv_ref_config(), dtype="bfloat16")
    ref = dict(chip_smoke.RWKV_TRAIN_REF, steps=1, batch=2, seq_len=seq_len)
    truth = jax_rwkv_train_summary(chip_smoke.rwkv_ref_config(), ref, weights="bfloat16")
    jax_bf16 = jax_rwkv_train_summary(cfg, ref)
    got = chip_smoke.port_rwkv_train_reference(cfg, torch.device("cpu"), ref)
    tol = dict(chip_smoke.TRAIN_TOL, m=2.0**-3)
    assert chip_smoke.compare_train(got, truth, LR, tol, LEAVES) == []
    port_m = chip_smoke.train_max_diff(got, truth, LR, tol, LEAVES)["m"]
    jax_m = chip_smoke.train_max_diff(jax_bf16, truth, LR, tol, LEAVES)["m"]
    assert port_m <= 1.25 * jax_m


def test_plain_calls_match_the_launch_counts(monkeypatch):
    """On the CPU every rmsnorm call takes its plain version: its count, and
    the plain scan forms' calls, in a ``build_train_step`` step with
    ``remat="block"`` are what ``rwkv_train_launches`` expects on the card
    (at 128 tokens the chunked form, at 40 the sequential scan)."""
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ref as tref
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    calls = dict.fromkeys(("rmsnorm", "rwkv6_chunked", "rwkv6_scan"), 0)
    for name in calls:
        plain = getattr(tref, name)

        def spy(*a, _plain=plain, _key=name, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tref, name, spy)
    cfg = chip_smoke.rwkv_ref_config()
    opt = AdamWConfig(lr=LR)
    for t in (128, 40):
        want = chip_smoke.rwkv_train_launches(cfg, t)
        calls.update(dict.fromkeys(calls, 0))
        model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
        step = build_train_step(cfg, opt, total_steps=10, warmup_steps=1)
        ds = SyntheticLMDataset(DataConfig(batch=2, seq_len=t, vocab_size=cfg.vocab_size))
        step(model, adamw_init(dict(model.named_parameters()), opt), ds.batch_at(0), 0)
        assert calls == {"rmsnorm": want["kernels"]["rmsnorm"], **want["plain"]}, t
    assert want["rwkv6_scan"] == 0


if __name__ == "__main__":
    cfg = chip_smoke.rwkv_ref_config()
    want = jax_rwkv_train_summary(cfg)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = chip_smoke.port_rwkv_train_reference(cfg, torch.device("cpu"))
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_train(
            got, want, LR, chip_smoke.RWKV_REF_TOL, LEAVES)))
        print("largest: " + json.dumps(chip_smoke.train_max_diff(
            got, want, LR, chip_smoke.RWKV_REF_TOL, LEAVES)))
