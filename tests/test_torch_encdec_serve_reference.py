"""The JAX package's numbers for ``chip_smoke.py``'s whisper serving check
(phase 21d), and CPU runs of the script's comparison.

Run as a script it records ``chip_smoke.JAX_WHISPER_SERVE``: whisper-large-v3
at full width cut to ``WHISPER_SERVE_REF``'s 2 encoder and 2 decoder
layers (bf16, weights ``convert.random_lm_tree(cfg, 0)``) through the JAX
package on the CPU, with the 1500 frames of ``WHISPER["frame_seed"]`` a
request (the reference loop's draw, ``train.loop.audio_frames``): its
prefill step on 2 prompts x 64 tokens, ``ServeEngine.generate`` of 8
greedy tokens, and the decode step's logits at each generated position
with those tokens fed back (about a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_encdec_serve_reference.py

With ``--port`` it also runs the port on the CPU on the same weights,
frames and prompts and prints its numbers and their comparison
(``chip_smoke.compare_serve`` under ``WHISPER_LOGIT_TOL``).

As a test it re-derives the recorded numbers from the JAX package, runs
the card's comparison with the port on the CPU (its plain versions) at the
recorded size, shows that the comparison catches a wrong logit or token,
and runs the same comparison at the whisper smoke width in bf16.
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

REF = chip_smoke.WHISPER_SERVE_REF
SEED = chip_smoke.WHISPER["seed"]


def jax_frames(jcfg, batch: int, seed: int):
    """The reference loop's frames: ``jnp.asarray(default_rng(seed).normal(
    scale=0.02, ...), dtype)`` (``repro/train/loop.py:77-81``)."""
    import jax.numpy as jnp

    x = np.random.default_rng(seed).normal(scale=0.02, size=(batch, jcfg.encdec.encoder_seq,
                                                             jcfg.d_model))
    return jnp.asarray(x, jnp.dtype(jcfg.dtype))


def jax_whisper_serve_summary(jcfg, tree, ref=REF) -> dict:
    """``ref`` through the JAX package on the CPU with the weights ``tree``
    (consumed leaf by leaf); ``chip_smoke.serve_summary``."""
    import jax
    import jax.numpy as jnp

    from repro.models import encdec as JED
    from repro.serve import ServeEngine, build_decode_step, build_prefill_step

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else jnp.asarray(v, jnp.dtype(jcfg.dtype))
                for k, v in ((k, node.pop(k)) for k in list(node))}

    t0, n, r = ref["prompt_len"], ref["gen_tokens"], ref["requests"]
    params = conv(tree)
    prompts = jnp.asarray(chip_smoke.serve_prompts(jcfg.vocab_size, r, t0, ref["prompt_seed"]))
    frames = jax_frames(jcfg, r, ref["frame_seed"])
    logits, _ = build_prefill_step(jcfg)(params, prompts, frames)
    out = ServeEngine(jcfg, params, max_len=t0 + n).generate(prompts, n, frames=frames)
    # ServeEngine.generate's loop with its own tokens fed back: the logits
    # that chose each generated token.
    decode = jax.jit(build_decode_step(jcfg))
    state = JED.init_decode_state(params, jcfg, frames, r, t0 + n)
    step, state = decode(params, prompts, state, jnp.asarray(0, jnp.int32))
    steps = [step[:, -1]]
    for i in range(n - 1):
        step, state = decode(params, out[:, t0 + i:t0 + i + 1], state,
                             jnp.asarray(t0 + i, jnp.int32))
        steps.append(step[:, -1])
    steps = np.stack([np.asarray(s) for s in steps], axis=1)
    assert (steps.argmax(-1) == np.asarray(out)[:, t0:]).all()
    return chip_smoke.serve_summary(np.asarray(logits), np.asarray(out), steps,
                                    np.asarray(out)[:, t0:], ref)


def port_whisper_serve_summary(cfg, tree, fed, ref=REF) -> dict:
    from repro_torch import convert

    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    return chip_smoke.port_serve_reference(model, cfg, torch.device("cpu"), fed, ref)


def _jax_cfg(cfg):
    from repro.configs import full_config as jfull

    jcfg = jfull(chip_smoke.WHISPER["arch"])
    return dataclasses.replace(jcfg, n_layers=cfg.n_layers, encdec=dataclasses.replace(
        jcfg.encdec, encoder_layers=cfg.encdec.encoder_layers))


@pytest.fixture(scope="module")
def runs():
    from repro_torch import convert

    cfg = chip_smoke.whisper_serve_config()
    want = jax_whisper_serve_summary(_jax_cfg(cfg), convert.random_lm_tree(cfg, SEED))
    got = port_whisper_serve_summary(cfg, convert.random_lm_tree(cfg, SEED), want["tokens"])
    return want, got


def test_recorded_numbers_are_the_jax_packages(runs):
    """A fresh JAX run against the recorded one: the same tokens, every
    compared logit within 1e-6 (XLA's threaded reductions on the CPU may
    sum in another order from run to run)."""
    want, _ = runs
    rec = chip_smoke.JAX_WHISPER_SERVE
    assert want["tokens"] == rec["tokens"]
    assert chip_smoke.serve_max_diff(want, rec) <= 1e-6


def test_port_on_cpu_passes_the_check(runs):
    _, got = runs
    bad, skipped = chip_smoke.compare_serve(got, chip_smoke.JAX_WHISPER_SERVE,
                                            chip_smoke.WHISPER_LOGIT_TOL,
                                            chip_smoke.WHISPER_MARGIN_TOL)
    assert bad == []
    assert skipped < 2 * REF["gen_tokens"]
    assert [len(s) for s in got["steps"]] == [REF["gen_tokens"]] * REF["requests"]


def test_the_check_catches_a_wrong_step(runs):
    """A prefill row's logit off by twice the tolerance, a teacher-forced
    step's log-sum-exp off by as much, and a confident token changed each
    fail."""
    _, got = runs
    tol = chip_smoke.WHISPER_LOGIT_TOL
    want = chip_smoke.JAX_WHISPER_SERVE
    for what in ("row", "step", "token"):
        bad_run = json.loads(json.dumps(got))
        if what == "row":
            bad_run["rows"][2]["at_ids"][3] += 2 * tol
        elif what == "step":
            bad_run["steps"][1][4]["lse"] -= 2 * tol
        else:
            r, p = next((r, p) for r, ws in enumerate(want["steps"]) for p, w in enumerate(ws)
                        if w["margin"] > chip_smoke.WHISPER_MARGIN_TOL
                        and all(a == b for a, b in zip(got["tokens"][r][:p + 1],
                                                       want["tokens"][r][:p + 1])))
            bad_run["tokens"][r][p] = (want["tokens"][r][p] + 1) % 51866
        bad, _ = chip_smoke.compare_serve(bad_run, want, tol, chip_smoke.WHISPER_MARGIN_TOL)
        assert bad, what


def test_whisper_serve_check_passes_on_cpu_at_smoke_width():
    """The same comparison at the whisper smoke width in bf16 (2 + 2
    layers, 64 frames a request)."""
    from repro.configs import smoke_config as jsmoke
    from repro_torch import convert
    from repro_torch.configs import smoke_config

    arch = chip_smoke.WHISPER["arch"]
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke(arch), dtype="bfloat16")
    want = jax_whisper_serve_summary(jcfg, convert.random_lm_tree(cfg, 0))
    got = port_whisper_serve_summary(cfg, convert.random_lm_tree(cfg, 0), want["tokens"])
    bad, skipped = chip_smoke.compare_serve(got, want, chip_smoke.WHISPER_LOGIT_TOL,
                                            chip_smoke.WHISPER_MARGIN_TOL)
    assert bad == []
    assert skipped < 2 * REF["gen_tokens"]
    assert all(w["at_fed"] == w["max"] for ws in want["steps"] for w in ws)


if __name__ == "__main__":
    from repro_torch import convert

    cfg = chip_smoke.whisper_serve_config()
    want = jax_whisper_serve_summary(_jax_cfg(cfg), convert.random_lm_tree(cfg, SEED))
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = port_whisper_serve_summary(cfg, convert.random_lm_tree(cfg, SEED), want["tokens"])
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_serve(
            got, want, chip_smoke.WHISPER_LOGIT_TOL, chip_smoke.WHISPER_MARGIN_TOL)))
        print(f"max |port - JAX| {chip_smoke.serve_max_diff(got, want)!r}")
