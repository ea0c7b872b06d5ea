"""The JAX package's numbers for ``chip_smoke.py``'s full-width serving
check, and a CPU check of the script's serve comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_SERVE``: llama3.2-1b at full
width (bf16, 1.24 B parameters from ``convert.random_lm_tree(cfg, 0)``)
through the JAX package on the CPU: its prefill step on 2 prompts x 64
tokens, ``ServeEngine.generate`` of 8 greedy tokens, and the decode step's
logits at each generated position with those tokens fed back
(``chip_smoke.SERVE_REF``; a few minutes, ~6 GB of memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serve_reference.py

With ``--port`` it also runs the port on the CPU on the same weights and
prompts and prints its numbers and their comparison
(``chip_smoke.compare_serve``).

As a test it runs the same comparison between the port on the CPU and the
JAX package at the llama3.2-1b smoke width in bf16, so the check's bf16
rounding points, its teacher-forced steps and its token walk are exercised
here.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(4)


def jax_params(tree, jcfg):
    """``tree`` (numpy, float32) as JAX arrays of the types the JAX
    package's ``init`` gives each leaf for ``jcfg`` (the config's dtype;
    RWKV-6's ``decay_base`` and ``u_bonus`` stay float32), converting (and
    dropping) one numpy leaf at a time to bound the peak memory."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    like = jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg))

    def conv(node, want):
        out = {}
        for k in list(node):
            v = node.pop(k)
            out[k] = conv(v, want[k]) if isinstance(v, dict) else jnp.asarray(v, want[k].dtype)
        return out

    return conv(tree, like)


def jax_serve_summary(jcfg, tree, ref=chip_smoke.SERVE_REF) -> dict:
    """``ref`` (``chip_smoke.SERVE_REF`` or ``RWKV_SERVE_REF``) through the
    JAX package on the CPU with the weights ``tree``; ``serve_summary``."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    from repro.serve import ServeEngine, build_decode_step, build_prefill_step

    t0, n = ref["prompt_len"], ref["gen_tokens"]
    params = jax_params(tree, jcfg)
    prompts = jnp.asarray(chip_smoke.serve_prompts(jcfg.vocab_size, ref["requests"], t0,
                                                   ref["prompt_seed"]))
    logits, _ = build_prefill_step(jcfg)(params, prompts, t0 + n)
    out = ServeEngine(jcfg, params, max_len=t0 + n).generate(prompts, n)
    # ServeEngine.generate's loop with its own tokens fed back: the logits
    # that chose each generated token.
    decode = jax.jit(build_decode_step(jcfg))
    state = JT.init_decode_state(jcfg, ref["requests"], t0 + n)
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


def port_serve_summary(cfg, tree, fed, device="cpu", ref=chip_smoke.SERVE_REF) -> dict:
    from repro_torch import convert

    model = convert.lm_params_from_numpy(tree, cfg, device=device)
    return chip_smoke.port_serve_reference(model, cfg, torch.device(device), fed, ref)


def test_serve_check_passes_on_cpu_at_smoke_width():
    from repro.configs import smoke_config as jsmoke
    from repro_torch import convert
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config("llama3_2_1b"), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke("llama3_2_1b"), dtype="bfloat16")
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, 0))
    got = port_serve_summary(cfg, convert.random_lm_tree(cfg, 0), want["tokens"])
    bad, skipped = chip_smoke.compare_serve(got, want)
    assert bad == []
    assert skipped < 2 * chip_smoke.SERVE_REF["gen_tokens"]
    assert len(got["tokens"]) == 2 and len(got["tokens"][0]) == 8
    # Every generated position is compared through its teacher-forced step,
    # and JAX's chosen token is its step's argmax.
    assert [len(s) for s in got["steps"]] == [8, 8]
    assert all(w["at_fed"] == w["max"] for ws in want["steps"] for w in ws)


if __name__ == "__main__":
    from repro.configs import full_config as jfull
    from repro_torch import convert
    from repro_torch.configs import full_config

    arch = chip_smoke.SERVE["arch"]
    cfg, jcfg = full_config(arch), jfull(arch)
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, chip_smoke.SERVE["seed"]))
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = port_serve_summary(cfg, convert.random_lm_tree(cfg, chip_smoke.SERVE["seed"]),
                                 want["tokens"])
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_serve(got, want)))
        print(f"max |port - JAX| {chip_smoke.serve_max_diff(got, want)!r}")
