"""The JAX package's numbers for ``chip_smoke.py``'s rwkv6-7b serving check,
and a CPU check of the script's comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_RWKV_SERVE``: rwkv6-7b at full
width cut to ``RWKV_SERVE_REF["n_layers"]`` = 4 layers (bf16, 1.4 B
parameters from ``convert.random_lm_tree(cfg, 0)``, ~5.6 GB as float32)
through the JAX package on the CPU: its prefill step on 2 prompts x 64
tokens, ``ServeEngine.generate`` of 8 greedy tokens, and the decode step's
logits at each generated position with those tokens fed back (a few
minutes, ~12 GB of memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rwkv6_serve_reference.py

With ``--port`` it also runs the port on the CPU on the same weights and
prompts and prints its numbers and their comparison
(``chip_smoke.compare_serve`` under ``RWKV_LOGIT_TOL``).

As a test it runs the same comparison between the port on the CPU and the
JAX package at the rwkv6-7b smoke width in bf16.  The 64-token prompts
take both packages' chunk-parallel plain scan here (on the card the port
runs its sequential kernel), the decode steps the sequential one.
"""
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_serve_reference import jax_serve_summary, port_serve_summary  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root is on the path now)

REF = chip_smoke.RWKV_SERVE_REF


def test_rwkv6_serve_check_passes_on_cpu_at_smoke_width():
    from repro.configs import smoke_config as jsmoke
    from repro_torch import convert
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config("rwkv6_7b"), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke("rwkv6_7b"), dtype="bfloat16")
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, 0), REF)
    got = port_serve_summary(cfg, convert.random_lm_tree(cfg, 0), want["tokens"], ref=REF)
    bad, skipped = chip_smoke.compare_serve(got, want, chip_smoke.RWKV_LOGIT_TOL,
                                            chip_smoke.RWKV_MARGIN_TOL)
    assert bad == []
    assert skipped < 2 * REF["gen_tokens"]
    assert len(got["tokens"]) == REF["requests"] and len(got["tokens"][0]) == REF["gen_tokens"]
    # Every generated position is compared through its teacher-forced step,
    # and JAX's chosen token is its step's argmax.
    assert [len(s) for s in got["steps"]] == [REF["gen_tokens"]] * REF["requests"]
    assert all(w["at_fed"] == w["max"] for ws in want["steps"] for w in ws)


if __name__ == "__main__":
    from repro.configs import full_config as jfull
    from repro_torch import convert
    from repro_torch.configs import full_config

    arch, n = chip_smoke.RWKV["arch"], REF["n_layers"]
    cfg = dataclasses.replace(full_config(arch), n_layers=n)
    jcfg = dataclasses.replace(jfull(arch), n_layers=n)
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, chip_smoke.RWKV["seed"]), REF)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = port_serve_summary(cfg, convert.random_lm_tree(cfg, chip_smoke.RWKV["seed"]),
                                 want["tokens"], ref=REF)
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_serve(
            got, want, chip_smoke.RWKV_LOGIT_TOL, chip_smoke.RWKV_MARGIN_TOL)))
        print(f"max |port - JAX| {chip_smoke.serve_max_diff(got, want)!r}")
