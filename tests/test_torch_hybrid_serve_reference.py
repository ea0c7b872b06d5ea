"""The JAX package's numbers for ``chip_smoke.py``'s zamba2 serving check
(phase 19b), and a CPU check of the script's comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_HYBRID_SERVE``: zamba2-2.7b at
full width cut to ``HYBRID_SERVE_REF["n_layers"]`` = 12 layers (2 groups of
6 Mamba2 blocks, so the shared block is visited twice, each visit on its
own cache; bf16, weights ``convert.random_lm_tree(cfg, 0)``) through the
JAX package on the CPU: its prefill step on 2 prompts x 64 tokens,
``ServeEngine.generate`` of 8 greedy tokens, and the decode step's logits
at each generated position with those tokens fed back (a few minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid_serve_reference.py

With ``--port`` it also runs the port on the CPU on the same weights and
prompts and prints its numbers and their comparison
(``chip_smoke.compare_serve`` under ``HYBRID_LOGIT_TOL``).

As a test it runs the same comparison between the port on the CPU and the
JAX package at the zamba2 smoke width in bf16 (4 layers, chunk 16: the
64-token prompts run four chunks, each generated token the port's direct
one-token step against the reference's padded chunk).
"""
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_serve_reference import jax_serve_summary, port_serve_summary  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root is on the path now)

REF = chip_smoke.HYBRID_SERVE_REF


def test_hybrid_serve_check_passes_on_cpu_at_smoke_width():
    from repro.configs import smoke_config as jsmoke
    from repro_torch import convert
    from repro_torch.configs import smoke_config

    arch = chip_smoke.HYBRID["arch"]
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke(arch), dtype="bfloat16")
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, 0), REF)
    got = port_serve_summary(cfg, convert.random_lm_tree(cfg, 0), want["tokens"], ref=REF)
    bad, skipped = chip_smoke.compare_serve(got, want, chip_smoke.HYBRID_LOGIT_TOL,
                                            chip_smoke.HYBRID_MARGIN_TOL)
    assert bad == []
    assert skipped < 2 * REF["gen_tokens"]
    assert len(got["tokens"]) == REF["requests"] and len(got["tokens"][0]) == REF["gen_tokens"]
    assert [len(s) for s in got["steps"]] == [REF["gen_tokens"]] * REF["requests"]
    assert all(w["at_fed"] == w["max"] for ws in want["steps"] for w in ws)


if __name__ == "__main__":
    from repro.configs import full_config as jfull
    from repro_torch import convert
    from repro_torch.configs import full_config

    arch, n = chip_smoke.HYBRID["arch"], REF["n_layers"]
    cfg = dataclasses.replace(full_config(arch), n_layers=n)
    jcfg = dataclasses.replace(jfull(arch), n_layers=n)
    want = jax_serve_summary(jcfg, convert.random_lm_tree(cfg, chip_smoke.HYBRID["seed"]), REF)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        got = port_serve_summary(cfg, convert.random_lm_tree(cfg, chip_smoke.HYBRID["seed"]),
                                 want["tokens"], ref=REF)
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_serve(
            got, want, chip_smoke.HYBRID_LOGIT_TOL, chip_smoke.HYBRID_MARGIN_TOL)))
        print(f"max |port - JAX| {chip_smoke.serve_max_diff(got, want)!r}")
