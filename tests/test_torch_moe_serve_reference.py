"""The JAX package's numbers for ``chip_smoke.py``'s deepseek-v2 serving
check (phase 17b), and a CPU check of the script's moe comparison at a
reduced size.

Run as a script it records ``chip_smoke.JAX_MOE_SERVE``: deepseek-v2-236b
at full width cut to 2 layers (1 dense + 1 MoE; bf16, 5.36 B parameters
from ``convert.random_lm_leaves(cfg, 0)``, each leaf cast to bf16 as it is
drawn, so the float32 tree is never whole) through the JAX package on the
CPU: ``chip_smoke.MOE_SERVE_REF`` (2 prompts x 64 tokens: the prefill
step's rows, 8 greedy tokens of ``ServeEngine.generate``, the decode step's
logits at each of them with those tokens fed back), the MoE layer's routing
in the prefill step, in each decode call and in ``forward``, and
``forward``'s expert load and dropped fraction (~4 min on the CPU, ~29 GB
of memory at the peak):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe_serve_reference.py

The routing is read from the JAX package's own ``_route`` by wrapping it
(at run time, before anything is traced) with a ``jax.debug.callback``
that passes its indices and selection scores to
``chip_smoke.routing_record``; the recorded logits come from the same run.

As a test it runs the same comparison (``chip_smoke.compare_moe_serve``:
the port's logits on JAX's routing, imposed by ``chip_smoke.routed_as``,
and the two routings compared apart) between the port on the CPU and the
JAX package at the deepseek-v2 smoke width, cut to 2 layers, in bf16, with
the published capacity factor 1.25 so that pairs are dropped; and checks
``routed_as`` and ``compare_routing`` themselves.
"""
import contextlib
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


@contextlib.contextmanager
def recorded_routes():
    """While the block runs, every call of ``repro.models.moe._route`` also
    appends its ``chip_smoke.routing_record`` to the yielded list."""
    import jax

    from repro.models import moe as MOE

    calls, orig = [], MOE._route

    def traced(p, cfg, x_flat):
        w, idx, scores, logits = orig(p, cfg, x_flat)
        sel = scores + p["router"]["bias"][None, :] if cfg.moe.router == "sigmoid_bias" else scores
        jax.debug.callback(lambda i, s, r: calls.append(chip_smoke.routing_record(i, s, r)),
                           idx, sel, scores, ordered=True)
        return w, idx, scores, logits

    MOE._route = traced
    try:
        yield calls
    finally:
        MOE._route = orig


def jax_params_from_leaves(leaves, jcfg):
    """The JAX parameter tree of ``(path, numpy leaf)`` pairs, each leaf
    cast to the type the JAX package's ``init`` gives it as it comes."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    like = {".".join(k.key for k in p): l.dtype for p, l in
            jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))[0]}
    tree: dict = {}
    for path, a in leaves:
        *heads, leaf = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(a, like[path])
        del a
    return tree


def jax_moe_serve_summary(jcfg, params, ref=chip_smoke.MOE_SERVE_REF) -> dict:
    """``ref`` through the JAX package on the CPU (a config with one MoE
    layer): the numbers ``chip_smoke.port_moe_serve_reference`` gives for
    the port."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    from repro.serve import ServeEngine, build_decode_step, build_prefill_step

    assert jcfg.n_layers - jcfg.moe.first_dense_layers == 1
    t0, n = ref["prompt_len"], ref["gen_tokens"]
    prompts = jnp.asarray(chip_smoke.serve_prompts(jcfg.vocab_size, ref["requests"], t0,
                                                   ref["prompt_seed"]))
    with recorded_routes() as calls:
        logits, _ = build_prefill_step(jcfg)(params, prompts, t0 + n)
        jax.effects_barrier()
        pre = list(calls)
        out = ServeEngine(jcfg, params, max_len=t0 + n).generate(prompts, n)
        jax.effects_barrier()
        calls.clear()
        # ServeEngine.generate's loop with its own tokens fed back.
        decode = jax.jit(build_decode_step(jcfg))
        state = JT.init_decode_state(jcfg, ref["requests"], t0 + n)
        step, state = decode(params, prompts, state, jnp.asarray(0, jnp.int32))
        steps = [step[:, -1]]
        for i in range(n - 1):
            step, state = decode(params, out[:, t0 + i:t0 + i + 1], state,
                                 jnp.asarray(t0 + i, jnp.int32))
            steps.append(step[:, -1])
        jax.effects_barrier()
        dec = list(calls)
        calls.clear()
        fo = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(params, prompts)
        jax.effects_barrier()
        fwd = list(calls)
    assert len(pre) == 1 and len(dec) == n and len(fwd) == 1
    steps = np.stack([np.asarray(s.astype(jnp.float32)) for s in steps], axis=1)
    assert (steps.argmax(-1) == np.asarray(out)[:, t0:]).all()
    summary = chip_smoke.serve_summary(np.asarray(logits.astype(jnp.float32)), np.asarray(out),
                                       steps, np.asarray(out)[:, t0:], ref)
    summary["routing"] = {"prefill": pre[0], "decode": dec, "forward": fwd[0]}
    summary["aux"] = chip_smoke.moe_aux_summary(
        {k: np.asarray(fo.aux_losses[k]) for k in ("expert_load", "dropped_fraction")},
        prompts.size)
    return summary


def test_moe_serve_check_passes_on_cpu_at_smoke_width():
    from repro.configs import smoke_config as jsmoke
    from repro_torch import convert
    from repro_torch.configs import smoke_config

    cut = lambda c: dataclasses.replace(c, n_layers=2, dtype="bfloat16",
                                        moe=dataclasses.replace(c.moe, capacity_factor=1.25))
    cfg, jcfg = cut(smoke_config("deepseek_v2_236b")), cut(jsmoke("deepseek_v2_236b"))
    want = jax_moe_serve_summary(jcfg, jax_params_from_leaves(convert.random_lm_leaves(cfg, 0),
                                                              jcfg))
    model = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg, 0), cfg, device="cpu")
    got = chip_smoke.port_moe_serve_reference(model, cfg, torch.device("cpu"), want)
    bad, info = chip_smoke.compare_moe_serve(got, want, cfg)
    assert bad == [], info
    # 128 tokens top-2 of 8 experts at 40 slots an expert: pairs are dropped,
    # exactly as JAX drops them.
    assert want["aux"]["dropped_fraction"] > 0
    assert got["aux"] == want["aux"] or info["flipped_forward"] > 0
    assert info["skipped"] < 2 * chip_smoke.MOE_SERVE_REF["gen_tokens"]
    assert [len(c["picks"]) for c in got["routing"]["decode"]] == [128] + [2] * 7
    assert len(got["routing"]["forward"]["picks"]) == len(got["routing"]["prefill"]["picks"]) == 128
    assert all(w["at_fed"] == w["max"] for ws in want["steps"] for w in ws)


def test_routed_as_imposes_another_runs_picks():
    """``routed_as`` makes the port pick a recorded routing (here the
    reverse of its own order of experts, and then its own), and
    ``compare_routing`` tells a flip within the tie margin from one past
    it, and traces a cascade of kept flags."""
    import dataclasses as dc

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    c = smoke_config("deepseek_v3_671b")
    cfg = dc.replace(c, n_layers=2, moe=dc.replace(c.moe, capacity_factor=1.0))
    model = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg, 1), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 24)))
    with chip_smoke.capture_routing(model) as own, torch.inference_mode():
        want = T.forward(model, tok).logits
    rec = own[0][0]
    with chip_smoke.routed_as([rec]), torch.inference_mode():
        assert torch.equal(T.forward(model, tok).logits, want)
    other = dict(rec, picks=[[7 - e for e in p] for p in rec["picks"]])
    with chip_smoke.capture_routing(model) as seen, chip_smoke.routed_as([other]), \
            torch.inference_mode():
        moved = T.forward(model, tok).logits
    assert not torch.equal(moved, want) and seen[0][0]["picks"] == rec["picks"]
    with pytest.raises(SystemExit, match="routed_as"), torch.inference_mode(), \
            chip_smoke.routed_as([rec, rec]):
        T.forward(model, tok)
    # One token's pick swapped: within the margin a flip (and the later
    # tokens of its group at the two experts may cascade), past it a failure.
    k, e = cfg.moe.experts_per_token, cfg.moe.n_experts
    i = 3
    swap = next(x for x in range(e) if x not in rec["picks"][i])
    flipped = [list(p) for p in rec["picks"]]
    flipped[i][-1] = swap
    near = dict(rec, picks=flipped, margin=[0.0 if j == i else m for j, m in enumerate(rec["margin"])])
    r = chip_smoke.compare_routing([near], [rec], cfg, tie=0.05)
    assert r["bad"] == [] and r["flipped"] == 1 and i in r["affected"][0]
    assert r["touched"][0] == {swap, rec["picks"][i][-1]} and r["moved_pairs"] == [1]
    assert all(j > i for j in r["affected"][0] - {i})
    far = dict(near, margin=[1.0] * len(rec["margin"]))
    assert chip_smoke.compare_routing([far], [dict(rec, margin=[1.0] * len(rec["margin"]))],
                                      cfg, tie=0.05)["bad"]


if __name__ == "__main__":
    from repro.configs import full_config as jfull
    from repro_torch import convert

    spec = chip_smoke.MOE_V2
    cfg = chip_smoke.moe_config(spec)
    jcfg = dataclasses.replace(jfull(spec["arch"]), n_layers=spec["n_layers"])
    params = jax_params_from_leaves(convert.random_lm_leaves(cfg, spec["seed"]), jcfg)
    want = jax_moe_serve_summary(jcfg, params)
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        del params
        model = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg, spec["seed"]), cfg,
                                              device="cpu")
        got = chip_smoke.port_moe_serve_reference(model, cfg, torch.device("cpu"), want)
        print("port on the CPU: " + json.dumps(got))
        print("differences: " + json.dumps(chip_smoke.compare_moe_serve(got, want, cfg)))
        print(f"max |port - JAX| {chip_smoke.serve_max_diff(got, want)!r}")
