"""The JAX package's numbers for ``chip_smoke.py``'s moe training check
(phase 18c), and a CPU run of that check.

Run as a script it records ``chip_smoke.JAX_MOE_TRAIN``: for each arch of
``chip_smoke.MOE_TRAIN_REF`` (the deepseek-v2 and deepseek-v3 smoke configs,
3 layers: 1 dense + 2 MoE, capacity factor 1.25, float32), two steps of the
JAX package's jitted ``build_train_step`` on 4 x 128 tokens of the
synthetic data from ``convert.random_lm_tree(cfg, 0)``, on the CPU (about a
minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe_train_reference.py

With ``--port`` it also runs the port on the CPU and prints its numbers and
their comparison (``chip_smoke.compare_moe_train``).

As a test it checks that the recorded numbers are the JAX package's, runs
the card's comparison with the port on the CPU (its plain versions), shows
that the comparison catches a wrong step, and checks the two tools the
card's kernels-against-plain comparison (phase 18b) rests on: the routing
imposed layer by layer (``chip_smoke.routed_as`` with a model), whose
recompute in the backward pass replays its forward's record, and the launch
counts of a step (``chip_smoke.moe_train_launches``).
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

STACKS = ("blocks.", "dense_blocks.", "moe_blocks.")


def _jax_config(arch):
    from repro.configs import smoke_config as jsmoke

    ref = chip_smoke.MOE_TRAIN_REF
    jcfg = jsmoke(arch)
    return dataclasses.replace(jcfg, dtype=ref["dtype"], moe=dataclasses.replace(
        jcfg.moe, capacity_factor=ref["capacity_factor"]))


def _leaf(tree, path):
    node = tree
    for k in path.split("."):
        node = node[k]
    a = np.asarray(node, np.float32)
    return a[0] if path.startswith(STACKS) else a


@contextlib.contextmanager
def recorded_picks():
    """While the block runs, every call of ``repro.models.moe._route`` also
    appends its picks ``(N, k)`` (numpy) to the yielded list."""
    import jax

    from repro.models import moe as MOE

    picks, orig = [], MOE._route

    def traced(p, cfg, x_flat):
        out = orig(p, cfg, x_flat)
        jax.debug.callback(lambda i: picks.append(np.asarray(i)), out[1], ordered=True)
        return out

    MOE._route = traced
    try:
        yield picks
    finally:
        MOE._route = orig


def jax_moe_train_summary(arch: str) -> dict:
    """``chip_smoke.moe_train_summary`` of MOE_TRAIN_REF's run of ``arch``
    through the JAX package, with each step's routing (``routing``: per MoE
    layer per step the picks of its forward as ``chip_smoke.picks_text``,
    which the port's run imposes)."""
    import jax
    import jax.numpy as jnp

    from repro.data import DataConfig, SyntheticLMDataset
    from repro.models import transformer as JT
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.step import build_train_step
    from repro_torch import convert

    ref, tr = chip_smoke.MOE_TRAIN_REF, chip_smoke.MOE_TRAIN
    cfg, jcfg = chip_smoke.moe_train_config(arch), _jax_config(arch)
    like = {".".join(k.key for k in p): l.dtype for p, l in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))[0]}
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, like[".".join(k.key for k in p)]),
        convert.random_lm_tree(cfg, ref["seed"]))
    opt = AdamWConfig(lr=tr["lr"])
    state = adamw_init(params, opt)
    step = jax.jit(build_train_step(jcfg, opt, total_steps=tr["total_steps"],
                                    warmup_steps=tr["warmup_steps"]))
    ds = SyntheticLMDataset(DataConfig(seed=ref["seed"], batch=ref["batch"],
                                       seq_len=ref["seq_len"], vocab_size=jcfg.vocab_size))
    records, moments, biases, expert = [], [], [], None
    n_moe = jcfg.n_layers - jcfg.moe.first_dense_layers
    routing = [[] for _ in range(n_moe)]
    for i in range(ref["steps"]):
        batch = ds.batch_at(i)
        with recorded_picks() as picks:
            JT.forward(params, jcfg, batch["tokens"])
            jax.effects_barrier()
        params, state, metrics = step(params, state, batch, jnp.asarray(i))
        # The forward's routing is the step's: its counts give the step's
        # layer-averaged expert_load.
        assert len(picks) == n_moe
        counts = sum(np.bincount(p.reshape(-1), minlength=jcfg.moe.n_experts) for p in picks)
        n_tok = batch["tokens"].size
        assert (np.rint(np.asarray(metrics["expert_load"], np.float64) * n_tok * n_moe)
                == counts).all()
        for layer, p in enumerate(picks):
            routing[layer].append(chip_smoke.picks_text(p))
        records.append(chip_smoke.moe_step_record(metrics))
        if expert is None:
            expert = int(np.argmax(np.asarray(metrics["expert_load"])))
        moments.append(chip_smoke.moe_train_samples(lambda p: _leaf(state.m, p), expert))
        if jcfg.moe.router == "sigmoid_bias":
            biases.append(np.asarray(params["moe_blocks"]["moe"]["router"]["bias"],
                                     np.float64).tolist())
    sampled = chip_smoke.moe_train_samples(lambda p: _leaf(params, p), expert)
    out = chip_smoke.moe_train_summary(records, expert, sampled, moments,
                                       biases if jcfg.moe.router == "sigmoid_bias" else None)
    out["routing"] = routing
    return out


def port_moe_train_summary(arch: str, device="cpu") -> dict:
    return chip_smoke.port_moe_train_reference(chip_smoke.moe_train_config(arch),
                                               torch.device(device), chip_smoke.JAX_MOE_TRAIN[arch])


ARCHS = chip_smoke.MOE_TRAIN_REF["archs"]
LR = chip_smoke.MOE_TRAIN["lr"]


@pytest.fixture(scope="module")
def port_runs():
    return {arch: port_moe_train_summary(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_recorded_numbers_are_the_jax_package_s(arch):
    """``chip_smoke.JAX_MOE_TRAIN`` is what the JAX package computes now:
    the same routing, and every number within ``MOE_REF_TOL`` (XLA's
    thread settings, which the tests' ``conftest.py`` changes, move the
    last bits)."""
    got, want = jax_moe_train_summary(arch), chip_smoke.JAX_MOE_TRAIN[arch]
    assert got["routing"] == want["routing"] and got["expert"] == want["expert"]
    assert chip_smoke.compare_moe_train(got, want, LR, chip_smoke.MOE_REF_TOL) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_check_passes_on_cpu(port_runs, arch):
    got, want = port_runs[arch], chip_smoke.JAX_MOE_TRAIN[arch]
    assert chip_smoke.compare_moe_train(got, want, LR, chip_smoke.MOE_REF_TOL) == []
    # The port's own routing is JAX's but at near-ties.
    assert chip_smoke.compare_moe_picks(got["routing"], chip_smoke.picks_records(want),
                                        chip_smoke.MOE_REF_TIE)[0] == []
    ref = chip_smoke.MOE_TRAIN_REF
    assert len(got["loss"]) == len(got["m"]) == ref["steps"]
    # Pairs were dropped at the published capacity factor, the sampled
    # expert received tokens, and the parameters compared are updated ones.
    assert all(d > 0 for d in want["dropped_fraction"])
    assert want["expert_load"][0][want["expert"]] > 0
    from repro_torch import convert

    cfg = chip_smoke.moe_train_config(arch)
    init = chip_smoke.moe_train_samples(
        lambda p: _leaf(convert.random_lm_tree(cfg, ref["seed"]), p), want["expert"])
    for path in ("embed.embedding", chip_smoke.MOE_EXPERT_LEAF, "moe_blocks.moe.router.kernel"):
        assert sum(a != b for a, b in zip(got["params"][path], init[path])) >= ref["steps"]
    if arch == "deepseek_v3_671b":
        assert "mtp_loss" in want and len(want["router_bias"][0]) == 2
        assert all(b != 0.0 for layer in want["router_bias"][-1] for b in layer)
    else:
        assert "mtp_loss" not in want and "router_bias" not in want


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_check_catches_a_wrong_step(port_runs, arch):
    """A loss off by a little, updates gone the wrong way, a load counted
    differently or a bias nudged the wrong way fail the comparison."""
    got, want = port_runs[arch], chip_smoke.JAX_MOE_TRAIN[arch]
    cmp = lambda g: chip_smoke.compare_moe_train(g, want, LR, chip_smoke.MOE_REF_TOL)
    assert any("loss" in b for b in cmp(dict(got, loss=[x + 1e-3 for x in got["loss"]])))
    off = dict(got, router_z=[x * 1.01 for x in got["router_z"]])
    assert any("router_z" in b for b in cmp(off))
    leaf = chip_smoke.MOE_EXPERT_LEAF
    flipped = dict(got, params=dict(got["params"], **{leaf: [-x for x in got["params"][leaf]]}))
    assert any(leaf in b for b in cmp(flipped))
    load = [list(x) for x in got["expert_load"]]
    load[1][0] += 1.0 / 512
    assert any("expert_load" in b for b in cmp(dict(got, expert_load=load)))
    if "router_bias" in got:
        wrong = [[[-b for b in layer] for layer in step] for step in got["router_bias"]]
        assert any("router bias" in b for b in cmp(dict(got, router_bias=wrong)))


def _smoke_step(arch, microbatches=1):
    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    cfg = chip_smoke.moe_train_config(arch)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    opt = AdamWConfig(lr=LR)
    step = build_train_step(cfg, opt, microbatches=microbatches, total_steps=10, warmup_steps=1)
    ds = SyntheticLMDataset(DataConfig(batch=4, seq_len=64, vocab_size=cfg.vocab_size))
    batch, params = ds.batch_at(0), dict(model.named_parameters())
    return cfg, model, lambda: step(model, adamw_init(params, opt), batch, 0)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_routed_as_replays_the_forward_record_in_the_recompute(microbatches, request):
    """With remat the recompute calls ``moe.route`` again from the backward
    pass.  ``capture_routing`` records one call a MoE layer and forward
    pass; ``routed_as(records, model)`` imposes them layer by layer, the
    recompute replaying its forward's record: a step run on its own
    captured routing gives the same bits as the free run."""
    from repro_torch.models import moe as MOE

    arch = "deepseek_v3_671b"
    cfg, model, run = _smoke_step(arch, microbatches)
    # One thread: with several, the CPU's embedding backward sums its rows
    # in an order that varies from run to run.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    calls = []
    orig = MOE.route
    with chip_smoke.capture_routing(model) as rec:
        MOE.route = lambda *a: calls.append(1) or orig(*a)
        try:
            _, _, free = run()
        finally:
            MOE.route = orig
    n_moe = len(model.moe_blocks)
    assert [len(r) for r in rec] == [microbatches] * n_moe
    assert len(calls) == 2 * n_moe * microbatches  # forward and recompute
    free_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    with chip_smoke.routed_as(rec, model):
        _, _, imposed = run()
    assert all(torch.equal(free[k], imposed[k]) for k in free)
    assert all(torch.equal(p, free_params[n]) for n, p in model.named_parameters())
    # Records of another layer count, or too few, raise.
    with pytest.raises(SystemExit, match="routed_as"):
        with chip_smoke.routed_as(rec[:1], model):
            pass
    with pytest.raises(SystemExit, match="ran out"):
        with chip_smoke.routed_as([r[:microbatches - 1] for r in rec], model):
            run()


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_counts_of_a_step(monkeypatch, arch):
    """``moe_train_launches`` counts the calls a step makes of the plain
    versions that the kernels replace on the card: the flash forward (and,
    with it, one backward a call recorded for the gradient) and rmsnorm."""
    from repro_torch.kernels import ref as tref

    seen = {"rmsnorm": 0, "attention": 0}
    plain = {k: getattr(tref, k) for k in seen}

    def spy(name):
        def run(*a, **kw):
            seen[name] += 1
            return plain[name](*a, **kw)
        return run

    for k in seen:
        monkeypatch.setattr(tref, k, spy(k))
    cfg, _, run = _smoke_step(arch)
    run()
    want = chip_smoke.moe_train_launches(cfg)
    assert seen == {"rmsnorm": want["rmsnorm"], "attention": want["flash_attention_fwd"]}
    recorded = cfg.n_layers + cfg.mtp_depth  # first runs of the blocks that keep a graph
    assert want["flash_attention_bwd_dkv"] == want["flash_attention_bwd_dq"] == recorded


if __name__ == "__main__":
    want = {arch: jax_moe_train_summary(arch) for arch in ARCHS}
    print(json.dumps(want))
    if "--port" in sys.argv[1:]:
        for arch in ARCHS:
            chip_smoke.JAX_MOE_TRAIN = want
            got = port_moe_train_summary(arch)
            print(f"{arch} port on the CPU: " + json.dumps(got))
            print(f"{arch} differences: " + json.dumps(chip_smoke.compare_moe_train(
                got, want[arch], LR, chip_smoke.MOE_REF_TOL)))
            print(f"{arch} largest differences: " + json.dumps(chip_smoke.moe_train_max_diff(
                got, want[arch], LR, chip_smoke.MOE_REF_TOL)))
