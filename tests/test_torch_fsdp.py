"""FSDP training on the spec rules' layout (``repro_torch.sharding.fsdp``) on
the CPU: gloo worlds of 2 and 1 ranks (``_torch_dist_worker.py ... fsdp``,
one process a rank, spawned once for the module) and the JAX package's own
sharded step on two forced host devices (``_jax_fsdp_reference.py``, a
subprocess that sets ``XLA_FLAGS`` before importing jax), started together.

* **Shards against the rules.**  For the ``dense``, ``ssm``, ``hybrid`` and
  ``audio`` smoke configs at data 2 and 4 (in this process, through the
  rules on an axis-size mapping) and on the two ranks (``shard_model``):
  every shard is ``full.chunk(n, dim)[rank]`` of the dim ``param_specs``
  gives to ``"data"``, and a leaf whose spec names no ``"data"`` dim is
  whole.
* **A world of one** is bit for bit the unsharded step: each family at
  ``microbatches`` 1, and 2 with ``gather_small_weights_once``, two steps:
  every metric, parameter and moment.
* **Two ranks against one process**, the same runs with labels set to -100
  so that the ranks' valid counts differ in every microbatch (the loss
  divides by the global count).  Tolerances, float32 smoke configs: the
  ranks' partial sums reassociate the one-process sums (the loss, the
  reduce-scattered gradients, the norm's squares), a few float32 ulps of
  each; so the loss, ``lm_loss`` and ``grad_norm`` to 1e-5 relative and
  ``tokens`` exactly, and the parameters by ``test_torch_train``'s rule
  for the port against JAX (AdamW's ``m / (sqrt(v) + eps)`` turns such
  noise into up to ``lr`` of an element where its gradient is within the
  noise of ``eps``): at least 99.9 % of each shard within 1e-5 of the
  leaf's scale plus 1e-7, every element within ``2 lr`` a step.  The
  first moments, ``0.1 g`` after clipping, to 1e-5 of the leaf's scale
  plus 1e-9.  Measured: losses 1.5e-7 and norms 1.2e-7 relative; the
  parameters' worst element 4.2e-5 of its leaf's scale (inside the 2 lr
  bound), the moments' 9.5e-6 (zamba2's ``a_log``, whose gradient is a
  cancelling sum, 4.6e-10 absolute).
* **Replicated leaves** (norm scales, biases, conv, the RWKV vectors) are
  bit for bit equal across the ranks, parameters and moments; the same
  step with the replicated gradients' all-reduce left out makes them
  differ, which this check catches.
* **Against JAX**: the reference's ``build_train_step(microbatches=2,
  gather_small_weights_once=True)`` jitted with ``param_specs``
  shardings on two host devices against the port's two gloo ranks
  (``FSDP_REF``: llama smoke, two steps), loss, ``grad_norm`` and every
  parameter within ``test_torch_train``'s tolerance of the one-process
  port against JAX (above); measured: losses 7.7e-8, norms 2.0e-7
  relative.
* **Checkpoints**: saved by 2 ranks and restored into one process, saved
  by one process and restored into 2 ranks, and restored into 2 ranks
  again, each bit for bit; a step from the restored state bit for bit the
  step without the restore.  ``train(mesh=)`` with checkpoints and
  ``resume`` (llama, and whisper with its frames).
* **Refusals** (``ValueError``): the ssm family on a ``"model"`` axis of 2
  (tensor parallelism runs the dense and vlm families, ``test_torch_tp``),
  a ``"pod"`` axis (also for the gather-once weight), the moe family (the
  model and ``train``), a batch that does not divide the data axis
  (``shard_batch`` and the step), serving a sharded ssm model.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, sharding
from repro_torch.configs import smoke_config
from repro_torch.sharding import fsdp

sys.path[:0] = [str(Path(__file__).resolve().parent)]
from _torch_dist_worker import (  # noqa: E402
    FSDP_ARCHS, FSDP_LOOP_ARCHS, FSDP_REF, FSDP_RUN, FSDP_STEPS,
)

WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
JAX_REF = Path(__file__).resolve().parent / "_jax_fsdp_reference.py"
WORLDS = (2, 1)
JOIN_S = 120.0
CONFIGS = [f"mb{mb}{'once' if once else ''}" for mb, once in FSDP_STEPS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """``{world: [rank 0's results, ...], "jax": the reference's run}``:
    both worlds and the JAX subprocess started at once."""
    root = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src")] + env.get("PYTHONPATH", "").split(
            os.pathsep))
    procs = []
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        for r in range(world):
            log = open(d / f"rank{r}.log", "w")
            procs.append((f"rank {r} of {world}", log, d / f"rank{r}.log", subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world), str(d / "store"), str(d),
                 "fsdp"], stdout=log, stderr=subprocess.STDOUT, env=env)))
    log = open(root / "jax.log", "w")
    procs.append(("the JAX reference", log, root / "jax.log", subprocess.Popen(
        [sys.executable, str(JAX_REF), str(root / "jax.npz")], stdout=log,
        stderr=subprocess.STDOUT, env=env)))
    deadline = time.monotonic() + JOIN_S
    try:
        for what, _, _, p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{what} did not finish in {JOIN_S} s")
    finally:
        for _, log, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(what, path) for what, _, path, p in procs if p.returncode != 0]
    if bad:
        pytest.fail(f"failed: {[w for w, _ in bad]}\n{bad[0][1].read_text()[-3000:]}")
    out = {w: [torch.load(root / f"world{w}" / f"rank{r}.pt", weights_only=False)
               for r in range(w)] for w in WORLDS}
    with np.load(root / "jax.npz") as z:
        out["jax"] = {k: z[k] for k in z.files}
    return out


def _prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_params_close(got: torch.Tensor, want: torch.Tensor, lr: float, steps: int,
                         what: str) -> None:
    """``test_torch_train``'s rule: 99.9 % within 1e-5 of the leaf's scale
    plus 1e-7, every element within 2 lr a step."""
    g, w = got.double().numpy(), want.double().numpy()
    if not w.size:
        return
    err = np.abs(g - w)
    tight = err <= 1e-5 * float(np.max(np.abs(w))) + 1e-7
    assert tight.mean() >= 0.999, (what, tight.mean())
    assert err.max() <= 2 * lr * steps, (what, err.max())


# ------------------------------------------------------- shards and rules --


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_shards_follow_the_rules(arch, n):
    """``data_dims`` is the dim ``param_specs`` names ``"data"``; the
    ranks' ``local_shard``s are ``chunk(n, dim)`` and tile the leaf; the
    replicated leaves are exactly those whose spec names no data dim, and
    every 1-D leaf is one."""
    cfg = smoke_config(arch)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    params = dict(model.named_parameters())
    sizes = {"data": n, "model": 1}
    specs = sharding.param_specs(params, sizes)
    dims = fsdp.data_dims(params, sizes)
    assert dims.keys() == params.keys()
    n_sharded = 0
    for name, p in params.items():
        dim = dims[name]
        named = [d for d, s in enumerate(specs[name]) if s == "data"]
        assert (dim is None and not named) or named == [dim], (name, specs[name])
        shards = [fsdp.local_shard(p, dim, n, r) for r in range(n)]
        if dim is None:
            assert all(s is p for s in shards), name
            continue
        n_sharded += 1
        assert p.ndim >= 2 and p.shape[dim] % n == 0, name
        for r, s in enumerate(shards):
            assert torch.equal(s, p.chunk(n, dim)[r]), (name, r)
            assert s.shape[dim] == p.shape[dim] // n
        assert torch.equal(torch.cat(shards, dim), p), name
    assert dims["embed.embedding"] == 1 and n_sharded > len(params) // 3, (arch, n_sharded)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_shard_model_on_two_ranks(runs, arch):
    """Each rank's parameters after ``shard_model`` are its chunk of the
    full leaf along the rules' data dim at data 2; replicated leaves whole."""
    full = _prefixed(runs[2][0], f"shards/{arch}/full/")
    want_dims = fsdp.data_dims(full, {"data": 2, "model": 1})
    for r, out in enumerate(runs[2]):
        got = _prefixed(out, f"shards/{arch}/param/")
        dims = _prefixed(out, f"shards/{arch}/dim/")
        assert got.keys() == full.keys()
        for name, t in got.items():
            dim = want_dims[name]
            assert int(dims[name]) == (-1 if dim is None else dim), name
            want = full[name] if dim is None else full[name].chunk(2, dim)[r]
            assert torch.equal(t, want), (arch, r, name)


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 1},
                                   {"campus": 2, "data": 1}, {"model": 1}])
def test_fsdp_mesh_refusals(sizes):
    """The meshes the ssm smoke config does not train on: a ``"model"`` axis
    past its 2 RWKV heads (ROADMAP 9b.7c), a ``"pod"`` axis (9b.8), none
    without a data axis."""
    with pytest.raises(ValueError, match="9b|data axis"):
        sharding.check_mesh_family(sizes, smoke_config("rwkv6_7b"))


# ---------------------------------------------------------------- steps --


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_world_of_one_is_the_unsharded_step_bit_for_bit(runs, arch, config):
    out = runs[1][0]
    tag = f"steps/{arch}/{config}"
    got, want = _prefixed(out, tag + "/"), _prefixed(out, tag + "/ref/")
    got = {k: v for k, v in got.items() if not k.startswith("ref/")}
    assert got.keys() == want.keys()
    bad = [k for k in want if not k.startswith("dim/") and not torch.equal(got[k], want[k])]
    assert not bad, bad[:8]


@pytest.mark.parametrize("rank", range(2))
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_two_ranks_match_one_process(runs, arch, config, rank):
    tag = f"steps/{arch}/{config}"
    got, want = _prefixed(runs[2][rank], tag + "/"), _prefixed(runs[2][0], tag + "/ref/")
    for k in ("loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)
    assert torch.equal(got["tokens"], want["tokens"])
    for key, w in want.items():
        kind, _, name = key.partition("/")
        if kind not in ("param", "m"):
            continue
        dim = int(got["dim/" + name])
        w = w if dim < 0 else w.chunk(2, dim)[rank]
        if kind == "param":
            _assert_params_close(got[key], w, FSDP_RUN["lr"], FSDP_RUN["steps"], key)
        else:
            scale = float(w.abs().max()) if w.numel() else 0.0
            torch.testing.assert_close(got[key], w, rtol=0, atol=1e-5 * scale + 1e-9,
                                       msg=key)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_ranks_agree_on_metrics_and_replicated_leaves(runs, arch, config):
    """Every rank reports the global metrics, the same bits; every
    replicated leaf and its moments are equal across the ranks, bit for
    bit."""
    tag = f"steps/{arch}/{config}/"
    a, b = (_prefixed(o, tag) for o in runs[2])
    for k in ("loss", "lm_loss", "grad_norm", "tokens"):
        assert torch.equal(a[k], b[k]), k
    repl = [k.partition("/")[2] for k, v in a.items() if k.startswith("dim/") and int(v) < 0]
    assert repl, arch
    bad = [f"{kind}/{n}" for n in repl for kind in ("param", "m", "v")
           if not torch.equal(a[f"{kind}/{n}"], b[f"{kind}/{n}"])]
    assert not bad, bad[:8]


def test_replicated_check_catches_a_missing_all_reduce(runs):
    """Without the all-reduce of the replicated leaves' gradients the ranks'
    copies drift apart after one step: the equality above would fail."""
    a, b = (_prefixed(o, "control/param/") for o in runs[2])
    assert a and a.keys() == b.keys()
    differ = [n for n in a if a[n].numel() and not torch.equal(a[n], b[n])]
    assert len(differ) >= len([n for n in a if a[n].numel()]) // 2, differ


@pytest.mark.parametrize("rank", range(2))
def test_two_ranks_match_the_jax_sharded_step(runs, rank):
    """The port's two gloo ranks against the reference's own sharded step
    on two host devices (``FSDP_REF``: ``microbatches=2``,
    ``gather_small_weights_once=True``, two steps)."""
    jax, got = runs["jax"], _prefixed(runs[2][rank], "jax/")
    assert str(jax["embed_sharding"]) == "PartitionSpec('model', 'data')"
    np.testing.assert_allclose(got["loss"].numpy(), jax["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].numpy(), jax["grad_norm"], rtol=1e-5)
    cfg = smoke_config(FSDP_REF["arch"])
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(got["param/" + name])
    want = {k[len("param/"):]: v for k, v in jax.items() if k.startswith("param/")}
    mine = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                mine[prefix + k] = v

    flat(convert.lm_params_to_numpy(model))
    assert mine.keys() == want.keys()
    for k in want:
        _assert_params_close(torch.from_numpy(np.asarray(mine[k], np.float32)),
                             torch.from_numpy(want[k]), FSDP_REF["lr"], FSDP_REF["steps"], k)


# ---------------------------------------------------------- checkpoints --


@pytest.mark.parametrize("case", ["2to1", "1to2", "2to2", "resume"])
def test_checkpoints_reshard_bit_for_bit(runs, case):
    for r, out in enumerate(runs[2]):
        if f"ckpt/{case}/bad" not in out:
            assert case == "2to1" and r == 1  # one process restores it: rank 0
            continue
        assert out[f"ckpt/{case}/bad"] == [], (r, out[f"ckpt/{case}/bad"][:8])
    leaves = runs[2][0].get(f"ckpt/{case}/leaves")
    if leaves is not None:  # every parameter, both moments and the step
        assert leaves == 3 * len(_prefixed(runs[2][0], "shards/llama3_2_1b/param/")) + 1


@pytest.mark.parametrize("arch", FSDP_LOOP_ARCHS)
def test_train_loop_with_a_mesh(runs, arch):
    """``train(mesh=)``: the losses of one process (float32 reassociation;
    whisper's global frames split with the batch), the scheduled and final
    checkpoints from rank 0, and a resume from them on both ranks."""
    tag = f"loop/{arch}"
    ref = runs[2][0][f"{tag}/ref_loss"]
    for out in runs[2]:
        np.testing.assert_allclose(out[f"{tag}/loss"].numpy(), ref.numpy(), rtol=1e-5)
        assert out[f"{tag}/steps"].tolist() == [2]
        assert out[f"{tag}/resumed_steps"].tolist() == [3]


ERRORS = {"model_axis": "9b", "pod_axis": "9b", "moe": "9b", "moe_train": "9b",
          "batch": "does not split", "batch_step": "does not split", "decode": "9b.9",
          "gathered_weight_tp": "9b"}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_refusals(runs, name):
    for out in runs[2]:
        msg = out[f"error/{name}"]
        assert msg.startswith("ValueError") and ERRORS[name] in msg, msg
