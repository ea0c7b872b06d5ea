"""Tensor parallelism on the spec rules' ``"model"`` axis
(``repro_torch.sharding.tp``) for the ``dense`` and ``vlm`` families, on the
CPU: gloo worlds of 2 and 4 ranks (``_torch_dist_worker.py ... tp``, one
process a rank) on ``("data", "model")`` meshes of (1, 2), (2, 2) and
(1, 4), and the JAX package's own (1, 2) step on two forced host devices
(``_jax_tp_reference.py``, a subprocess that sets ``XLA_FLAGS`` before
importing jax), all started together.  The smoke configs of llama3.2-1b
(tied readout, 4 / 2 heads), chatglm3-6b (qkv bias, rope fraction 0.5,
untied) and chameleon-34b (vlm: qk-norm, untied), float32.  At (1, 4) the
2 KV heads do not divide the axis: each rank gathers ``wk`` / ``wv``
whole over ``"model"`` and keeps the KV head its query heads read.

* **Shards against the rules**: every rank's parameter is the full
  leaf's chunk along the dims ``param_specs`` gives to ``"model"`` and
  ``"data"``, bit for bit.
* **Against one process** (the same weights and batches, unsharded), each
  tolerance float32 reassociation: the ranks' partial products and sums
  (the row-parallel sums, the vocab-parallel ``logsumexp``, the global
  norm) reassociate the one-process sums.
  - Training, three steps (labels set to -100 so that the data ranks'
    valid counts differ): loss, ``lm_loss`` and ``grad_norm`` to 1e-5
    relative, ``tokens`` exactly; the parameters by ``test_torch_train``'s
    rule (AdamW's ``m / (sqrt(v) + eps)`` turns gradient noise into up to
    ``lr`` an element): at least 99.9 % of each leaf within 1e-5 of its
    scale plus 1e-7 and every element within ``2 lr`` a step, except the
    ``wk`` bias, whose elements that RoPE does not rotate have a gradient
    of exactly zero in exact arithmetic (a query's logits all shift by
    ``q . b``, which the softmax cancels): there only the ``2 lr`` bound
    holds.  The first moments to 1e-4 of the leaf's scale plus 1e-9.
  - Serving: the prefill's logits and three teacher-forced decode steps'
    to 2e-5 absolute (logits of |l| < 5; measured 4.3e-6), the caches'
    shape (this rank's rows and KV heads), and greedy generation token for
    token.
* **Against the JAX package's sharded step**: the reference's
  ``build_train_step`` jitted with ``param_specs`` shardings on
  ``make_host_mesh(model_parallel=2)`` (GSPMD inserting every collective)
  against the port's two gloo ranks: losses and norms to 1e-5 relative,
  the parameters by the rule above, the prefill and decode logits of
  ``T.decode_step`` jitted with ``decode_state_specs`` to 2e-5.
* **The two kinds of model-replicated gradient**: a leaf read on
  replicated rows (the ``ln1`` / ``ln2`` / ``ln_f`` scales) has the same
  gradient bits on every rank of the axis and is not summed over it; a
  leaf read on a rank's own heads (the q/k/v biases, the qk-norm scales)
  holds that rank's part, and ``reduce_grads`` sums the parts into the
  one-process gradient.
* **Checkpoints**: saved on (1, 2) and restored on (2, 1), (1, 1) (one
  process) and (2, 2), every parameter, moment and the step bit for bit.
* ``train(mesh=)``, ``make_host_mesh(model_parallel=)`` and every
  refusal (``ValueError`` naming its ROADMAP.md item).  The ``ssm``,
  ``hybrid`` and ``audio`` families are ``test_torch_tp_families.py``'s.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, sharding
from repro_torch.configs import full_config, smoke_config
from repro_torch.sharding import fsdp

sys.path[:0] = [str(Path(__file__).resolve().parent)]
from _torch_dist_worker import TP_ARCHS, TP_RUN  # noqa: E402

WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
JAX_REF = Path(__file__).resolve().parent / "_jax_tp_reference.py"
WORLDS = (2, 4)
JOIN_S = 150.0
# The meshes each world runs: (tag, world, (data, model)).
MESHES = (("mesh12", 2, (1, 2)), ("mesh22", 4, (2, 2)), ("mesh14", 4, (1, 4)))
LOGIT_TOL = 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """``{world: [rank 0's results, ...], "jax": the reference's run}``:
    both worlds and the JAX subprocess started at once."""
    root = tmp_path_factory.mktemp("tp")
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
                 "tp"], stdout=log, stderr=subprocess.STDOUT, env=env)))
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
    """The rule of the module's docstring: 99.9 % within 1e-5 of the leaf's
    scale plus 1e-7 (not for the ``wk`` bias), every element within 2 lr a
    step."""
    g, w = got.double().numpy(), want.double().numpy()
    if not w.size:
        return
    err = np.abs(g - w)
    if not what.endswith("attn.wk.bias"):
        tight = err <= 1e-5 * float(np.max(np.abs(w))) + 1e-7
        assert tight.mean() >= 0.999, (what, tight.mean())
    assert err.max() <= 2 * lr * steps, (what, err.max())


def _full_params(arch) -> dict:
    cfg = smoke_config(arch)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


RANKS = [(tag, world, shape, r) for tag, world, shape in MESHES for r in range(world)]
RANK_IDS = [f"{tag}-rank{r}" for tag, _, _, r in RANKS]


# ------------------------------------------------------- shards and rules --


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("tag,world,shape,rank", RANKS, ids=RANK_IDS)
def test_shards_follow_the_rules(runs, arch, tag, world, shape, rank):
    """Each parameter after ``shard_model`` is the full leaf's chunk along
    the dims ``param_specs`` gives to ``"model"`` and ``"data"`` (by the
    rank's mesh coordinates), bit for bit."""
    out = runs[world][rank]
    d_rank, m_rank = out[f"{tag}/coords"].tolist()
    full = _full_params(arch)
    specs = sharding.param_specs(full, {"data": shape[0], "model": shape[1]})
    shards = _prefixed(out, f"{tag}/{arch}/shard/")
    assert shards.keys() == full.keys()
    split = 0
    for name, t in shards.items():
        want = full[name]
        dims = out[f"{tag}/{arch}/dims/{name}"].tolist()
        assert dims == [-1 if d is None else d for d in (fsdp.data_dim(specs[name]),
                                                         fsdp.model_dim(specs[name]))], name
        if dims[1] >= 0:
            want, split = want.chunk(shape[1], dims[1])[m_rank], split + 1
        if dims[0] >= 0:
            want = want.chunk(shape[0], dims[0])[d_rank]
        assert torch.equal(t, want), (name, dims)
    assert split >= 2 + 6 * smoke_config(arch).n_layers, split


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "chatglm3_6b", "chameleon_34b",
                                  "stablelm_12b"])
def test_mesh_family_admits_dense_and_vlm(arch, m):
    """The full configs of the dense and vlm families run a model axis of
    2, 4 and 16 (the production mesh's); at 16 llama's 8 KV heads and
    chatglm3's 2 do not divide it (the gathered-KV route)."""
    cfg = full_config(arch)
    sizes = {"data": 256 // m, "model": m}
    assert sharding.check_mesh_family(sizes, cfg) is sizes


# ssm, hybrid and audio: their smoke configs' 2 RWKV heads, 4 shared-block
# heads and 4 heads past the axis (their admitted meshes are
# test_torch_tp_families.py's).
REFUSALS = {
    "ssm": ("rwkv6_7b", {"data": 1, "model": 4}, "9b.7c"),
    "hybrid": ("zamba2_2_7b", {"data": 2, "model": 8}, "9b.7c"),
    "audio": ("whisper_large_v3", {"data": 1, "model": 8}, "9b.7c"),
    "moe": ("deepseek_v3_671b", {"data": 1, "model": 2}, "9b.9"),
    "heads": ("llama3_2_1b", {"data": 1, "model": 8}, "9b.7"),
    "kv_heads": (dict(n_heads=6, n_kv_heads=3), {"data": 1, "model": 2}, "9b.7"),
    "d_ff": (dict(d_ff=250), {"data": 1, "model": 4}, "9b.7"),
    "vocab": (dict(vocab_size=510, pad_vocab_multiple=2), {"data": 1, "model": 4}, "9b.7"),
    "pod": ("llama3_2_1b", {"pod": 2, "data": 1, "model": 2}, "9b.8"),
    "no_data": ("llama3_2_1b", {"model": 2}, "data axis"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_mesh_family_refusals(name):
    arch, sizes, item = REFUSALS[name]
    cfg = smoke_config(arch) if isinstance(arch, str) else dataclasses.replace(
        smoke_config("llama3_2_1b"), **arch)
    with pytest.raises(ValueError, match=item.replace(".", r"\.")):
        sharding.check_mesh_family(sizes, cfg)


ERRORS = ("shard_ssm", "train_ssm", "serve_ssm")


@pytest.mark.parametrize("name", ERRORS)
def test_refusals_on_a_real_mesh(runs, name):
    """An ssm model of 3 RWKV heads placed on, trained on and served on a
    (1, 2) mesh."""
    for out in runs[2]:
        msg = out[f"error/{name}"]
        assert msg.startswith("ValueError") and "9b.7c" in msg, msg


# ---------------------------------------------------------------- steps --


def _check_train(got: dict, want: dict, what: str) -> None:
    for k in ("loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)
    assert torch.equal(got["tokens"], want["tokens"])
    for key, w in want.items():
        kind, _, name = key.partition("/")
        if kind == "params":
            _assert_params_close(got[key], w, TP_RUN["lr"], TP_RUN["steps"], f"{what} {name}")
        elif kind == "m":
            scale = float(w.abs().max()) if w.numel() else 0.0
            torch.testing.assert_close(got[key], w, rtol=0, atol=1e-4 * scale + 1e-9,
                                       msg=f"{what} {key}")


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("tag,world,shape,rank", RANKS, ids=RANK_IDS)
def test_train_matches_one_process(runs, arch, tag, world, shape, rank):
    out = runs[world][rank]
    prefix = f"{tag}/{arch}/train/"
    got = {k: v for k, v in _prefixed(out, prefix).items() if not k.startswith("ref/")}
    _check_train(got, _prefixed(out, prefix + "ref/"), f"{tag} {arch}")


@pytest.mark.parametrize("rank", range(4))
def test_train_microbatches_gathered_once(runs, rank):
    """(2, 2), two microbatches with ``gather_small_weights_once``: the
    held leaves keep their ``"model"`` chunk."""
    out = runs[4][rank]
    got = {k: v for k, v in _prefixed(out, "mesh22/once/").items() if not k.startswith("ref/")}
    _check_train(got, _prefixed(out, "mesh22/once/ref/"), "once")


@pytest.mark.parametrize("tag,world", [(t, w) for t, w, _ in MESHES])
def test_ranks_agree_on_metrics_and_replicated_leaves(runs, tag, world):
    """Every rank reports the same metrics bits, and the ranks that share a
    leaf's chunk (a replicated leaf: all of them) hold the same bits."""
    outs = runs[world]
    for arch in TP_ARCHS:
        first = _prefixed(outs[0], f"{tag}/{arch}/train/")
        for o in outs[1:]:
            got = _prefixed(o, f"{tag}/{arch}/train/")
            for k in ("loss", "lm_loss", "grad_norm", "tokens"):
                assert torch.equal(got[k], first[k]), (arch, k)
            repl = [n for n in _prefixed(o, f"{tag}/{arch}/dims/")
                    if o[f"{tag}/{arch}/dims/{n}"].tolist() == [-1, -1]]
            assert repl
            bad = [n for n in repl for kind in ("params", "m")
                   if not torch.equal(got[f"{kind}/{n}"], first[f"{kind}/{n}"])]
            assert not bad, (arch, bad[:6])


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("tag,world,shape,rank", RANKS, ids=RANK_IDS)
def test_serve_matches_one_process(runs, arch, tag, world, shape, rank):
    """Prefill and teacher-forced decode logits (whole on every rank), the
    caches' local shape, and greedy generation."""
    out = _prefixed(runs[world][rank], f"{tag}/{arch}/serve/")
    cfg = smoke_config(arch)
    for k in ("prefill", "steps"):
        torch.testing.assert_close(out[k], out[f"ref/{k}"], rtol=0, atol=LOGIT_TOL, msg=k)
    assert torch.equal(out["generated"], out["ref/generated"])
    m = shape[1]
    kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else 1
    ref_shape = out["ref/cache_shape"].tolist()
    assert out["cache_shape"].tolist() == [ref_shape[0], ref_shape[1] // shape[0], ref_shape[2],
                                           kv, ref_shape[4]]


# ------------------------------------------------------------ vs JAX --


@pytest.mark.parametrize("rank", range(2))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_matches_the_jax_sharded_step(runs, arch, rank):
    """The port's (1, 2) ranks against the reference's (1, 2) step: losses,
    norms and final parameters of three training steps, the prefill and
    decode logits."""
    jax = _prefixed(runs["jax"], f"{arch}/")
    out = runs[2][rank]
    assert str(jax["train/wq_sharding"]) == "PartitionSpec(None, 'data', 'model')"
    assert str(jax["serve/cache_sharding"]) == "PartitionSpec(None, 'data', None, 'model', None)"
    got = _prefixed(out, f"mesh12/{arch}/train/")
    np.testing.assert_allclose(got["loss"].numpy(), jax["train/loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].numpy(), jax["train/grad_norm"], rtol=1e-5)
    cfg = smoke_config(arch)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(out[f"jax/{arch}/param/{name}"])
    mine = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                mine[prefix + k] = v

    flat(convert.lm_params_to_numpy(model))
    want = _prefixed(jax, "train/param/")
    assert mine.keys() == want.keys()
    for k in want:
        _assert_params_close(torch.from_numpy(np.asarray(mine[k], np.float32)),
                             torch.from_numpy(want[k]), TP_RUN["lr"], TP_RUN["steps"], k)
    serve = _prefixed(out, f"mesh12/{arch}/serve/")
    for k in ("prefill", "steps"):
        np.testing.assert_allclose(serve[k].numpy(), jax[f"serve/{k}"], rtol=0, atol=LOGIT_TOL,
                                   err_msg=k)


# ------------------------------------------------------ gradient kinds --


def _grads(runs, arch) -> list:
    return [_prefixed(o, f"grads/{arch}/") for o in runs[2]]


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_gradient_of_a_leaf_on_replicated_rows(runs, arch):
    """``ln1`` / ``ln2`` / ``ln_f`` scales: the same raw gradient bits on both
    ranks of the model axis, the one-process gradient, and not summed over
    the axis (``reduce_grads`` leaves them as they are)."""
    a, b = _grads(runs, arch)
    names = [n for n in (k[len("raw/"):] for k in a if k.startswith("raw/"))
             if n.split(".")[-2] in ("ln1", "ln2", "ln_f")]
    assert len(names) == 2 * smoke_config(arch).n_layers + 1
    for n in names:
        assert not a[f"per_head/{n}"]
        assert torch.equal(a[f"raw/{n}"], b[f"raw/{n}"]), n
        assert torch.equal(a[f"reduced/{n}"], a[f"raw/{n}"]), n
        scale = float(a[f"ref/{n}"].abs().max())
        torch.testing.assert_close(a[f"reduced/{n}"], a[f"ref/{n}"], rtol=0,
                                   atol=1e-5 * scale, msg=n)


HEAD_LEAVES = {"chatglm3_6b": ("attn.wq.bias", "attn.wk.bias", "attn.wv.bias"),
               "chameleon_34b": ("attn.q_norm.scale", "attn.k_norm.scale")}


@pytest.mark.parametrize("arch", sorted(HEAD_LEAVES))
def test_gradient_of_a_leaf_on_local_heads(runs, arch):
    """The q/k/v biases (chatglm3) and the qk-norm scales (chameleon): each
    rank's raw gradient is its heads' part, not the one-process gradient;
    the parts sum to it, and ``reduce_grads`` sums them on every rank."""
    a, b = _grads(runs, arch)
    names = [k[len("per_head/"):] for k, v in a.items() if k.startswith("per_head/") and v]
    assert sorted(names) == sorted(f"blocks.{i}.{leaf}" for leaf in HEAD_LEAVES[arch]
                                   for i in range(smoke_config(arch).n_layers))
    for n in names:
        ref = a[f"ref/{n}"]
        scale = float(ref.abs().max())
        assert float((a[f"raw/{n}"] - ref).abs().max()) > 1e-3 * scale, n
        torch.testing.assert_close(a[f"raw/{n}"] + b[f"raw/{n}"], ref, rtol=0,
                                   atol=1e-5 * scale, msg=n)
        for o in (a, b):
            torch.testing.assert_close(o[f"reduced/{n}"], ref, rtol=0, atol=1e-5 * scale, msg=n)


# ---------------------------------------------------------- checkpoints --


@pytest.mark.parametrize("case", ["to11", "to21", "to22"])
def test_checkpoint_moves_across_layouts(runs, case):
    """Saved on (1, 2), restored on (1, 1) (one process), (2, 1) and (2, 2):
    every leaf bit for bit."""
    outs = runs[4] if case == "to22" else runs[2]
    for r, out in enumerate(outs):
        if f"ckpt/{case}/bad" not in out:
            assert case == "to11" and r == 1  # one process restores it: rank 0
            continue
        assert out[f"ckpt/{case}/bad"] == [], (r, out[f"ckpt/{case}/bad"][:8])
    if case == "to11":  # every parameter, both moments and the step
        assert runs[2][0]["ckpt/to11/leaves"] == 3 * len(_full_params("llama3_2_1b")) + 1


# ----------------------------------------------------------- launchers --


def test_train_loop_with_a_mesh(runs):
    """``train(mesh=make_host_mesh(2))`` on (1, 2): one process's losses."""
    for out in runs[2]:
        np.testing.assert_allclose(out["loop/loss"].numpy(), out["loop/ref_loss"].numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("mp,shape", [(1, [4, 1]), (2, [2, 2]), (4, [1, 4]), (8, [1, 4])])
def test_host_mesh_shapes(runs, mp, shape):
    """``make_host_mesh(model_parallel=mp)`` on a world of 4 under gloo:
    ``(world // mp, mp)``, ``mp`` capped at the world."""
    for out in runs[4]:
        assert out[f"hostmesh/{mp}"].tolist() == shape
