"""Tensor parallelism on the spec rules' ``"model"`` axis
(``repro_torch.sharding.tp``) for the ``ssm``, ``hybrid`` and ``audio``
families, on the CPU: gloo worlds of 2 and 4 ranks (``_torch_dist_worker.py
... tpf``, one process a rank) on ``("data", "model")`` meshes of (1, 2),
(2, 2) and (1, 4), and the JAX package's own (1, 2) step on two forced
host devices (``_jax_tp_reference.py ... families``), all started
together.  The smoke configs of rwkv6-7b (2 RWKV heads; ``mix_lora_a``'s
40 columns split across its five factors), zamba2-2.7b (8 Mamba2 heads,
``w_in``'s 552 fused columns split across its segments, the shared block's
4 heads) and whisper-large-v3 (4 heads, 64 encoder frames, untied head),
float32.  The smoke rwkv's 2 heads do not split over 4 ranks: (1, 4) is its
refusal.

* **Shards against the rules**: every rank's parameter is the full leaf's
  chunk along the dims ``param_specs`` gives to ``"model"`` and ``"data"``,
  bit for bit.
* **Against one process** (the same weights and batches, unsharded), each
  tolerance float32 reassociation: the ranks' partial products and sums
  (the row-parallel sums, the GEMMs on a rank's columns, the
  vocab-parallel ``logsumexp``, the global norm) reassociate the
  one-process sums; ``ln_x`` and ``out_norm`` run on whole rows, the
  one-process order.  Training, three steps: loss, ``lm_loss`` and
  ``grad_norm`` to 1e-5 relative (measured at most 4.8e-6), ``tokens``
  exactly.  The parameters by ``test_torch_tp``'s rule (every element
  within ``2 lr`` a step; 99.9 % of each leaf within 1e-5 of its scale plus
  1e-7), the 0.1 % allowance rounded up to whole elements: AdamW's ``m /
  (sqrt(v) + eps)`` turns float32 noise in an element whose gradient is
  near zero into an update of up to ``lr``, and one such element is already
  more than 0.1 % of ``mu_base``'s 640 a layer or a layernorm bias's 128
  (measured: one element of each, within 1.3e-7 and 6.5e-6 of one
  process).  The first moments to 1e-4 of the leaf's scale plus 1e-9.
  Serving: the prefill's and three teacher-forced decode steps' logits to
  2e-5 absolute (measured at most 5.1e-6), greedy generation token for
  token, and the decode state's local shapes.
* **Against the JAX package's sharded step**: the reference's
  ``build_train_step`` and ``decode_step`` jitted with ``param_specs`` /
  ``decode_state_specs`` shardings on ``make_host_mesh(model_parallel=2)``,
  against the port's two gloo ranks: losses to 1e-5 relative, grad norms
  to 2e-5 (zamba2's third step measured 8.3e-6: the one-process port and
  the reference already differ there by float32 reassociation of the
  chunked SSD and of the norm's sum), the parameters by the rule, the
  logits to 2e-5.
* **The two kinds of model-replicated gradient**: a leaf read on
  replicated rows (the block norms, ``ln_x`` and ``out_norm`` on their
  whole rows, whisper's layernorm biases, ``dec_pos``) has the same
  gradient bits on every rank and is not summed; a leaf read after a block
  norm's ``copy_to_model`` for a rank's heads or columns (every other
  replicated leaf of the RWKV-6 mixes and of Mamba2) holds
  that rank's part, and ``reduce_grads`` sums the parts.  Every replicated
  leaf is exactly one kind (whisper has none of the second).
* **Checkpoints** of zamba2: saved on (1, 2), restored on (2, 1), (1, 1)
  and (2, 2), every leaf bit for bit.
* ``train(mesh=)`` for whisper and every refusal (``ValueError`` naming its
  ROADMAP.md item: 9b.7c for a split that the axis does not divide).
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
from repro_torch.configs.base import SSMConfig
from repro_torch.sharding import fsdp

sys.path[:0] = [str(Path(__file__).resolve().parent)]
from _torch_dist_worker import TP_RUN, TPF_ARCHS  # noqa: E402
from test_torch_tp import LOGIT_TOL, _full_params  # noqa: E402

WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
JAX_REF = Path(__file__).resolve().parent / "_jax_tp_reference.py"
WORLDS = (2, 4)
JOIN_S = 150.0
# The meshes each world runs: (tag, world, (data, model), archs).
MESHES = (("mesh12", 2, (1, 2), TPF_ARCHS), ("mesh22", 4, (2, 2), TPF_ARCHS),
          ("mesh14", 4, (1, 4), TPF_ARCHS[1:]))
JAX_NORM_RTOL = 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """``{world: [rank 0's results, ...], "jax": the reference's run}``:
    both worlds and the JAX subprocess started at once."""
    root = tmp_path_factory.mktemp("tpf")
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
                 "tpf"], stdout=log, stderr=subprocess.STDOUT, env=env)))
    log = open(root / "jax.log", "w")
    procs.append(("the JAX reference", log, root / "jax.log", subprocess.Popen(
        [sys.executable, str(JAX_REF), str(root / "jax.npz"), "families"], stdout=log,
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


def _assert_params_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The module docstring's rule for the parameters after ``TP_RUN``'s
    steps."""
    g, w = got.double().numpy(), want.double().numpy()
    if not w.size:
        return
    err = np.abs(g - w)
    loose = int(np.sum(err > 1e-5 * float(np.max(np.abs(w))) + 1e-7))
    assert loose <= -(-w.size // 1000), (what, loose, w.size)
    assert err.max() <= 2 * TP_RUN["lr"] * TP_RUN["steps"], (what, err.max())


def _check_train(got: dict, want: dict, what: str) -> None:
    for k in ("loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)
    assert torch.equal(got["tokens"], want["tokens"])
    for key, w in want.items():
        kind, _, name = key.partition("/")
        if kind == "params":
            _assert_params_close(got[key], w, f"{what} {name}")
        elif kind == "m":
            scale = float(w.abs().max()) if w.numel() else 0.0
            torch.testing.assert_close(got[key], w, rtol=0, atol=1e-4 * scale + 1e-9,
                                       msg=f"{what} {key}")


CASES = [(arch, tag, world, shape, r) for tag, world, shape, archs in MESHES for arch in archs
         for r in range(world)]
CASE_IDS = [f"{arch}-{tag}-rank{r}" for arch, tag, _, _, r in CASES]


# ------------------------------------------------------- shards and rules --


@pytest.mark.parametrize("arch,tag,world,shape,rank", CASES, ids=CASE_IDS)
def test_shards_follow_the_rules(runs, arch, tag, world, shape, rank):
    """Each parameter after ``shard_model`` is the full leaf's chunk along
    the dims ``param_specs`` gives to ``"model"`` and ``"data"`` (by the
    rank's mesh coordinates), bit for bit; the fused ``mix_lora_a`` /
    ``w_in`` among the model-split leaves."""
    out = runs[world][rank]
    d_rank, m_rank = out[f"{tag}/coords"].tolist()
    full = _full_params(arch)
    specs = sharding.param_specs(full, {"data": shape[0], "model": shape[1]})
    shards = _prefixed(out, f"{tag}/{arch}/shard/")
    assert shards.keys() == full.keys()
    split = set()
    for name, t in shards.items():
        want = full[name]
        dims = out[f"{tag}/{arch}/dims/{name}"].tolist()
        assert dims == [-1 if d is None else d for d in (fsdp.data_dim(specs[name]),
                                                         fsdp.model_dim(specs[name]))], name
        if dims[1] >= 0:
            want = want.chunk(shape[1], dims[1])[m_rank]
            split.add(name.split(".")[-2] if name.endswith("kernel") else name.split(".")[-1])
        if dims[0] >= 0:
            want = want.chunk(shape[0], dims[0])[d_rank]
        assert torch.equal(t, want), (name, dims)
    fused = {"rwkv6_7b": {"mix_lora_a", "wr", "wk", "wv", "wg", "wo"},
             "zamba2_2_7b": {"w_in", "w_out", "w_concat", "wq", "w_up", "w_down"},
             "whisper_large_v3": {"wq", "wk", "wv", "wo", "w_up", "w_down", "lm_head"}}[arch]
    assert fused <= split, fused - split


ADMITS = [(a, m) for a in TPF_ARCHS for m in (2, 4, 16)
          if not (a == "whisper_large_v3" and m == 16)]


@pytest.mark.parametrize("arch,m", ADMITS)
def test_mesh_family_admits_the_families(arch, m):
    """The full configs run a model axis of 2, 4 and 16 (the production
    mesh's) where it divides their heads, ``d_ff`` and vocab: rwkv6's 64
    heads, zamba2's 80 Mamba2 and 32 shared-block heads; whisper's 20
    heads up to 4 (16 is 9b.7c)."""
    cfg = full_config(arch)
    sizes = {"data": 256 // m, "model": m}
    assert sharding.check_mesh_family(sizes, cfg) is sizes


def _zamba(**kw):
    return dataclasses.replace(smoke_config("zamba2_2_7b"), **kw)


REFUSALS = {
    "rwkv_heads": (smoke_config("rwkv6_7b"), 4, "RWKV heads 2"),
    "rwkv_d_ff": (smoke_config("rwkv6_7b", d_ff=255), 2, "d_ff 255"),
    "mamba_heads": (_zamba(d_model=96, ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                                    head_dim=64, chunk=16)), 2,
                    "Mamba2 heads 3"),
    "shared_heads": (smoke_config("zamba2_2_7b"), 8, "shared-block heads 4"),
    "zamba_vocab": (_zamba(vocab_size=510, pad_vocab_multiple=2), 4, "padded vocab 510"),
    "whisper_heads": (full_config("whisper_large_v3"), 16, "query heads 20"),
    "whisper_kv_heads": (smoke_config("whisper_large_v3", n_kv_heads=2), 4, "KV heads 2"),
    "whisper_d_ff": (smoke_config("whisper_large_v3", d_ff=255), 2, "d_ff 255"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_mesh_family_refusals(name):
    """Each split the axis does not divide raises, naming it and 9b.7c."""
    cfg, m, what = REFUSALS[name]
    with pytest.raises(ValueError, match=rf"{what} do not split .*9b\.7c"):
        sharding.check_mesh_family({"data": 1, "model": m}, cfg)


ERRORS = ("shard", "train", "serve", "state")


@pytest.mark.parametrize("name", ERRORS)
def test_refusals_on_a_real_mesh(runs, name):
    """rwkv6's 2 smoke heads placed on, trained on, served on and given a
    decode state on a (1, 4) mesh."""
    for out in runs[4]:
        msg = out[f"error/{name}"]
        assert msg.startswith("ValueError") and "RWKV heads 2" in msg and "9b.7c" in msg, msg


# ---------------------------------------------------------------- steps --


@pytest.mark.parametrize("arch,tag,world,shape,rank", CASES, ids=CASE_IDS)
def test_train_matches_one_process(runs, arch, tag, world, shape, rank):
    out = runs[world][rank]
    prefix = f"{tag}/{arch}/train/"
    got = {k: v for k, v in _prefixed(out, prefix).items() if not k.startswith("ref/")}
    _check_train(got, _prefixed(out, prefix + "ref/"), f"{tag} {arch}")


@pytest.mark.parametrize("tag,world,archs", [(t, w, a) for t, w, _, a in MESHES])
def test_ranks_agree_on_metrics_and_replicated_leaves(runs, tag, world, archs):
    """Every rank reports the same metrics bits, and every rank holds the
    same bits of a leaf replicated over both axes."""
    outs = runs[world]
    for arch in archs:
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


def _local_state_shape(name: str, ref: list, cfg, shape) -> list:
    """The shape a rank's decode-state leaf ``name`` has, from the
    one-process ``ref``: the batch over ``"data"``, the heads over
    ``"model"`` (the RWKV shift states whole; the conv state x of the
    rank's heads plus B and C)."""
    n_data, m = shape
    want = list(ref)
    batch_dim = {"cross_k": 1, "cross_v": 1}.get(name.split(".")[-1], None)
    if name.startswith("groups."):
        batch_dim = 2
    elif batch_dim is None:
        batch_dim = 1
    want[batch_dim] //= n_data
    leaf = name.split(".")[-1]
    if leaf in ("wkv", "k", "v", "cross_k", "cross_v"):
        want[-3 if leaf == "wkv" else -2] //= m
    elif leaf == "ssm":
        want[-3] //= m
    elif leaf == "conv":
        s = cfg.ssm
        want[-1] = s.expand * cfg.d_model // m + 2 * s.d_state
    return want


@pytest.mark.parametrize("arch,tag,world,shape,rank", CASES, ids=CASE_IDS)
def test_serve_matches_one_process(runs, arch, tag, world, shape, rank):
    """Prefill and teacher-forced decode logits (whole on every rank), the
    decode state's local shapes, and greedy generation."""
    out = _prefixed(runs[world][rank], f"{tag}/{arch}/serve/")
    cfg = smoke_config(arch)
    for k in ("prefill", "steps"):
        torch.testing.assert_close(out[k], out[f"ref/{k}"], rtol=0, atol=LOGIT_TOL, msg=k)
    assert torch.equal(out["generated"], out["ref/generated"])
    states = _prefixed(out, "state/")
    assert states.keys() == _prefixed(out, "ref/state/").keys() and states
    for name, got in states.items():
        want = _local_state_shape(name, out[f"ref/state/{name}"].tolist(), cfg, shape)
        assert got.tolist() == want, (name, got.tolist(), want)


# ------------------------------------------------------------ vs JAX --


JAX_SPECS = {"rwkv6_7b": ("PartitionSpec(None, 'data', 'model')",
                          "PartitionSpec(None, 'data', 'model', None, None)"),
             "zamba2_2_7b": ("PartitionSpec(None, None, 'data', 'model')",
                             "PartitionSpec(None, None, 'data', 'model', None, None)"),
             "whisper_large_v3": ("PartitionSpec(None, 'data', 'model')",
                                  "PartitionSpec(None, 'data', None, 'model', None)")}


@pytest.mark.parametrize("rank", range(2))
@pytest.mark.parametrize("arch", TPF_ARCHS)
def test_matches_the_jax_sharded_step(runs, arch, rank):
    """The port's (1, 2) ranks against the reference's (1, 2) step: losses,
    norms and final parameters of three training steps, the prefill and
    decode logits.  The reference's own layout as its run reports it: the
    time mix's ``wr``, Mamba2's fused ``w_in`` and the decoder's ``wq``
    split on ``"model"``, and the state's ``wkv`` / ``ssm`` / cross-K heads."""
    jax = _prefixed(runs["jax"], f"{arch}/")
    out = runs[2][rank]
    assert (str(jax["train/wq_sharding"]), str(jax["serve/cache_sharding"])) == JAX_SPECS[arch]
    got = _prefixed(out, f"mesh12/{arch}/train/")
    np.testing.assert_allclose(got["loss"].numpy(), jax["train/loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].numpy(), jax["train/grad_norm"],
                               rtol=JAX_NORM_RTOL)
    cfg = smoke_config(arch)
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(out[f"mesh12/{arch}/whole/{name}"])
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
                             torch.from_numpy(want[k]), k)
    serve = _prefixed(out, f"mesh12/{arch}/serve/")
    for k in ("prefill", "steps"):
        np.testing.assert_allclose(serve[k].numpy(), jax[f"serve/{k}"], rtol=0, atol=LOGIT_TOL,
                                   err_msg=k)


# ------------------------------------------------------ gradient kinds --


def _grads(runs, arch) -> list:
    return [_prefixed(o, f"grads/{arch}/") for o in runs[2]]


# The leaves of each kind (by the name past the layer indices).
ROW_LEAVES = {"rwkv6_7b": {"ln1.scale", "ln2.scale", "ln_x.scale", "ln_f.scale"},
              "zamba2_2_7b": {"ln.scale", "ln1.scale", "ln2.scale", "out_norm.scale", "ln_f.scale",
                              "_sub_heads"},
              "whisper_large_v3": {"ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "ln_x.scale",
                                   "ln_x.bias", "ln_enc.scale", "ln_enc.bias", "ln_f.scale",
                                   "ln_f.bias", "dec_pos"}}
PART_LEAVES = {"rwkv6_7b": {"mu_base", "mix_lora_b", "decay_base", "decay_lora.a",
                            "decay_lora.b", "u_bonus", "mu_k", "mu_r"},
               "zamba2_2_7b": {"a_log", "dt_bias", "d_skip", "conv.kernel"},
               "whisper_large_v3": set()}


def _short(name: str) -> str:
    parts = [p for p in name.split(".") if not p.isdigit()]
    tail = ".".join(parts[-2:])
    return tail if parts[-1] in ("scale", "bias", "kernel", "a", "b") else parts[-1]


@pytest.mark.parametrize("arch", TPF_ARCHS)
def test_every_replicated_leaf_is_one_kind(runs, arch):
    """The model-replicated leaves split into exactly the two kinds, by
    name: those read on replicated rows and those read on a rank's part."""
    a, _ = _grads(runs, arch)
    rows = {_short(k[len("per_head/"):]) for k, v in a.items() if k.startswith("per_head/")
            and not v}
    part = {_short(k[len("per_head/"):]) for k, v in a.items() if k.startswith("per_head/") and v}
    assert rows == ROW_LEAVES[arch] and part == PART_LEAVES[arch], (rows, part)


@pytest.mark.parametrize("arch", TPF_ARCHS)
def test_gradient_of_a_leaf_on_replicated_rows(runs, arch):
    """The norms (and whisper's ``dec_pos``): the same raw gradient bits on
    both ranks of the model axis, the one-process gradient, and not summed
    over the axis (``reduce_grads`` leaves them as they are)."""
    a, b = _grads(runs, arch)
    names = [k[len("per_head/"):] for k, v in a.items() if k.startswith("per_head/") and not v]
    assert names
    for n in names:
        assert torch.equal(a[f"raw/{n}"], b[f"raw/{n}"]), n
        assert torch.equal(a[f"reduced/{n}"], a[f"raw/{n}"]), n
        if a[f"ref/{n}"].numel():
            scale = float(a[f"ref/{n}"].abs().max())
            torch.testing.assert_close(a[f"reduced/{n}"], a[f"ref/{n}"], rtol=0,
                                       atol=1e-5 * scale, msg=n)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2_7b"])
def test_gradient_of_a_leaf_on_local_heads(runs, arch):
    """The mixes' and Mamba2's replicated leaves: each rank's raw gradient
    is its part, not the one-process gradient; the parts sum to it, and
    ``reduce_grads`` sums them on every rank."""
    a, b = _grads(runs, arch)
    names = [k[len("per_head/"):] for k, v in a.items() if k.startswith("per_head/") and v]
    assert names
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
    """zamba2 saved on (1, 2), restored on (1, 1) (one process), (2, 1) and
    (2, 2): every leaf bit for bit."""
    outs = runs[4] if case == "to22" else runs[2]
    for r, out in enumerate(outs):
        if f"ckpt/{case}/bad" not in out:
            assert case == "to11" and r == 1  # one process restores it: rank 0
            continue
        assert out[f"ckpt/{case}/bad"] == [], (r, out[f"ckpt/{case}/bad"][:8])
    if case == "to11":  # every parameter, both moments and the step
        assert runs[2][0]["ckpt/to11/leaves"] == 3 * len(_full_params("zamba2_2_7b")) + 1


def test_train_loop_with_a_mesh(runs):
    """``train(mesh=make_host_mesh(2))`` for whisper on (1, 2), its frames
    split by the step: one process's losses."""
    for out in runs[2]:
        np.testing.assert_allclose(out["loop/loss"].numpy(), out["loop/ref_loss"].numpy(),
                                   rtol=1e-5)
