"""The JAX package's own tensor-parallel steps on two host devices, for
``tests/test_torch_tp.py``.

    python tests/_jax_tp_reference.py OUT.npz [families]

Forces two host devices (``XLA_FLAGS``, set before jax is imported, as
``repro/launch/dryrun.py`` does) and builds ``make_host_mesh(model_parallel=2)``,
the ``("data", "model")`` = (1, 2) mesh.  For each smoke config of
``TP_ARCHS`` (with ``families``: of ``TPF_ARCHS``, the ssm, hybrid and audio
families, whisper's batches and prompts with their encoder frames), from
``convert.random_lm_tree(cfg, 0)``:

* ``build_train_step`` jitted with the parameters and both AdamW moments
  placed by ``repro.sharding.rules.param_specs`` and the batch by
  ``batch_spec`` (``launch/dryrun.py``'s ``build_cell``), ``TP_RUN``'s steps on
  ``tp_batch`` batches: each step's loss and grad norm, the final
  parameters (dotted paths, the JAX layout);
* the prefill and ``TP_SERVE["decode"]`` teacher-forced decode steps of
  ``T.decode_step`` (``audio``: ``encdec.decode_step`` from
  ``encdec.init_decode_state``) jitted with the parameters by
  ``param_specs`` and the state by ``decode_state_specs``: the prefill's
  logits and each step's.

GSPMD partitions these programs over the two devices; it inserts every
collective.  Writes ``OUT.npz`` keyed ``{arch}/...``.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro.configs import smoke_config  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import encdec as ED, transformer as T  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402
from repro.sharding import rules  # noqa: E402
from repro.train.step import build_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402

sys.path[:0] = [str(ROOT / "tests")]
from _torch_dist_worker import (TP_ARCHS, TP_RUN, TP_SERVE, TPF_ARCHS, tp_batch,  # noqa: E402
                                tp_frames, tp_prompts)

# The leaf whose sharding each family's run reports, and the decode-state
# leaf.
SPEC_LEAF = {"ssm": ("blocks", "time", "wr", "kernel"),
             "hybrid": ("groups", "mamba", "w_in", "kernel"),
             "audio": ("dec_blocks", "attn", "wq", "kernel")}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _state_leaf(state, family):
    if family == "ssm":
        return state["blocks"].wkv
    if family == "hybrid":
        return state["groups"].ssm
    if family == "audio":
        return state.cross_k
    return state["blocks"].k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def train_run(arch: str, mesh) -> dict:
    c = TP_RUN
    cfg = smoke_config(arch)
    params = jax.tree.map(jnp.asarray, convert.random_lm_tree(cfg, 0))
    opt = AdamWConfig(lr=c["lr"], weight_decay=c["weight_decay"])
    state = adamw_init(params, opt)
    param_sh = _named(mesh, rules.param_specs(params, mesh))
    repl = NamedSharding(mesh, P())
    opt_sh = type(state)(step=repl, m=param_sh, v=param_sh)
    batch_sh = NamedSharding(mesh, rules.batch_spec(mesh, c["batch"]))
    step = build_train_step(cfg, opt, total_steps=c["total_steps"],
                            warmup_steps=c["warmup_steps"])
    keys = ("tokens", "labels") + (("frames",) if cfg.family == "audio" else ())
    jstep = jax.jit(step, in_shardings=(param_sh, opt_sh, {k: batch_sh for k in keys}, repl),
                    out_shardings=(param_sh, opt_sh, None))
    params = jax.device_put(params, param_sh)
    state = jax.device_put(state, opt_sh)
    losses, norms = [], []
    with mesh:
        for i in range(c["steps"]):
            batch = {k: jnp.asarray(np.asarray(v)) for k, v in tp_batch(cfg, i).items()}
            params, state, metrics = jstep(params, state, batch, jnp.asarray(i, jnp.int32))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    out = {f"param/{k}": v for k, v in _flat(jax.tree.map(np.asarray, params)).items()}
    out.update(loss=np.asarray(losses, np.float64), grad_norm=np.asarray(norms, np.float64),
               wq_sharding=np.asarray(str(_leaf(params, SPEC_LEAF.get(
                   cfg.family, ("blocks", "attn", "wq", "kernel"))).sharding.spec)))
    return out


def serve_run(arch: str, mesh) -> dict:
    c = TP_SERVE
    cfg = smoke_config(arch)
    params = jax.tree.map(jnp.asarray, convert.random_lm_tree(cfg, 0))
    param_sh = _named(mesh, rules.param_specs(params, mesh))
    params = jax.device_put(params, param_sh)
    prompts, fed = tp_prompts(cfg)
    b, t = prompts.shape
    max_len = t + c["decode"]
    audio = cfg.family == "audio"
    step = ED.decode_step if audio else T.decode_step
    if audio:
        with mesh:
            state = ED.init_decode_state(params, cfg, jnp.asarray(tp_frames(cfg)), b, max_len)
    else:
        state = T.init_decode_state(cfg, b, max_len)
    state_sh = _named(mesh, rules.decode_state_specs(state, mesh))
    state = jax.device_put(state, state_sh)
    prefill = jax.jit(lambda p, tok, s: step(p, cfg, tok, s, jnp.asarray(0, jnp.int32),
                                             prefill=True),
                      in_shardings=(param_sh, None, state_sh), out_shardings=(None, state_sh))
    decode = jax.jit(lambda p, tok, s, pos: step(p, cfg, tok, s, pos),
                     in_shardings=(param_sh, None, state_sh, None),
                     out_shardings=(None, state_sh))
    out = {}
    with mesh:
        logits, state = prefill(params, jnp.asarray(prompts), state)
        out["prefill"] = np.asarray(logits, np.float32)
        steps = []
        for i in range(c["decode"]):
            logits, state = decode(params, jnp.asarray(fed[:, i:i + 1]), state,
                                   jnp.asarray(t + i, jnp.int32))
            steps.append(np.asarray(logits, np.float32))
    out["steps"] = np.concatenate(steps, axis=1)
    out["cache_sharding"] = np.asarray(str(_state_leaf(state, cfg.family).sharding.spec))
    return out


def run(archs) -> dict:
    assert jax.device_count() == 2, jax.devices()
    mesh = make_host_mesh(model_parallel=2)
    assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
    out = {}
    for arch in archs:
        for k, v in train_run(arch, mesh).items():
            out[f"{arch}/train/{k}"] = v
        for k, v in serve_run(arch, mesh).items():
            out[f"{arch}/serve/{k}"] = v
    return out


if __name__ == "__main__":
    np.savez(sys.argv[1], **run(TPF_ARCHS if sys.argv[2:] == ["families"] else TP_ARCHS))
