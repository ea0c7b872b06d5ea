"""The JAX package's own sharded train step on two host devices, for
``tests/test_torch_fsdp.py``.

    python tests/_jax_fsdp_reference.py OUT.npz

Forces two host devices (``XLA_FLAGS``, set before jax is imported, as
``repro/launch/dryrun.py`` does), jits ``repro.train.step.
build_train_step(microbatches=FSDP_REF["microbatches"],
gather_small_weights_once=True)`` with the parameters and both AdamW
moments placed by ``repro.sharding.rules.param_specs`` and the batch by
``batch_spec`` on ``make_host_mesh()``'s ``("data", "model")`` = (2, 1)
mesh (``launch/dryrun.py``'s ``build_cell``), and runs ``FSDP_REF``'s
steps of the llama smoke config from ``convert.random_lm_tree(cfg, 0)`` on
``SyntheticLMDataset`` batches.  Writes each step's loss and grad norm and
the final parameters (dotted paths, the JAX layout) to ``OUT.npz``.
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
from repro.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402
from repro.sharding import rules  # noqa: E402
from repro.train.step import build_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402

sys.path[:0] = [str(ROOT / "tests")]
from _torch_dist_worker import FSDP_REF  # noqa: E402  (the run the port's two ranks make)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def run() -> dict:
    c = FSDP_REF
    assert jax.device_count() == 2, jax.devices()
    cfg = smoke_config(c["arch"])
    mesh = make_host_mesh()
    named = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                       is_leaf=lambda x: isinstance(x, P))
    params = jax.tree.map(jnp.asarray, convert.random_lm_tree(cfg, c["seed"]))
    opt = AdamWConfig(lr=c["lr"], weight_decay=c["weight_decay"])
    state = adamw_init(params, opt)
    param_sh = named(rules.param_specs(params, mesh))
    repl = NamedSharding(mesh, P())
    opt_sh = type(state)(step=repl, m=param_sh, v=param_sh)
    batch_sh = NamedSharding(mesh, rules.batch_spec(mesh, c["batch"]))
    step = build_train_step(cfg, opt, microbatches=c["microbatches"],
                            total_steps=c["total_steps"], warmup_steps=c["warmup_steps"],
                            gather_small_weights_once=True)
    jstep = jax.jit(step, in_shardings=(param_sh, opt_sh, {"tokens": batch_sh,
                                                           "labels": batch_sh}, repl),
                    out_shardings=(param_sh, opt_sh, None))
    params = jax.device_put(params, param_sh)
    state = jax.device_put(state, opt_sh)
    ds = SyntheticLMDataset(DataConfig(seed=c["seed"], batch=c["batch"], seq_len=c["seq_len"],
                                       vocab_size=cfg.vocab_size))
    losses, norms = [], []
    with mesh:
        for i in range(c["steps"]):
            batch = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
            params, state, metrics = jstep(params, state, batch, jnp.asarray(i, jnp.int32))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    out = {f"param/{k}": v for k, v in _flat(jax.tree.map(np.asarray, params)).items()}
    out.update(loss=np.asarray(losses, np.float64), grad_norm=np.asarray(norms, np.float64),
               embed_sharding=np.asarray(str(params["embed"]["embedding"].sharding.spec)))
    return out


if __name__ == "__main__":
    np.savez(sys.argv[1], **run())
