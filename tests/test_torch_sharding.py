"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's (``repro.sharding.rules``), leaf by leaf, and the port's registry.

For every config in ``configs/``: ``param_specs`` over the port's
parameter shapes (``convert.lm_tree_shapes``) against the reference's over
its own (``jax.eval_shape`` of its ``init``), on a real 1 x 1 JAX mesh and
at production shape, 16 x 16 and 2 x 16 x 16, where the JAX side is a
``jax.sharding.AbstractMesh`` and the port's an axis-size mapping.  The
moe configs run at their published width cut in depth to their first
dense layers and one MoE layer: the reference's ``eval_shape`` takes
30-60 s at full depth, and the rules read a stacked leaf's trailing dims
only (the port's full-depth specs equal its cut-depth ones, checked).
Then ``batch_spec``, ``cache_spec`` and ``decode_state_specs`` at the same
meshes, the divisibility fallback on meshes whose sizes divide nothing,
``placements`` and the registry's errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as JR
from repro.models import encdec as JED, transformer as JT
from repro.sharding import rules as jrules
from repro_torch import convert, sharding
from repro_torch.configs import full_config
from repro_torch.models import encdec as TED, transformer as TT
from repro_torch.utils import Registry

ARCHS = JR.ARCH_IDS
MESHES = {
    "1x1": ({"data": 1, "model": 1}, lambda: jrules.make_mesh((1, 1), ("data", "model"))),
    "16x16": ({"data": 16, "model": 16},
              lambda: AbstractMesh((16, 16), ("data", "model"))),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16},
                lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
}


def _cut(cfg):
    """A moe config at its published width with its first dense layers and
    one MoE layer; every other config whole."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, n_layers=cfg.moe.first_dense_layers + 1)


def _jax_params(arch):
    jcfg = _cut(JR.full_config(arch))
    init = JED.init if jcfg.family == "audio" else JT.init
    return jax.eval_shape(lambda: init(jax.random.key(0), jcfg))


def _dotted(tree) -> dict:
    """``{dotted path: PartitionSpec as a tuple}`` of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    name = lambda k: str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
    return {".".join(name(k) for k in p): tuple(s) for p, s in flat}


@pytest.fixture(scope="module")
def jax_params():
    return {}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(jax_params, arch, mesh):
    sizes, jmesh = MESHES[mesh]
    if arch not in jax_params:
        jax_params[arch] = _jax_params(arch)
    want = _dotted(jrules.param_specs(jax_params[arch], jmesh()))
    cfg = full_config(arch)
    shapes = convert.lm_tree_shapes(_cut(cfg))
    got = sharding.param_specs(shapes, sizes)
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(isinstance(v, sharding.PartitionSpec) for v in got.values())
    if cfg.family == "moe":  # the specs do not read the stacks' depth
        assert sharding.param_specs(convert.lm_tree_shapes(cfg), sizes) == got
    # The notes list what fell back, as the reference's.
    tn, jn = [], []
    sharding.param_specs(shapes, sizes, notes=tn)
    jrules.param_specs(jax_params[arch], jmesh(), notes=jn)
    assert sorted(tn) == sorted(jn)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_the_reference(mesh):
    sizes, jmesh = MESHES[mesh]
    jm = jmesh()
    for batch in (1, 2, 3, 16, 32, 48, 256):
        for pod in (False, True):
            assert tuple(sharding.batch_spec(sizes, batch, pod=pod)) == \
                tuple(jrules.batch_spec(jm, batch, pod=pod)), (batch, pod)
        for heads in (None, 1, 2, 8, 16, 40, 128):
            assert tuple(sharding.cache_spec(sizes, batch, heads)) == \
                tuple(jrules.cache_spec(jm, batch, heads)), (batch, heads)


def _decode_states(arch, batch, max_len):
    """Both packages' decode states for ``arch`` (shapes only: the JAX
    side through ``eval_shape``, the port's on the meta device); the
    ``audio`` state encodes 1500 frames."""
    jcfg, cfg = _cut(JR.full_config(arch)), _cut(full_config(arch))
    if cfg.family == "audio":
        frames = jax.ShapeDtypeStruct((batch, 1500, jcfg.d_model), jnp.dtype(jcfg.dtype))
        want = jax.eval_shape(lambda p, f: JED.init_decode_state(p, jcfg, f, batch, max_len),
                              _jax_params(arch), frames)
        model = convert.lm_model(cfg, device="meta")
        got = TED.init_decode_state(model, torch.empty((batch, 1500, cfg.d_model),
                                                       dtype=torch.bfloat16, device="meta"),
                                    batch, max_len)
        return got, want
    want = jax.eval_shape(lambda: JT.init_decode_state(jcfg, batch, max_len))
    return TT.init_decode_state(cfg, batch, max_len, device="meta"), want


def _port_dotted(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_dotted(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, sharding.PartitionSpec):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_port_dotted(v, f"{prefix}{f}."))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("mesh", ["1x1", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_the_reference(arch, mesh):
    sizes, jmesh = MESHES[mesh]
    got, want = _decode_states(arch, 32, 256)
    assert _port_dotted(sharding.decode_state_specs(got, sizes)) == \
        _dotted(jrules.decode_state_specs(want, jmesh()))


def test_divisibility_fallback():
    odd = {"data": 3, "model": 7}
    assert sharding.rules._fits(21, odd, "model") and not sharding.rules._fits(20, odd, "model")
    assert sharding.rules._fits(20, odd, None)
    notes = []
    # An up-projection whose dims divide neither axis: unsharded, noted.
    assert sharding.param_spec(("blocks", "attn", "wq", "kernel"), (4, 64, 128), odd,
                               notes=notes) == (None, None, None)
    assert notes == ["blocks/attn/wq/kernel: up out-dim not divisible; unsharded"]
    # The vocab falls back, d_model keeps "data".
    assert sharding.param_spec(("embed", "embedding"), (100, 99), odd) == (None, "data")
    # Experts: E does not divide "model", the in-dim divides "data".
    assert sharding.param_spec(("moe_blocks", "moe", "experts", "w_up"), (2, 8, 9, 4),
                               odd) == (None, None, "data", None)
    assert sharding.batch_spec(odd, 4) == (None,)
    assert sharding.cache_spec(odd, 4, 8) == (None, "model", None, None)
    # The reference's rule on the same sizes (a JAX AbstractMesh).
    jm = AbstractMesh((3, 7), ("data", "model"))
    for path, shape in ((("blocks", "attn", "wq", "kernel"), (4, 64, 128)),
                        (("embed", "embedding"), (100, 99)),
                        (("blocks", "ffn", "w_down", "kernel"), (4, 21, 30))):
        assert tuple(sharding.param_spec(path, shape, odd)) == \
            tuple(jrules.param_spec(path, shape, jm))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    P = sharding.P
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert sharding.placements(P(None, "data", "model"), sizes) == \
        (Replicate(), Shard(1), Shard(2))
    assert sharding.placements(P(("pod", "data")), sizes) == (Shard(0), Shard(0), Replicate())
    assert sharding.placements(P("model", "data"), {"data": 16, "model": 16}) == \
        (Shard(1), Shard(0))
    assert sharding.placements(P(), sizes) == (Replicate(),) * 3
    assert repr(P("data", None)) == "PartitionSpec('data', None)"
    assert P("data", None) == ("data", None)


def test_mesh_helpers_refuse_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh with named axes"):
        sharding.check_mesh(object())
    with pytest.raises(ValueError, match="lack the rack axis 'data'"):
        sharding.rack_block(16, {"campus": 4})
    with pytest.raises(ValueError, match="16 racks do not split evenly over the 3 ranks"):
        sharding.rack_block(16, {"data": 3})
    with pytest.raises(ValueError, match="n_campuses must be positive"):
        sharding.region_mesh(0)
    with pytest.raises(RuntimeError, match="initialised process group"):
        sharding.make_mesh((1, 1), ("campus", "data"), device_type="cpu")
    from repro_torch.launch import mesh as lmesh

    with pytest.raises(ValueError, match=r"needs a world of 256 ranks; this one has 1"):
        lmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match=r"needs a world of 512 ranks"):
        lmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_registry():
    reg = Registry("kernel")
    reg.register("b")(1)
    reg.register("a")(2)
    assert reg["a"] == 2 and "b" in reg and "c" not in reg
    assert list(reg) == reg.names() == ["a", "b"]
    with pytest.raises(ValueError, match="duplicate kernel registration: 'a'"):
        reg.register("a")(3)
    with pytest.raises(KeyError, match="unknown kernel 'c'; known: a, b"):
        reg["c"]
