"""Carry the JAX package's configs, plans, states and LM weights across to
the port.

The inputs are nested dicts of numpy arrays (or Python scalars) keyed by
the JAX package's field names — what ``dataclasses.fields`` / ``_asdict``
plus ``np.asarray`` give for its objects — so this module needs nothing of
JAX.  Carrying the controller plan and the initial PDU state lets both
packages compute from identical bits: the float32 Cholesky/solves of
``make_plan`` and of the LC steady state differ between XLA and PyTorch by
a few ulp, which would otherwise mix into every downstream comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import controller as ctrl, ess, filters, health as hlt, pdu
from repro_torch.models import layers as L, transformer as T
from repro_torch.power import scenario as SC
from repro_torch.utils.devices import resolve_device


def _tensor(v, dev) -> torch.Tensor:
    a = np.asarray(v)
    return torch.as_tensor(a.copy(), device=dev)


def _fields(cls, d: dict, dev, static: tuple[str, ...] = ()):
    kw = {}
    for name in cls.__dataclass_fields__:
        if name not in d or d[name] is None:
            continue
        kw[name] = d[name] if name in static else _tensor(d[name], dev)
    return cls(**kw)


def pdu_config_from_numpy(d: dict, *, device="cuda") -> pdu.PDUConfig:
    """``PDUConfig`` from ``{"filter_params", "ess_params", "controller",
    "health", "sample_dt", "software_enabled", "track_health", ...}``."""
    dev = resolve_device(device)
    for flag in ("degraded_mode", "safemode"):
        if d.get(flag):
            raise NotImplementedError(f"{flag} configs are not ported yet (ROADMAP.md)")
    health = d.get("health")
    return pdu.PDUConfig(
        filter_params=_fields(filters.LCFilterParams, d["filter_params"], dev),
        ess_params=_fields(ess.ESSParams, d["ess_params"], dev),
        controller=_fields(ctrl.ControllerConfig, d["controller"], dev, static=("horizon",)),
        health=None if health is None else _fields(hlt.HealthParams, health, dev, static=("kappa",)),
        sample_dt=float(d["sample_dt"]),
        software_enabled=bool(d.get("software_enabled", True)),
        track_health=bool(d.get("track_health", False)),
    )


def plan_from_numpy(d: dict, *, device="cuda") -> ctrl.ControllerPlan:
    """``ControllerPlan`` from its fields (``horizon``/``rho``/``sigma`` are
    host scalars)."""
    return _fields(
        ctrl.ControllerPlan, d, resolve_device(device), static=("horizon", "rho", "sigma")
    )


def pdu_state_from_numpy(d: dict, *, device="cuda") -> pdu.PDUState:
    """``PDUState`` from ``{"filter_state", "filter_obj": {"ad", "bd", "c",
    "dt"}, "ess_state": {"g_filter", "soc"}, "u_prev", "cmd_applied",
    "cmd_target", "soc_ema", "qp_warm": {"x", "z", "y"}, "health": {11
    leaves}, "ess_online", "last_good"}``."""
    dev = resolve_device(device)
    t = lambda v: _tensor(v, dev)
    fo = d["filter_obj"]
    opt = lambda k: None if d.get(k) is None else t(d[k])
    return pdu.PDUState(
        filter_state=t(d["filter_state"]),
        filter_obj=filters.DiscreteFilter(
            ad=t(fo["ad"]), bd=t(fo["bd"]), c=t(fo["c"]), dt=float(fo["dt"])
        ),
        ess_state=ess.ESSState(**{k: t(v) for k, v in d["ess_state"].items()}),
        u_prev=t(d["u_prev"]),
        cmd_applied=t(d["cmd_applied"]),
        cmd_target=t(d["cmd_target"]),
        soc_ema=t(d["soc_ema"]),
        qp_warm=ctrl.QPWarmState(**{k: t(v) for k, v in d["qp_warm"].items()}),
        health=hlt.HealthState(**{k: t(v) for k, v in d["health"].items()}),
        ess_online=opt("ess_online"),
        last_good=opt("last_good"),
    )


def workload_params_from_numpy(d: dict, *, device="cuda") -> SC.WorkloadParams:
    """``WorkloadParams`` from its 19 float32 columns."""
    return _fields(SC.WorkloadParams, d, resolve_device(device))


def numpy_tree(obj):
    """Nested dict of numpy arrays from a dataclass / NamedTuple tree (the
    JAX package's objects included: leaves go through ``np.asarray``, so no
    JAX import is needed).  Python scalars and None pass through."""
    import dataclasses

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if hasattr(obj, "_asdict"):
        return {k: numpy_tree(v) for k, v in obj._asdict().items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


# ------------------------------------------------------------ LM parameters


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *heads, leaf = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def lm_tree_shapes(cfg) -> dict:
    """``{dotted path: (shape, dtype)}`` of the JAX package's parameter tree
    for ``cfg`` (``repro.models.transformer.init``): the port's own module
    tree, with the per-layer ``blocks.{i}.*`` leaves stacked on a leading
    ``n_layers`` axis (the reference's scan layout)."""
    model = T.Transformer(cfg, device="meta")
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            if i != "0":
                continue
            out["blocks." + rest] = ((cfg.n_layers, *p.shape), p.dtype)
        else:
            out[name] = (tuple(p.shape), p.dtype)
    return out


def random_lm_tree(cfg, seed: int) -> dict:
    """A parameter tree in the JAX package's layout (nested dicts of numpy
    arrays, blocks stacked on axis 0) filled from
    ``numpy.random.default_rng(seed)``, leaf by leaf in sorted path order,
    with the reference's initialisers in distribution
    (``layers.leaf_rule``: a standard normal clipped at +-2 and scaled, or
    a constant; the draws are numpy's).  Leaves are float32: numpy has no
    bfloat16, so a bf16 config is cast on the device by
    ``lm_params_from_numpy`` (leaves that are float32 in the model, such as
    RWKV-6's ``decay_base`` and ``u_bonus``, stay float32)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, _) in sorted(lm_tree_shapes(cfg).items()):
        kind, val = L.leaf_rule(path, shape)
        if kind == "constant":
            a = np.full(shape, val, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            np.clip(a, -2.0, 2.0, out=a)
            a *= np.float32(val)
        flat[path] = a
    return _unflatten(flat)


@torch.no_grad()
def lm_params_from_numpy(tree: dict, cfg, *, device="cuda") -> T.Transformer:
    """A ``Transformer`` holding the JAX package's parameter tree ``tree``
    (nested dicts of numpy arrays, blocks stacked on axis 0).  Each leaf is
    moved to the device as it is and cast there to the config's dtype.
    Raises unless the tree's leaves and shapes match the model's exactly."""
    model = T.Transformer(cfg, device=device)
    dev = model.embed.embedding.device
    params = dict(model.named_parameters())
    flat = _flatten(tree)
    want = lm_tree_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter tree differs from the model: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}")
    for path, arr in flat.items():
        shape = want[path][0]
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{path}: shape {np.shape(arr)}, the model's is {shape}")
        t = torch.as_tensor(np.asarray(arr), device=dev)
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            for i in range(cfg.n_layers):
                params[f"blocks.{i}.{rest}"].copy_(t[i])
        else:
            params[path].copy_(t)
    return model


@torch.no_grad()
def lm_tree_to_numpy(named: dict, cfg) -> dict:
    """The JAX package's parameter-tree layout (nested dicts of float32
    numpy arrays, blocks stacked on axis 0) of a dict keyed by the port's
    parameter names: the parameters themselves, their gradients or an
    optimizer moment.  bf16 leaves are widened to float32 (exactly; numpy
    has no bfloat16)."""
    flat = {}
    want = lm_tree_shapes(cfg)
    for path in want:
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            leaves = [named[f"blocks.{i}.{rest}"] for i in range(cfg.n_layers)]
            t = torch.stack([x.detach() for x in leaves])
        else:
            t = named[path].detach()
        flat[path] = t.to(torch.float32).cpu().numpy()
    return _unflatten(flat)


def lm_params_to_numpy(model: T.Transformer) -> dict:
    """The inverse of ``lm_params_from_numpy``: ``model``'s parameters as
    the JAX package's tree (bf16 widened to float32)."""
    return lm_tree_to_numpy(dict(model.named_parameters()), model.cfg)
