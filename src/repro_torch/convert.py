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

import itertools

import numpy as np
import torch

from repro_torch.core import controller as ctrl, ess, filters, health as hlt, pdu, \
    safemode as smode
from repro_torch.models import encdec as ED, layers as L, transformer as T
from repro_torch.power import faults as FLT, scenario as SC
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
    "health", "safemode_params", "sample_dt", "software_enabled",
    "track_health", "degraded_mode", "safemode"}`` (``safemode_params``:
    ``resid_threshold`` a tensor, the two interval counts host ints)."""
    dev = resolve_device(device)
    health = d.get("health")
    smp = d.get("safemode_params")
    return pdu.PDUConfig(
        filter_params=_fields(filters.LCFilterParams, d["filter_params"], dev),
        ess_params=_fields(ess.ESSParams, d["ess_params"], dev),
        controller=_fields(ctrl.ControllerConfig, d["controller"], dev, static=("horizon",)),
        health=None if health is None else _fields(hlt.HealthParams, health, dev, static=("kappa",)),
        safemode_params=None if smp is None else smode.SafeModeConfig(
            resid_threshold=_tensor(smp["resid_threshold"], dev),
            trip_intervals=int(smp["trip_intervals"]),
            readmit_intervals=int(smp["readmit_intervals"])),
        sample_dt=float(d["sample_dt"]),
        software_enabled=bool(d.get("software_enabled", True)),
        track_health=bool(d.get("track_health", False)),
        degraded_mode=bool(d.get("degraded_mode", False)),
        safemode=bool(d.get("safemode", False)),
    )


def fault_schedule_from_numpy(d: dict, *, device="cuda") -> FLT.FaultSchedule:
    """``FaultSchedule`` from its seven fields (the int32 episode tables
    and ``p_fault``), e.g. ``numpy_tree`` of the JAX package's schedule."""
    return _fields(FLT.FaultSchedule, d, resolve_device(device))


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
    leaves}, "ess_online", "last_good", "safemode": {8 leaves}}``: the
    degraded-mode override, the sensor-bridge seed and the supervisor ride
    along (None where absent)."""
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
        safemode=None if d.get("safemode") is None else smode.SafeModeState(
            **{k: t(v) for k, v in d["safemode"].items()}),
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


def lm_model(cfg, *, device="cuda") -> T.Transformer | ED.EncDec:
    """The port's module tree for ``cfg`` with uninitialised parameters:
    an ``EncDec`` for ``audio`` (the reference's ``encdec.init`` tree), a
    ``Transformer`` otherwise."""
    return (ED.EncDec if cfg.family == "audio" else T.Transformer)(cfg, device=device)


def _stack_sizes(model: T.Transformer | ED.EncDec) -> dict:
    """``{stack: its leading axes}``: ``(n,)`` for a list of blocks,
    ``(n_groups, shared_every)`` for the hybrid ``groups``."""
    out = {}
    for st, depth in T.STACK_DEPTH.items():
        if hasattr(model, st):
            node, sizes = getattr(model, st), []
            for _ in range(depth):
                sizes.append(len(node))
                node = node[0]
            out[st] = tuple(sizes)
    return out


def _layer_names(head: str, sizes: tuple, rest: str):
    """``(index, port name)`` of every layer's copy of the stacked leaf
    ``{head}.{rest}``, in the stacked array's order."""
    for idx in itertools.product(*map(range, sizes)):
        yield idx, ".".join([head, *map(str, idx), rest])


def lm_tree_shapes(cfg) -> dict:
    """``{dotted path: (shape, dtype)}`` of the JAX package's parameter tree
    for ``cfg`` (``repro.models.transformer.init``; ``audio``:
    ``repro.models.encdec.init``): the port's own module tree
    (``lm_model``), with the per-layer ``{stack}.{i}.*`` leaves of each of
    ``transformer.STACKS`` stacked on a leading axis of the stack's length
    (``groups.{g}.{k}.*`` on two, ``(n_groups, shared_every)``)."""
    model = lm_model(cfg, device="meta")
    sizes = _stack_sizes(model)
    out = {}
    for name, p in model.named_parameters():
        head, _, tail = name.partition(".")
        if head in sizes:
            parts = tail.split(".", len(sizes[head]))
            if all(i == "0" for i in parts[:-1]):
                out[f"{head}.{parts[-1]}"] = ((*sizes[head], *p.shape), p.dtype)
        else:
            out[name] = (tuple(p.shape), p.dtype)
    return out


def random_lm_leaves(cfg, seed: int):
    """``(path, leaf)`` pairs of ``random_lm_tree(cfg, seed)``, drawn one at
    a time in the same order and with the same values, so that a caller can
    move each leaf on and drop it before the next is drawn."""
    rng = np.random.default_rng(seed)
    for path, (shape, _) in sorted(lm_tree_shapes(cfg).items()):
        kind, val = L.leaf_rule(path, shape)
        if kind == "constant":
            a = np.full(shape, val, np.float32)
        elif kind == "log_linspace":
            a = np.broadcast_to(L.log_linspace(*val, shape[-1]).numpy(), shape).copy()
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            np.clip(a, -2.0, 2.0, out=a)
            a *= np.float32(val)
        yield path, a
        del a  # the caller holds the only reference while the next leaf is drawn


def random_lm_tree(cfg, seed: int) -> dict:
    """A parameter tree in the JAX package's layout (nested dicts of numpy
    arrays, blocks stacked on axis 0) filled from
    ``numpy.random.default_rng(seed)``, leaf by leaf in sorted path order,
    with the reference's initialisers in distribution
    (``layers.leaf_rule``: a standard normal clipped at +-2 and scaled, a
    constant, or Mamba2's ``a_log`` vector; the draws are numpy's).  Leaves are float32: numpy has no
    bfloat16, so a bf16 config is cast on the device by
    ``lm_params_from_numpy`` (leaves that are float32 in the model, such as
    RWKV-6's ``decay_base`` and ``u_bonus`` or the MoE router, stay
    float32)."""
    return _unflatten(dict(random_lm_leaves(cfg, seed)))


@torch.no_grad()
def lm_params_from_leaves(leaves, cfg, *, device="cuda") -> T.Transformer | ED.EncDec:
    """A ``Transformer`` (``audio``: ``EncDec``) holding the parameter
    leaves ``leaves``, an
    iterable of ``(dotted path, numpy array)`` in the JAX package's layout
    (stacked layers on axis 0), consumed one at a time: each leaf is moved
    to the device as it is and cast there to the parameter's type.  Raises
    unless the leaves and their shapes match the model's exactly."""
    model = lm_model(cfg, device=device)
    dev = model.embed.embedding.device
    params = dict(model.named_parameters())
    sizes = _stack_sizes(model)
    want = lm_tree_shapes(cfg)
    seen = set()
    for path, arr in leaves:
        if path not in want:
            raise ValueError(f"parameter tree differs from the model: unexpected {path!r}")
        shape = want[path][0]
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{path}: shape {np.shape(arr)}, the model's is {shape}")
        t = torch.as_tensor(np.asarray(arr), device=dev)
        head, _, rest = path.partition(".")
        if head in sizes:
            for idx, name in _layer_names(head, sizes[head], rest):
                params[name].copy_(t[idx])
        else:
            params[path].copy_(t)
        seen.add(path)
        del t, arr
    if seen != set(want):
        raise ValueError(f"parameter tree differs from the model: missing {sorted(set(want) - seen)}")
    return model


def lm_params_from_numpy(tree: dict, cfg, *, device="cuda") -> T.Transformer | ED.EncDec:
    """A ``Transformer`` (``audio``: ``EncDec``) holding the JAX package's
    parameter tree ``tree``
    (nested dicts of numpy arrays, stacked layers on axis 0): see
    ``lm_params_from_leaves``."""
    device = resolve_device(device)
    flat = _flatten(tree)
    want = lm_tree_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter tree differs from the model: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}")
    return lm_params_from_leaves(flat.items(), cfg, device=device)


@torch.no_grad()
def lm_tree_to_numpy(named: dict, cfg) -> dict:
    """The JAX package's parameter-tree layout (nested dicts of float32
    numpy arrays, stacked layers on axis 0) of a dict keyed by the port's
    parameter names: the parameters themselves, their gradients or an
    optimizer moment.  bf16 leaves are widened to float32 (exactly; numpy
    has no bfloat16)."""
    flat = {}
    for path, (shape, _) in lm_tree_shapes(cfg).items():
        head, _, rest = path.partition(".")
        if head in T.STACK_DEPTH:
            lead = shape[:T.STACK_DEPTH[head]]
            t = torch.stack([named[name].detach() for _, name in _layer_names(head, lead, rest)])
            t = t.reshape(shape)
        else:
            t = named[path].detach()
        flat[path] = t.to(torch.float32).cpu().numpy()
    return _unflatten(flat)


def lm_params_to_numpy(model: T.Transformer | ED.EncDec) -> dict:
    """The inverse of ``lm_params_from_numpy``: ``model``'s parameters as
    the JAX package's tree (bf16 widened to float32)."""
    return lm_tree_to_numpy(dict(model.named_parameters()), model.cfg)
