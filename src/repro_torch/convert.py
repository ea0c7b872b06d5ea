"""Carry the JAX package's configs, plans and states across to the port.

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
