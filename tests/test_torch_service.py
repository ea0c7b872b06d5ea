"""The operator service of the port (``repro_torch.serve.conditioner``) on
the CPU: ``tests/test_service.py``'s seven tests mirrored on the port, the
single-campus service held against the JAX package's service on the same
faulty campus (the same audit events with the same samples, racks and
verdicts; the window aggregates within ``tests/test_torch_scanned.py``'s
envelopes), and ``tests/test_grid_region.py::test_service_runs_grid_region``
mirrored on the port.

The crash-resume contract is bit for bit: checkpoint at an interval
boundary, drop the service, restore into a fresh one, and the glued
telemetry equals the uninterrupted run array for array.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import compliance, grid, pdu
from repro_torch.power import faults as FLT, scenario as SC
from repro_torch.serve import AuditLog, ConditionerService

torch.set_num_threads(1)

pytestmark = pytest.mark.service

_HZ = 100.0
_DEV = "cpu"
_SPEC = compliance.GridSpec.create(device=_DEV)


def _scenario(duration_s=60.0, n_racks=5, faulty=True, sc=SC, flt=FLT, **kw):
    s = sc.mixed_campus(n_racks, ("llama3_2_1b", "qwen1_5_4b"), duration_s=duration_s,
                        sample_hz=_HZ, seed=4, **kw)
    if faulty:
        proc = flt.FaultProcess.create(ess_mtbf_s=25.0, ess_mttr_s=10.0, sensor_mtbf_s=30.0,
                                       sensor_mttr_s=5.0)
        s = sc.attach_faults(s, proc, seed=17)
    return s


def _cfg():
    return pdu.make_pdu(sample_dt=1.0 / _HZ, degraded_mode=True, device=_DEV)


def _service(s, **kw):
    return ConditionerService(_cfg(), s, _SPEC, chunk_intervals=4, **kw)


def _drain(svc):
    rack, grid_, frac = [], [], []
    while not svc.exhausted:
        r = svc.advance()
        rack.append(r.campus_rack.numpy())
        grid_.append(r.campus_grid.numpy())
        frac.append(r.ess_online_frac.numpy())
    return tuple(np.concatenate(x) for x in (rack, grid_, frac))


def _leaves_equal(a, b):
    from repro_torch.core import fleet

    la, lb = fleet._tree_leaves(a), fleet._tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.fixture(scope="module")
def faulty():
    return _scenario(device=_DEV)


# ----------------------------------------------- tests/test_service.py, mirrored


def test_crash_resume_is_bitwise(tmp_path, faulty):
    ref = _drain(_service(faulty))
    svc = _service(faulty)
    out = [[], [], []]

    def take(r):
        for buf, x in zip(out, (r.campus_rack, r.campus_grid, r.ess_online_frac)):
            buf.append(x.numpy())

    take(svc.advance())
    take(svc.advance())
    ck = svc.checkpoint(tmp_path / "mid_outage.npz")
    del svc  # crash

    svc2 = _service(faulty)
    svc2.restore(ck)
    while not svc2.exhausted:
        take(svc2.advance())
    for a, b in zip(ref, (np.concatenate(x) for x in out)):
        np.testing.assert_array_equal(a, b)


def test_restore_validates_geometry(tmp_path, faulty):
    svc = _service(faulty)
    svc.advance()
    ck = svc.checkpoint(tmp_path / "ck.npz")
    other = _service(_scenario(n_racks=3, device=_DEV))
    with pytest.raises(ValueError):
        other.restore(ck)


def test_manual_fault_injection_round_trip():
    svc = _service(_scenario(faulty=False, duration_s=40.0, device=_DEV))
    svc.inject_fault([0, 2])
    r = svc.advance()
    assert float(r.ess_online_frac.max()) == pytest.approx(3.0 / 5.0)
    assert svc.status()["manual_offline_racks"] == [0, 2]
    svc.clear_fault([0, 2])
    r = svc.advance()
    np.testing.assert_array_equal(r.ess_online_frac.numpy(), 1.0)
    events = [e["event"] for e in svc.audit.tail(20)]
    for must in ("manual_fault_injected", "manual_fault_cleared", "degraded_enter",
                 "degraded_exit"):
        assert must in events
    with pytest.raises(ValueError):
        svc.inject_fault(7)


def test_audit_log_is_strict_jsonl(tmp_path, faulty):
    path = tmp_path / "audit.jsonl"
    svc = _service(faulty, audit_path=path)
    while not svc.exhausted:
        svc.advance()
    lines = path.read_text().splitlines()
    assert len(lines) == len(svc.audit)
    parsed = [json.loads(line) for line in lines]
    kinds = {p["event"] for p in parsed}
    assert {"service_start", "window"} <= kinds
    assert {"fault", "repair"} <= kinds
    ev = next(p for p in parsed if p["event"] == "fault")
    assert {"channel", "rack", "sample"} <= set(ev)


def test_status_is_json_safe(faulty):
    svc = _service(faulty)
    svc.advance()
    st = svc.status()
    assert json.loads(json.dumps(st, allow_nan=False)) == st
    # Untracked health: the infinite projected life is clamped to null.
    assert st["health"]["projected_life_years_min"] is None


def test_advance_past_end_raises():
    svc = _service(_scenario(duration_s=20.0, faulty=False, device=_DEV))
    while not svc.exhausted:
        svc.advance()
    with pytest.raises(RuntimeError):
        svc.advance()


def test_audit_log_standalone(tmp_path):
    log = AuditLog(tmp_path / "a.jsonl")
    log.append("x", n=1)
    log.append("y", n=2)
    assert len(log) == 2
    assert [e["event"] for e in log.tail(1)] == ["y"]
    with pytest.raises(ValueError):
        log.append("bad", v=float("inf"))  # strict JSON at write


# -------------------------------------------------- against the JAX service

# Window aggregates against the JAX package's service, as
# tests/test_torch_scanned.py holds the scanned engine to JAX's: 2e-6 on
# the unconditioned campus mean, 2e-5 on the conditioned one (LC chain and
# 30 ADMM iterations), the online fraction exactly; the window's QP
# residual 1e-3 relative (chip_smoke.FAULTY_CAMPUS_TOLERANCES).
_RACK_TOL, _GRID_TOL, _QP_REL = 2e-6, 2e-5, 1e-3
_NUMBERS = {"max_qp_residual", "min_online_frac"}
_LEFT_ASIDE = {"seq", "path", "fingerprint"}


def _comparable(events):
    return [{k: v for k, v in e.items() if k not in _LEFT_ASIDE | _NUMBERS} for e in events]


def test_campus_service_matches_the_jax_service(tmp_path, faulty):
    from repro.core import compliance as jcomp, pdu as jpdu
    from repro.power import faults as JFLT, scenario as JSC
    from repro.serve import ConditionerService as JService

    jsvc = JService(jpdu.make_pdu(sample_dt=1.0 / _HZ, degraded_mode=True),
                    _scenario(sc=JSC, flt=JFLT), jcomp.GridSpec.create(), chunk_intervals=4)
    tsvc = _service(faulty)
    for svc in (jsvc, tsvc):
        svc.advance()
        svc.inject_fault([1, 3], reason="drill")
        svc.advance()
        svc.clear_fault([1])
        svc.checkpoint(tmp_path / f"{type(svc).__module__}.npz")
    while not tsvc.exhausted:
        j, t = jsvc.advance(), tsvc.advance()
        np.testing.assert_allclose(t.campus_rack.numpy(), np.asarray(j.campus_rack),
                                   rtol=0, atol=_RACK_TOL)
        np.testing.assert_allclose(t.campus_grid.numpy(), np.asarray(j.campus_grid),
                                   rtol=0, atol=_GRID_TOL)
        np.testing.assert_array_equal(t.ess_online_frac.numpy(), np.asarray(j.ess_online_frac))
    assert jsvc.exhausted
    je, te = jsvc.audit.tail(10_000), tsvc.audit.tail(10_000)
    assert [e["event"] for e in te] == [e["event"] for e in je]
    assert _comparable(te) == _comparable(je)
    for a, b in zip(te, je):
        if "max_qp_residual" in a:
            assert a["max_qp_residual"] == pytest.approx(b["max_qp_residual"], rel=_QP_REL)
        if "min_online_frac" in a:
            assert a["min_online_frac"] == b["min_online_frac"]
    assert {"fault", "repair", "degraded_enter", "manual_fault_injected",
            "checkpoint_saved"} <= {e["event"] for e in te}
    st, sj = tsvc.status(), jsvc.status()
    assert st["manual_offline_racks"] == sj["manual_offline_racks"] == [3]
    assert st["last_window"]["ramp_ok"] == sj["last_window"]["ramp_ok"]


def test_service_refuses_a_mesh():
    """A service's mesh must be a DeviceMesh (a real one on a campus target
    raises "mesh is only meaningful for GridRegion targets":
    tests/test_torch_distributed.py)."""
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh with "
                                        "named axes .* got object"):
        _service(_scenario(duration_s=20.0, faulty=False, device=_DEV), mesh=object())


# --------------------------------- tests/test_grid_region.py's service test


@pytest.mark.grid
def test_service_runs_grid_region(tmp_path):
    cfg = pdu.make_pdu(sample_dt=1.0 / 50.0, device=_DEV)
    reg = grid.checkpoint_region(3, 4, duration_s=60.0, sample_hz=50.0, device=_DEV)
    svc = ConditionerService(cfg, reg, _SPEC, chunk_intervals=4,
                             audit_path=tmp_path / "audit.jsonl")
    assert svc.n_racks == 12
    svc.advance()
    # Global rack 5 lives in campus 1 (racks 4-7) as local rack 1.
    svc.inject_fault([5])
    assert float(svc.state[1].ess_online[1]) == 0.0
    st = svc.status()
    assert st["manual_offline_racks"] == [5]
    assert st["region"]["campus_racks"] == [4, 4, 4]
    assert {"peak_power_pu", "max_freq_dev_hz", "mode_bands"} <= set(st["poi"])
    assert len(st["campuses"]) == 3
    svc.clear_fault([5])

    ck = svc.checkpoint(tmp_path / "ck")
    r_live = svc.advance()
    svc2 = ConditionerService(cfg, reg, _SPEC, chunk_intervals=4)
    svc2.restore(ck)
    r_resumed = svc2.advance()
    for f in ("poi_grid", "campus_rack", "poi_freq_dev"):
        assert torch.equal(getattr(r_live, f), getattr(r_resumed, f)), f
    _leaves_equal(svc.state, svc2.state)

    while not svc.exhausted:
        svc.advance()
    mv = [e for e in svc.audit.tail(10_000) if e["event"] == "mode_band_violation"]
    # Synchronized checkpoints ring the inter-area band, and the violation
    # lands in the audit log as an event of its own.
    assert mv
    assert all(e["band"] == "inter_area" for e in mv)
    assert all(e["magnitude"] > e["threshold"] for e in mv)
