"""Crash and fault injection against the port's supervised operator service
(``tests/test_chaos.py`` mirrored on ``repro_torch.serve``), on the CPU.

Two tiers, as in the reference:

* the fast deterministic tests (unmarked, tier-1): atomic checkpoint
  semantics, torn-file recovery, kill and resume bit for bit, restore
  validation (dtype and fingerprint), audit durability and rotation, a
  fixed fault drill; and a checkpoint of the JAX package's service, which
  ``recover`` must skip, never misread;
* the randomized sweep (``@pytest.mark.chaos``, opt-in with ``pytest -m
  chaos``): seeded kill points and fault soups replayed per seed.

Invariants held everywhere: every carried state leaf finite; the SoC inside
the safe window; contained racks command nothing; recovery reproduces the
uninterrupted run bit for bit; the audit log parses with monotone ``seq``
after any simulated crash.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import compliance, fleet, pdu, safemode as smode
from repro_torch.power import faults as FLT, scenario as SC
from repro_torch.serve import AuditLog, ConditionerService

torch.set_num_threads(1)

_HZ = 100.0
_DEV = "cpu"
_SPEC = compliance.GridSpec.create(device=_DEV)


def _scenario(duration_s=60.0, n_racks=5, faulty=False, seed=4):
    s = SC.mixed_campus(n_racks, ("llama3_2_1b", "qwen1_5_4b"), duration_s=duration_s,
                        sample_hz=_HZ, seed=seed, device=_DEV)
    if faulty:
        proc = FLT.FaultProcess.create(ess_mtbf_s=25.0, ess_mttr_s=10.0, sensor_mtbf_s=30.0,
                                       sensor_mttr_s=5.0)
        s = SC.attach_faults(s, proc, seed=17)
    return s


def _cfg():
    return pdu.make_pdu(
        sample_dt=1.0 / _HZ, degraded_mode=True, safemode=True, device=_DEV,
        safemode_params=smode.SafeModeConfig.create(trip_intervals=2, readmit_intervals=3,
                                                    device=_DEV))


def _service(s, **kw):
    return ConditionerService(_cfg(), s, _SPEC, chunk_intervals=4, **kw)


def _put(x, racks, value, dim=0):
    x = x.clone()
    x.index_fill_(dim, torch.as_tensor(racks), value)
    return x


def _poison_warm(st, racks, value=1e12):
    return st._replace(qp_warm=st.qp_warm._replace(x=_put(st.qp_warm.x, racks, value, dim=1)))


def _corrupt_soc(st, racks):
    return st._replace(ess_state=st.ess_state._replace(soc=_put(st.ess_state.soc, racks,
                                                                float("nan"))))


def _assert_invariants(svc):
    lo = float(svc.cfg.ess_params.soc_safe_min)
    hi = float(svc.cfg.ess_params.soc_safe_max)
    states = svc.state if svc._is_region else (svc.state,)
    for st in states:
        for leaf in fleet._tree_leaves(st):
            assert torch.all(torch.isfinite(leaf.double()))
        soc = st.ess_state.soc
        assert torch.all(soc >= lo - 1e-6) and torch.all(soc <= hi + 1e-6)
        gate = smode.gate(st.safemode)
        assert torch.all(st.cmd_target[gate == 0.0] == 0.0)
        assert torch.all(st.u_prev[gate == 0.0] == 0.0)


def _drain_by_window(svc):
    """Advance to exhaustion; {start_sample: campus_grid} per window."""
    out = {}
    while not svc.exhausted:
        start = svc.sample_pos
        out[start] = svc.advance().campus_grid.numpy()
    return out


# ------------------------------------------------- fast deterministic tier


def test_checkpoint_leaves_no_temp_residue(tmp_path):
    svc = _service(_scenario(duration_s=20.0))
    svc.advance()
    p = svc.checkpoint(tmp_path / "a.npz")
    assert os.path.exists(p)
    assert os.listdir(tmp_path) == ["a.npz"]


def test_interrupted_checkpoint_preserves_previous(tmp_path, monkeypatch):
    """A crash mid-checkpoint (at the rename) leaves the previous checkpoint
    intact and loadable: the atomic-write contract."""
    s = _scenario(duration_s=60.0)
    svc = _service(s)
    svc.advance()
    p = svc.checkpoint(tmp_path / "a.npz")
    pos0 = svc.sample_pos
    svc.advance()

    real_replace = os.replace

    def boom(src, dst):
        os.remove(src)  # the temp file dies with the process
        raise OSError("simulated crash at rename")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        svc.checkpoint(tmp_path / "a.npz")
    monkeypatch.setattr(os, "replace", real_replace)

    svc2 = _service(s)
    svc2.restore(p)
    assert svc2.sample_pos == pos0
    assert os.listdir(tmp_path) == ["a.npz"]


def test_recover_skips_torn_files_and_picks_newest(tmp_path):
    s = _scenario(duration_s=30.0)
    svc = _service(s)
    svc.advance()
    svc.checkpoint(tmp_path / "ckpt_a.npz")
    svc.advance()
    p_new = svc.checkpoint(tmp_path / "ckpt_b.npz")
    pos = svc.sample_pos
    # A torn npz (truncated zip), a zero-byte file and a foreign npz.
    with open(tmp_path / "torn.npz", "wb") as f:
        f.write(b"PK\x03\x04" + b"\x00" * 32)
    (tmp_path / "empty.npz").write_bytes(b"")
    np.savez(tmp_path / "foreign.npz", sample_pos=np.int64(10**9))

    svc2 = _service(s)
    assert svc2.recover(tmp_path) == str(p_new)
    assert svc2.sample_pos == pos
    skipped = [e for e in svc2.audit.tail(50) if e["event"] == "recover_skipped"]
    assert len(skipped) == 3


def test_recover_empty_dir_returns_none(tmp_path):
    svc = _service(_scenario(duration_s=20.0))
    assert svc.recover(tmp_path) is None
    assert svc.audit.tail(1)[0]["event"] == "recover_failed"


def test_kill_and_recover_resumes_bitwise(tmp_path):
    """Kill after an auto-checkpoint; a fresh service recovers, and the
    glued per-window outputs equal the uninterrupted run bit for bit."""
    s = _scenario(duration_s=60.0, faulty=True)
    ref = _drain_by_window(_service(s))

    svc = _service(s, checkpoint_dir=tmp_path / "ck", checkpoint_every=1)
    got = {}
    for _ in range(3):
        start = svc.sample_pos
        got[start] = svc.advance().campus_grid.numpy()
    del svc  # kill: no clean shutdown, no final checkpoint

    svc2 = _service(s)
    assert svc2.recover(tmp_path / "ck") is not None
    got.update(_drain_by_window(svc2))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])


def test_restore_rejects_dtype_mismatch(tmp_path):
    """A checkpoint whose leaf dtype disagrees with the live state raises a
    config-mismatch error, never a silent cast."""
    s = _scenario(duration_s=20.0)
    svc = _service(s)
    svc.advance()
    p = svc.checkpoint(tmp_path / "a.npz")
    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    data["leaf_0"] = data["leaf_0"].astype(np.float64)
    np.savez(tmp_path / "widened.npz", **data)
    with pytest.raises(ValueError, match="dtype.*config/scenario mismatch"):
        _service(s).restore(tmp_path / "widened.npz")


def test_restore_rejects_fingerprint_mismatch(tmp_path):
    s = _scenario(duration_s=20.0)
    svc = _service(s)
    svc.advance()
    p = svc.checkpoint(tmp_path / "a.npz")
    other_spec = compliance.GridSpec.create(beta=0.2, device=_DEV)
    svc2 = ConditionerService(svc.cfg, s, other_spec, chunk_intervals=4)
    with pytest.raises(ValueError, match="fingerprint"):
        svc2.restore(p)


def test_audit_rotation_bounded_and_parseable(tmp_path):
    path = tmp_path / "audit.jsonl"
    log = AuditLog(path, fsync=True, max_bytes=600, backups=2)
    for i in range(60):
        log.append("tick", i=i, payload="x" * 40)
    files = sorted(os.listdir(tmp_path))
    assert path.name in files
    assert f"{path.name}.1" in files and f"{path.name}.2" in files
    assert f"{path.name}.3" not in files  # bounded retention
    for f in files:
        with open(tmp_path / f) as fh:
            seqs = [json.loads(line)["seq"] for line in fh]
        assert seqs == sorted(seqs)


def test_audit_seq_continues_after_crash(tmp_path):
    path = tmp_path / "audit.jsonl"
    log = AuditLog(path, fsync=True)
    for i in range(5):
        log.append("tick", i=i)
    del log  # crash
    log2 = AuditLog(path, fsync=True)
    log2.append("after")
    with open(path) as f:
        assert [json.loads(line)["seq"] for line in f] == list(range(6))


def test_fast_chaos_drill(tmp_path):
    """Fixed drill: divergence on one rack, NaN corruption on another and a
    manual ESS trip on a third, injected between windows.  The service
    contains all three, keeps every invariant, logs entries and exits, and
    still gives a strict-JSON status."""
    svc = _service(_scenario(duration_s=60.0), audit_path=tmp_path / "audit.jsonl")
    svc.advance()
    _assert_invariants(svc)
    svc.state = _poison_warm(svc.state, [1])
    svc.state = _corrupt_soc(svc.state, [3])
    svc.inject_fault(0, reason="drill")
    while not svc.exhausted:
        res = svc.advance()
        _assert_invariants(svc)
        assert torch.all(torch.isfinite(res.campus_grid))
    assert int(svc.state.safemode.quarantine_entries[3]) >= 1
    assert int(svc.state.safemode.passthrough_entries[1]) >= 1
    events = [e["event"] for e in svc.audit.tail(200)]
    assert "safemode_enter" in events and "safemode_exit" in events
    st = svc.status()
    assert st["safemode"]["quarantine_entries"] >= 1
    json.dumps(st, allow_nan=False)


def test_fast_chaos_drill_matches_the_jax_service(tmp_path):
    """The fixed drill on the JAX package's service and the port's, with the
    same supervised config: the same audit events in the same order, and
    every ``safemode_enter`` / ``safemode_exit`` equal field for field (its
    sample, its ``new_*`` and ``readmissions`` counter deltas, its rack
    lists), as are the per-rack safe-mode counters at the end."""
    import jax.numpy as jnp

    from repro.core import compliance as jcomp, pdu as jpdu, safemode as jsmode
    from repro.power import scenario as JSC
    from repro.serve import ConditionerService as JService

    jcfg = jpdu.make_pdu(sample_dt=1.0 / _HZ, degraded_mode=True, safemode=True,
                         safemode_params=jsmode.SafeModeConfig.create(trip_intervals=2,
                                                                      readmit_intervals=3))
    jscen = JSC.mixed_campus(5, ("llama3_2_1b", "qwen1_5_4b"), duration_s=60.0, sample_hz=_HZ,
                             seed=4)
    jsvc = JService(jcfg, jscen, jcomp.GridSpec.create(), chunk_intervals=4,
                    audit_path=tmp_path / "jax.jsonl")
    tsvc = _service(_scenario(duration_s=60.0), audit_path=tmp_path / "port.jsonl")
    jsvc.advance()
    tsvc.advance()
    jst = jsvc.state
    jx = jst.qp_warm.x.at[:, jnp.asarray([1])].set(1e12)
    jst = jst._replace(qp_warm=jst.qp_warm._replace(x=jx))
    jsoc = jst.ess_state.soc.at[jnp.asarray([3])].set(jnp.nan)
    jsvc.state = jst._replace(ess_state=jst.ess_state._replace(soc=jsoc))
    tsvc.state = _corrupt_soc(_poison_warm(tsvc.state, [1]), [3])
    for svc in (jsvc, tsvc):
        svc.inject_fault(0, reason="drill")
        while not svc.exhausted:
            svc.advance()
    je, te = jsvc.audit.tail(10_000), tsvc.audit.tail(10_000)
    assert [e["event"] for e in te] == [e["event"] for e in je]
    sm = lambda events: [{k: v for k, v in e.items() if k != "seq"} for e in events
                         if e["event"] in ("safemode_enter", "safemode_exit")]
    assert sm(te) == sm(je)
    assert {"safemode_enter", "safemode_exit"} <= {e["event"] for e in te}
    for f in ("passthrough_entries", "quarantine_entries", "readmissions", "mode"):
        np.testing.assert_array_equal(getattr(tsvc.state.safemode, f).numpy(),
                                      np.asarray(getattr(jsvc.state.safemode, f)))
    assert tsvc.status()["safemode"] == jsvc.status()["safemode"]


def test_recover_skips_a_jax_package_checkpoint(tmp_path):
    """The port's checkpoint format is its own: a checkpoint of the JAX
    package's service (its magic, its leaves) is skipped with
    ``recover_skipped``, and the port's own is picked even though the JAX
    one claims a later position."""
    from repro.core import compliance as jcomp, pdu as jpdu, safemode as jsmode
    from repro.power import scenario as JSC
    from repro.serve import ConditionerService as JService

    js = JSC.mixed_campus(5, ("llama3_2_1b", "qwen1_5_4b"), duration_s=40.0, sample_hz=_HZ,
                          seed=4)
    jcfg = jpdu.make_pdu(sample_dt=1.0 / _HZ, degraded_mode=True, safemode=True,
                         safemode_params=jsmode.SafeModeConfig.create(trip_intervals=2,
                                                                      readmit_intervals=3))
    jsvc = JService(jcfg, js, jcomp.GridSpec.create(), chunk_intervals=4)
    jsvc.advance()
    jsvc.advance()
    jsvc.checkpoint(tmp_path / "jax.npz")
    svc = _service(_scenario(duration_s=40.0))
    svc.advance()
    mine = svc.checkpoint(tmp_path / "port.npz")
    svc2 = _service(_scenario(duration_s=40.0))
    assert svc2.recover(tmp_path) == mine and svc2.sample_pos == 2000
    skipped = [e for e in svc2.audit.tail(20) if e["event"] == "recover_skipped"]
    assert [e["path"] for e in skipped] == [str(tmp_path / "jax.npz")]
    with pytest.raises(ValueError, match="not a checkpoint of this service"):
        svc2.restore(tmp_path / "jax.npz")


# ------------------------------------------------------- randomized sweep


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_kill_points_resume_bitwise(tmp_path, seed):
    """Kill at a random window (tearing the newest checkpoint half the
    time); recovery lands on a valid checkpoint and the glued outputs equal
    the uninterrupted run bit for bit."""
    rng = np.random.default_rng(1000 + seed)
    s = _scenario(duration_s=60.0, faulty=True, seed=int(rng.integers(100)))
    ref = _drain_by_window(_service(s))
    n_windows = len(ref)

    ck = tmp_path / f"ck{seed}"
    svc = _service(s, checkpoint_dir=ck, checkpoint_every=1)
    kill_at = int(rng.integers(1, n_windows))
    got = {}
    for _ in range(kill_at):
        start = svc.sample_pos
        got[start] = svc.advance().campus_grid.numpy()
    del svc  # kill

    ckpts = sorted(os.listdir(ck))
    if len(ckpts) >= 2 and rng.random() < 0.5:
        p = ck / ckpts[-1]
        p.write_bytes(p.read_bytes()[: int(rng.integers(1, 200))])

    svc2 = _service(s)
    assert svc2.recover(ck) is not None
    assert svc2.sample_pos <= kill_at * 4 * svc2._k
    got.update(_drain_by_window(svc2))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_fault_soup_holds_invariants(tmp_path, seed):
    """Scheduled ESS trips, divergence poison and NaN corruption at random
    window boundaries: every window keeps the invariants and the run ends
    with a parseable audit log."""
    rng = np.random.default_rng(2000 + seed)
    n_racks = int(rng.integers(4, 8))
    s = _scenario(duration_s=60.0, n_racks=n_racks, faulty=bool(rng.random() < 0.7),
                  seed=int(rng.integers(100)))
    svc = _service(s, audit_path=tmp_path / f"audit{seed}.jsonl")
    while not svc.exhausted:
        if rng.random() < 0.4:
            svc.state = _poison_warm(svc.state, [int(rng.integers(n_racks))],
                                     value=float(rng.choice([1e9, 1e12, np.inf])))
        if rng.random() < 0.3:
            svc.state = _corrupt_soc(svc.state, [int(rng.integers(n_racks))])
        if rng.random() < 0.2:
            svc.inject_fault(int(rng.integers(n_racks)), reason="chaos")
        res = svc.advance()
        _assert_invariants(svc)
        assert torch.all(torch.isfinite(res.campus_grid))
        assert torch.all(torch.isfinite(res.campus_rack))
    with open(tmp_path / f"audit{seed}.jsonl") as f:
        seqs = [json.loads(line)["seq"] for line in f]
    assert seqs == sorted(seqs)
    json.dumps(svc.status(), allow_nan=False)
