"""The port's scanned engine (``fleet.condition``'s default) and
``core.profiling``.

On the card the scanned engine replays one CUDA graph of the whole window;
on the CPU (these tests) the same chunk loop runs eagerly, with the start
as a tensor as the graph reads it, so everything but the capture and its
static buffers is checked here (``chip_smoke.py`` holds the graph to the host engine bit for bit on
the card).  The campus is ``test_torch_fleet.py``'s: 16 racks, 22.5 s at
200 Hz, chunks of two controller intervals (2000 samples; the last chunk a
ragged 500), clean with the wear fold on, and degraded under an attached
fault schedule (the JAX package's, carried across bit for bit) whose ESS
and sensor outages span the chunk boundary at sample 2000.

* Against the JAX package's host engine: ``test_torch_fleet.py``'s
  scenario-target tolerances (each package renders its own trace, ~1e-6
  apart), and the ESS online fraction and verdicts exactly; against its
  one-shot engine the campus means, the ramp maxima, the online fraction
  and the wear report with the same tolerances.  Not against its scanned
  engine, whose ragged tail is off by one ulp (ROADMAP.md §3).
* Against the port's host engine, a window split at a chunk boundary and
  resumed, chunk sizes 2 and 4, and one checkpoint resumed twice: bit for
  bit.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, controller as jctrl, fleet as jfleet, pdu as jpdu
from repro.power import faults as JF, scenario as JSC
from repro_torch import convert
from repro_torch.core import compliance as tcomp, fleet as tfleet, pdu as tpdu, \
    profiling as tprof
from repro_torch.kernels import ref as tref
from repro_torch.power import scenario as TSC

torch.set_num_threads(1)
HZ = 200.0
K = 1000  # samples per controller interval (5 s at 200 Hz)
CHUNK = 2 * K
KW = dict(duration_s=22.5, sample_hz=HZ, seed=3, fault_at_s=12.0, noise_seed=2)
ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")
FIELDS = ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac", "max_qp_residual",
          "health_trace")


def _jax_faults(js):
    proc = JF.FaultProcess.create(rack_mtbf_s=40.0, rack_mttr_s=6.0, ess_mtbf_s=30.0,
                                  ess_mttr_s=8.0, sensor_mtbf_s=40.0, sensor_mttr_s=3.0)
    s = JF.sample_schedule(proc, 16, js.total_samples, HZ, seed=7)
    # Outages across the chunk boundary at CHUNK, for the window tests.
    return JF.inject_episodes(s, ess=[(1, CHUNK - 700, CHUNK + 600)],
                              sensor=[(3, CHUNK - 200, CHUNK + 300)])


@pytest.fixture(scope="module")
def setup():
    """Both packages' scenarios, configs, initial states and plans, clean
    and degraded, and the JAX package's host and one-shot runs."""
    js = JSC.mixed_campus(16, ARCHS, **KW)
    ts = TSC.mixed_campus(16, ARCHS, device="cpu", **KW)
    jsched = _jax_faults(js)
    cases = {}
    for name, deg in (("clean", False), ("degraded", True)):
        jscen = JSC.attach_faults(js, jsched) if deg else js
        tscen = TSC.attach_faults(ts, convert.fault_schedule_from_numpy(
            convert.numpy_tree(jsched), device="cpu")) if deg else ts
        r0 = np.asarray(JSC.render(jscen, 0, 1))[0]
        jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=not deg, degraded_mode=deg)
        jst = jpdu.init_state(jcfg, jnp.asarray(r0))
        jplan = jctrl.make_plan(jcfg.controller, jcfg.ess_params)
        jspec = jcomp.GridSpec.create()
        stream = jfleet.StreamOptions(chunk_intervals=2, state=jst)
        cases[name] = dict(
            ts=tscen,
            jres={
                "host": jfleet.condition(jscen, jcfg, jspec, engine="host", stream=stream,
                                         qp_iters=30),
                "oneshot": jfleet.condition(jscen, jcfg, jspec, engine="oneshot", qp_iters=30),
            },
            cfg=convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu"),
            state=convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu"),
            plan=convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu"),
            spec=tcomp.GridSpec.create(device="cpu"),
            runs={},
        )
    return cases


def _run(case, *, engine="scanned", chunk_intervals=2, state="carried", scenario=None, **window):
    state = case["state"] if isinstance(state, str) else state
    stream = tfleet.StreamOptions(chunk_intervals=chunk_intervals, state=state, **window)
    return tfleet.condition(case["ts"] if scenario is None else scenario, case["cfg"],
                            case["spec"], engine=engine, stream=stream, device="cpu",
                            qp_iters=30, plan=case["plan"])


def _cached(case, name, **kw):
    """A run computed once per module."""
    if name not in case["runs"]:
        case["runs"][name] = _run(case, **kw)
    return case["runs"][name]


def _leaves(x):
    return tfleet._tree_leaves(x)


def _assert_bitwise(a, b, fields=FIELDS, reports=("report_rack", "report_grid")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(_leaves(a.state), _leaves(b.state), strict=True):
        assert x.shape == y.shape and torch.equal(x, y)
    for which in reports:
        for x, y in zip(getattr(a, which), getattr(b, which), strict=True):
            assert (x is None) == (y is None), which
            assert x is None or torch.equal(x, y), which


def _close(a, b, atol, what, rtol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _health_close(t, j):
    # test_torch_fleet.py's scenario-target tolerances for the wear report.
    for name in j._fields:
        rtol = 2e-5 if name in ("mean_soc", "calendar_life_frac", "capacity_fade",
                                "projected_life_s") else 0.0
        atol = 2e-5 if name == "soc_std" else 2e-6
        _close(getattr(t, name), getattr(j, name), atol, name, rtol)


@pytest.mark.parametrize("name", ["clean", "degraded"])
def test_scanned_matches_jax_host_and_oneshot(setup, name):
    case = setup[name]
    t = _cached(case, "scanned")
    j, jo = case["jres"]["host"], case["jres"]["oneshot"]
    assert t.campus_grid.shape == j.campus_grid.shape == (4500,)
    _close(t.campus_rack, j.campus_rack, 2e-6, "campus_rack")
    _close(t.campus_grid, j.campus_grid, 2e-5, "campus_grid")
    _close(t.soc_mean, j.soc_mean, 2e-6, "soc_mean")
    _close(t.max_qp_residual, j.max_qp_residual, 0.0, "max_qp_residual", rtol=2e-6)
    _close(t.health_trace, j.health_trace, 2e-6, "health_trace", rtol=2e-5)
    np.testing.assert_array_equal(t.ess_online_frac.numpy(), np.asarray(j.ess_online_frac))
    for which in ("rack", "grid"):
        rt, rj = t.report(which), j.report(which)
        _close(rt.max_ramp, rj.max_ramp, 0.0, f"{which} max_ramp", rtol=2e-3)
        _close(rt.worst_high_freq_mag, rj.worst_high_freq_mag, 2e-5, f"{which} spectrum")
        for v in ("ramp_ok", "spectrum_ok", "ok"):
            assert bool(getattr(rt, v)) == bool(getattr(rj, v)), f"{which} {v}"
        _close(rt.max_ramp, getattr(jo, f"report_{which}").max_ramp, 0.0,
               f"{which} max_ramp vs one-shot", rtol=2e-3)
    _close(t.campus_rack, jo.campus_rack, 2e-6, "campus_rack vs one-shot")
    _close(t.campus_grid, jo.campus_grid, 2e-5, "campus_grid vs one-shot")
    np.testing.assert_array_equal(t.ess_online_frac.numpy(), np.asarray(jo.ess_online_frac))
    _health_close(t.health, j.health)
    _health_close(t.health, jo.health)
    if name == "degraded":
        assert float(t.ess_online_frac.min()) < 1.0
        assert torch.isfinite(t.campus_grid).all()


@pytest.mark.parametrize("name", ["clean", "degraded"])
def test_scanned_equals_port_host_bitwise(setup, name):
    case = setup[name]
    _assert_bitwise(_cached(case, "scanned"), _cached(case, "host", engine="host"))


@pytest.mark.parametrize("name", ["clean", "degraded"])
def test_window_split_and_resume_bitwise(setup, name):
    """A run stopped at a chunk boundary and resumed from its state with
    ``start_sample`` equals the one-call run (the degraded case resumes
    mid-outage)."""
    case = setup[name]
    whole = _cached(case, "scanned")
    first = _cached(case, "first", stop_sample=CHUNK)
    second = _run(case, state=first.state, start_sample=CHUNK)
    for f in ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac", "health_trace"):
        assert torch.equal(torch.cat([getattr(first, f), getattr(second, f)]),
                           getattr(whole, f)), f
    assert torch.equal(torch.maximum(first.max_qp_residual, second.max_qp_residual),
                       whole.max_qp_residual)
    for x, y in zip(_leaves(second.state), _leaves(whole.state), strict=True):
        assert torch.equal(x, y)
    if name == "degraded":
        f = case["ts"].faults
        idx = torch.tensor([CHUNK - 1, CHUNK])
        ess_out = ((f.ess_start[:, :, None] <= idx) & (idx < f.ess_end[:, :, None])).any(1)
        dark = ((f.sensor_start[:, :, None] <= idx) & (idx < f.sensor_end[:, :, None])).any(1)
        assert bool(ess_out.all(1).any()) and bool(dark.all(1).any()), "not mid-outage"


def test_checkpoint_resumed_twice(setup):
    """The same checkpoint seeds two equal continuations; the engine never
    writes the caller's state, and a returned result is not overwritten by
    a later call."""
    case = setup["clean"]
    ckpt = _cached(case, "first", stop_sample=CHUNK).state
    before = [x.clone() for x in _leaves(ckpt)]
    a = _run(case, state=ckpt, start_sample=CHUNK)
    kept = a.campus_grid.clone()
    b = _run(case, state=ckpt, start_sample=CHUNK)
    _assert_bitwise(a, b)
    assert torch.equal(a.campus_grid, kept)
    for x, y in zip(_leaves(ckpt), before, strict=True):
        assert torch.equal(x, y)
    assert a.campus_grid.data_ptr() != b.campus_grid.data_ptr()


def test_chunk_invariance(setup):
    """Chunks of 2 and 4 intervals give the same campus, state and ramps;
    the spec lines sum each chunk's float64 line sums into float32
    accumulators, so they agree within the observers' 1e-5 contract."""
    case = setup["clean"]
    a, b = _run(case, chunk_intervals=4), _cached(case, "scanned")
    _assert_bitwise(a, b, fields=("campus_rack", "campus_grid", "soc_mean", "ess_online_frac",
                                  "max_qp_residual"), reports=())
    for which in ("rack", "grid"):
        ra, rb = a.report(which), b.report(which)
        assert torch.equal(ra.max_ramp, rb.max_ramp) and bool(ra.ok) == bool(rb.ok)
        _close(ra.worst_high_freq_mag, rb.worst_high_freq_mag, 1e-5, f"{which} spectrum")


def test_shapes_ragged_tail_and_unbatched_scenario():
    """The ragged tail runs at its natural length (its half interval is
    ZOH-padded inside ``pdu.condition``); an unbatched scenario is lifted
    to one rack, bit for bit the batched scenario of that rack."""
    cfg = tpdu.make_pdu(sample_dt=1.0 / HZ, device="cpu")
    spec = tcomp.GridSpec.create(device="cpu")
    w = TSC.workload_from_model("llama3_2_1b", device="cpu")
    runs = {}
    for name, params in (("unbatched", w), ("batched", TSC.stack_workloads([w]))):
        s = TSC.make_scenario(params, duration_s=12.5, sample_hz=HZ, noise_seed=4)
        assert TSC.render(s, 0, 3).ndim == (1 if name == "unbatched" else 2)
        runs[name] = tfleet.condition(s, cfg, spec, qp_iters=20, device="cpu",
                                      stream={"chunk_intervals": 2})
    a, b = runs["unbatched"], runs["batched"]
    assert a.campus_grid.shape == (2500,) and a.soc_mean.shape == (3,)
    assert a.health_trace.shape == (2, 3) and a.ess_online_frac.shape == (3,)
    assert a.state.ess_state.soc.shape == (1,)
    _assert_bitwise(a, b)


def test_errors(setup):
    case = setup["clean"]
    ts = case["ts"]
    with pytest.raises(ValueError, match="outside the scenario"):
        _run(case, stop_sample=ts.total_samples + 1)
    with pytest.raises(ValueError, match="must be a non-negative multiple of the controller"):
        _run(case, start_sample=K + 1)
    with pytest.raises(ValueError, match="must be a non-negative multiple of the controller"):
        _run(case, start_sample=-K)
    with pytest.raises(ValueError, match="past the scenario end"):
        _run(case, start_sample=2 * K, stop_sample=2 * K)
    tr = TSC.render(ts, 0, 2 * K)
    for target in (tr, TSC.chunk_provider(ts)):
        with pytest.raises(ValueError, match="engine='scanned' renders a declarative Scenario"):
            tfleet.condition(target, case["cfg"], case["spec"], device="cpu")
    with pytest.raises(ValueError, match="'start_sample' is not supported by the 'host'"):
        _run(case, engine="host", start_sample=CHUNK)
    with pytest.raises(ValueError, match="'stop_sample' is not supported by the 'host'"):
        tfleet.condition(tr, case["cfg"], case["spec"], engine="host", device="cpu",
                         stream={"stop_sample": K})
    with pytest.raises(ValueError, match="'state' is not supported by the 'oneshot'"):
        _run(case, engine="oneshot")
    with pytest.raises(ValueError, match="'total_samples' is not supported by the 'scanned'"):
        _run(case, total_samples=K)
    with pytest.raises(ValueError, match="fault schedule attached"):
        _run(case, scenario=setup["degraded"]["ts"])


@contextlib.contextmanager
def _no_host_reads():
    """Raise on every read of a tensor back to the host and every tensor
    made from host data inside the block, except inside the plain versions
    of the two kernels (on the card the kernels run there): what a CUDA
    graph capture refuses."""
    T = torch.Tensor
    names = ("item", "__float__", "__int__", "__bool__", "__index__", "tolist", "numpy", "cpu")
    saved = {n: getattr(T, n) for n in names}
    plain = {n: getattr(tref, n) for n in ("pdu_health_sim", "admm_iterate")}
    real_tensor, real_as_tensor = torch.tensor, torch.as_tensor
    depth = [0]

    def guard(n):
        def call(*a, **kw):
            if depth[0]:
                return saved[n](*a, **kw)
            raise AssertionError(f"host read: Tensor.{n}")
        return call

    def as_tensor(data, *a, **kw):
        if not depth[0] and not isinstance(data, torch.Tensor):
            raise AssertionError(f"host copy: torch.as_tensor of a {type(data).__name__}")
        return real_as_tensor(data, *a, **kw)

    def tensor(data, *a, **kw):
        if not depth[0]:
            raise AssertionError("host copy: torch.tensor")
        return real_tensor(data, *a, **kw)

    def unguarded(fn):
        def call(*a, **kw):
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return call

    try:
        for n in names:
            setattr(T, n, guard(n))
        for n, fn in plain.items():
            setattr(tref, n, unguarded(fn))
        torch.as_tensor, torch.tensor = as_tensor, tensor
        yield
    finally:
        for n, fn in saved.items():
            setattr(T, n, fn)
        for n, fn in plain.items():
            setattr(tref, n, fn)
        torch.as_tensor, torch.tensor = real_as_tensor, real_tensor


@pytest.mark.parametrize("name", ["clean", "degraded"])
def test_scanned_loop_reads_nothing_back(setup, name):
    """What the CUDA graph captures (``_scanned_run``, given its plan, host
    scalars and the start as a tensor) reads no tensor back to the host and
    copies nothing from host memory, and its result is the engine's, at
    start 0 and resumed at the chunk boundary (mid-outage in the degraded
    case); reading either would make the capture fail on the card."""
    case = setup[name]
    cfg, ts = case["cfg"], case["ts"]
    consts = tpdu.host_consts(cfg, case["state"].filter_obj)
    bank = tfleet._make_bank(case["spec"], cfg, CHUNK)
    tcomp._bins_tensor(bank.bins, cfg.device)  # made before capture, as the warm-up does
    first = _cached(case, "first", stop_sample=CHUNK)
    second = _run(case, state=first.state, start_sample=CHUNK, stop_sample=2 * CHUNK)
    for start, st, ref in ((0, case["state"], first), (CHUNK, first.state, second)):
        t0 = torch.full((), start, dtype=torch.int32)
        with _no_host_reads():
            st2, out = tfleet._scanned_run(cfg, ts, st, case["plan"], consts, start=t0,
                                           chunk=K, k=K, n_full=1, rem=K, qp_iters=30,
                                           bank=bank)
        for x, y in zip(_leaves((st2, out.campus_grid, out.soc_mean)),
                        _leaves((ref.state, ref.campus_grid, ref.soc_mean)), strict=True):
            assert torch.equal(x, y)


def test_engine_key_leaves_out_the_start(setup):
    """Windows of one length at different starts share one graph's key;
    another length or another noise seed (static in the reference's jit
    too) does not."""
    case = setup["degraded"]
    cfg, ts, st = case["cfg"], case["ts"], case["state"]

    def key(t_total, scen=ts):
        geometry = dict(chunk=CHUNK, k=K, n_full=t_total // CHUNK, rem=t_total % CHUNK,
                        qp_iters=30, bank=tfleet._make_bank(case["spec"], cfg, t_total))
        return tfleet._scanned_key(cfg, scen, st, case["plan"], geometry)

    assert key(CHUNK) == key(CHUNK)
    assert key(CHUNK) != key(2 * CHUNK)
    assert key(CHUNK) != key(CHUNK, scen=ts.replace(noise_seed=5))


def test_engine_cache_is_a_bounded_lru(monkeypatch):
    """The cache keeps at most ``_ENGINE_CACHE_MAX`` graphs, evicting the
    least recently used, and builds a key's engine once while it stays."""
    monkeypatch.setattr(tfleet, "_ENGINE_CACHE", type(tfleet._ENGINE_CACHE)())
    built = []

    def build(key):
        built.append(key)
        return ("engine", key)

    n = tfleet._ENGINE_CACHE_MAX
    for key in range(n):
        tfleet._cached_engine(key, lambda key=key: build(key))
    assert tfleet._cached_engine(0, lambda: build(0)) == ("engine", 0)  # a hit: 0 is fresh
    tfleet._cached_engine(n, lambda: build(n))
    assert built == list(range(n + 1))
    assert list(tfleet._ENGINE_CACHE) == [*range(2, n), 0, n]


@pytest.mark.parametrize("h", [6, 13])
def test_padded_horizon_reads_nothing_back(h):
    """The admm_step wrapper's horizon padding (horizons below 24 other
    than 12 run padded) builds its index tensors once, so a padded solve
    can be captured too; padding and unpadding give back the iterates."""
    from repro_torch.kernels import admm_step as tad

    g = torch.Generator().manual_seed(h)
    r = lambda *shape: torch.randn(*shape, generator=g)
    args = (r(2 * h, 5 * h), r(h, 2 * h), r(2 * h, 3), r(3 * h, 3), r(3 * h, 3),
            r(2 * h, 3), r(3 * h, 3), r(3 * h, 3))
    hp = tad.kernel_horizon(h)
    tad.unpad_horizon(*tad.pad_horizon(*args, hp)[5:], h)  # made before capture
    with _no_host_reads():
        padded = tad.pad_horizon(*args, hp)
        back = tad.unpad_horizon(*padded[5:], h)
    assert padded[0].shape == (2 * hp, 5 * hp)
    for x, y in zip(back, args[5:], strict=True):
        assert torch.equal(x, y)


def test_profiling_spans(setup):
    """Spans are no-ops unless enabled; enabled, the host engine's run
    accumulates render, solve and host-sync and gives the same bits."""
    before = tprof.phases()
    with tprof.span("render") as sync:
        assert sync(3) == 3
    assert not tprof.enabled() and tprof.phases() == before
    case = setup["clean"]
    tprof.enable()
    try:
        res = _run(case, engine="host")
        ph = tprof.phases()
    finally:
        tprof.disable()
    assert set(ph) == {"render", "solve", "host-sync"}
    assert all(v > 0.0 for v in ph.values())
    _assert_bitwise(res, _cached(case, "host", engine="host"))
    tprof.enable()  # enable() clears what was accumulated
    assert tprof.phases() == {}
    tprof.disable()
