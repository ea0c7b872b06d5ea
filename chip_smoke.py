#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Build the two CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, started together).
2. Kernel phases at the main path's shapes: ``pdu_health_sim`` on one
   controller interval of the 1024-rack campus (T = 1000, R = 1024, slew
   and wear fold) and ``admm_iterate`` on the campus controller QP
   (h = 12, R = 1024, 30 iterations), each held against its plain PyTorch
   version on the same inputs on the card and timed with CUDA events
   (median of 25 calls) beside it.
3. The quickstart (``examples/quickstart.py`` through the port): the
   240 s testbench trace at 500 Hz through ``pdu.condition`` with
   ``qp_iters=40``; the raw rack must fail the grid spec, the conditioned
   grid must pass it, and the SoC must stay inside [0.10, 0.90].
4. The acceptance campus: 1024 racks, four model families plus an
   inference-diurnal block, staggered starts, early stops and a fault
   cascade, 88 s at 200 Hz, conditioned by ``fleet.condition(engine=
   "host")`` with the wear fold, ``qp_iters=30``, ``chunk_intervals=4``.
   Each kernel must launch 18 times (one per controller interval), and the
   campus numbers must match the JAX package's (``JAX_CAMPUS``, recorded
   on the CPU by ``python tests/test_torch_campus_reference.py``) within
   ``CAMPUS_TOLERANCES``.

With ``--profile DIR`` it also profiles one more campus run
(``torch.profiler``) and writes the table and a Chrome trace into DIR.

The script prints the card's name and power limit, then one JSON line
describing each kernel, and ends with the line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` next to it, it exits non-zero and prints
no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")
CAMPUS = dict(n_racks=1024, duration_s=88.0, sample_hz=200.0, seed=3, noise_seed=2,
              qp_iters=30, chunk_intervals=4)

# The JAX package's numbers for CAMPUS: its host engine on the CPU
# (jax 0.9.0), printed by ``python tests/test_torch_campus_reference.py``.
JAX_CAMPUS = {
    'rack_max_ramp': 3.0713260173797607,
    'grid_max_ramp': 0.02206563949584961,
    'rack_worst_line': 0.00022977461048867553,
    'grid_worst_line': 1.5509531294810586e-06,
    'rack_worst_line_exact': 0.00022994263194101478,
    'grid_worst_line_exact': 1.3892173364332258e-06,
    'rack_ramp_ok': False,
    'rack_spectrum_ok': False,
    'grid_ramp_ok': True,
    'grid_spectrum_ok': True,
    'grid_ok': True,
    'max_qp_residual': 0.004625674337148666,
    'campus_rack_mean': 0.6661505436232652,
    'campus_grid_mean': 0.5565653294642371,
    'soc_mean_min': 0.3337993025779724,
    'soc_mean_max': 0.4915217459201813,
    'soc_mean_last': 0.35262781381607056,
    'efc_mean': 0.12189458310604095,
    'efc_max': 0.1892935335636139,
    'half_cycles_mean': 288.251953125,
    'worst_dod': 0.21451985836029053,
    'fade_mean': 6.208408649399644e-07,
    'fade_max': 1.1300876394670922e-06,
    'mean_soc': 0.3876362144947052,
}

# Tolerances of the port against JAX_CAMPUS, with their reasons:
# * the port renders its own trace: erfinv/cos rounding and XLA's fused
#   multiply-adds move each rack sample by ~1e-6, the campus means by less;
# * ramp maxima are differences of campus means over dt = 5 ms: campus
#   mean errors d <= 5e-8 give 2 d / dt = 2e-5 /s, so 5e-5 /s absolute
#   (measured 1.8e-5 and 6e-6 at 16 racks, which average less);
# * worst spec lines: the reference's float32 Goertzel bank drifts from
#   the exact DFT of its own campus trace (by 11.6 % of the grid's worst
#   line here, inside its 1e-5 absolute contract), so the lines are held
#   to the exact float64 DFT of each package's campus trace at the bank's
#   bins (``exact_worst_line``).  The port's exact lines against the
#   reference's: the rendered racks differ by ~1e-6 (erfinv/cos rounding),
#   which moves the campus lines by ~1e-9 (measured on the CPU at 1024
#   racks: 5e-6 relative rack, 9e-4 relative grid): 1e-3 rack, 1e-2 grid
#   relative.  The port's streamed lines against its own exact DFT: see
#   BANK_REL_TOL.  The verdicts against alpha = 1e-4 are compared exactly;
# * the QP residual and the wear counts follow the SoC path, which sees
#   the controller's commands (ADMM sums in another order on the card):
#   1e-3 relative; counted half-cycles can flip at flat SoC points: 1e-3;
# * SoC and fade means: 1e-5 absolute / 1e-4 relative.
CAMPUS_TOLERANCES = {
    "rack_max_ramp": ("abs", 5e-5),
    "grid_max_ramp": ("abs", 5e-5),
    "rack_worst_line_exact": ("rel", 1e-3),
    "grid_worst_line_exact": ("rel", 1e-2),
    "max_qp_residual": ("rel", 1e-3),
    "campus_rack_mean": ("abs", 1e-6),
    "campus_grid_mean": ("abs", 1e-5),
    "soc_mean_min": ("abs", 1e-5),
    "soc_mean_max": ("abs", 1e-5),
    "soc_mean_last": ("abs", 1e-5),
    "efc_mean": ("rel", 1e-4),
    "efc_max": ("rel", 1e-3),
    "half_cycles_mean": ("rel", 1e-3),
    "worst_dod": ("rel", 1e-3),
    "fade_mean": ("rel", 1e-4),
    "fade_max": ("rel", 1e-3),
    "mean_soc": ("abs", 1e-5),
}
# The port's streamed spec lines (float64 line sums per chunk, folded into
# float32 accumulators) against the exact DFT of the same trace: each of
# the five chunk folds rounds a partial line sum of magnitude up to ~20 at
# float32 precision (~1e-6), against a grid line sum of ~6e-3: relative
# error up to ~1e-3 (measured on the CPU at 1024 racks: 2e-7 rack, 8e-5
# grid).
BANK_REL_TOL = 1e-3
CAMPUS_VERDICTS = ("rack_ramp_ok", "rack_spectrum_ok", "grid_ramp_ok", "grid_spectrum_ok", "grid_ok")


def exact_worst_line(trace, bank) -> float:
    """The largest spec line of a whole campus trace at the bank's bins, from
    a float64 FFT of the Hann-windowed trace: what the streaming line bank
    (``compliance.SpectrumObserver``) computes chunk by chunk."""
    import numpy as np

    x = np.asarray(trace.detach().cpu() if hasattr(trace, "detach") else trace, np.float64)
    n = x.shape[0]
    assert bank.modulus == n and bank.window == "hann", (bank.modulus, n, bank.window)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    bins = np.asarray(bank.bins, np.int64)
    scale = np.where((n % 2 == 0) & (bins == n // 2), 1.0, 2.0)
    return float(np.max(np.abs(np.fft.rfft(x * w))[bins] * scale) / (n * np.mean(w)))


def campus_summary(res, health_summary: dict) -> dict:
    """The scalars of a campus run that the check compares (either package:
    every field goes through ``float``/``bool`` of its value)."""
    import numpy as np

    f = lambda x: float(x)
    host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    soc = [float(v) for v in host(res.soc_mean)]
    rr, rg = res.report_rack, res.report_grid
    out = {
        "rack_max_ramp": f(rr.max_ramp), "grid_max_ramp": f(rg.max_ramp),
        "rack_worst_line": f(rr.worst_high_freq_mag), "grid_worst_line": f(rg.worst_high_freq_mag),
        "rack_worst_line_exact": exact_worst_line(res.campus_rack, res.bank),
        "grid_worst_line_exact": exact_worst_line(res.campus_grid, res.bank),
        "rack_ramp_ok": bool(rr.ramp_ok), "rack_spectrum_ok": bool(rr.spectrum_ok),
        "grid_ramp_ok": bool(rg.ramp_ok), "grid_spectrum_ok": bool(rg.spectrum_ok),
        "grid_ok": bool(rg.ok),
        "max_qp_residual": f(res.max_qp_residual),
        "campus_rack_mean": float(np.mean(host(res.campus_rack))),
        "campus_grid_mean": float(np.mean(host(res.campus_grid))),
        "soc_mean_min": min(soc), "soc_mean_max": max(soc), "soc_mean_last": soc[-1],
    }
    for k in ("efc_mean", "efc_max", "half_cycles_mean", "worst_dod", "fade_mean",
              "fade_max", "mean_soc"):
        out[k] = float(health_summary[k])
    return out


def compare_campus(got: dict, want: dict) -> list[str]:
    """Failures of ``got`` against ``want`` under CAMPUS_TOLERANCES."""
    bad = []
    for k in CAMPUS_VERDICTS:
        if got[k] != want[k]:
            bad.append(f"{k}: {got[k]} != {want[k]}")
    for k, (kind, tol) in CAMPUS_TOLERANCES.items():
        err = abs(got[k] - want[k])
        lim = tol * abs(want[k]) if kind == "rel" else tol
        if not err <= lim:
            bad.append(f"{k}: {got[k]!r} vs {want[k]!r} (|diff| {err:.3e} > {lim:.3e})")
    for side in ("rack", "grid"):
        line, exact = got[f"{side}_worst_line"], got[f"{side}_worst_line_exact"]
        if not abs(line - exact) <= BANK_REL_TOL * exact:
            bad.append(f"{side}_worst_line: streamed {line!r} vs exact DFT {exact!r}")
    return bad


def run_campus(n_racks: int, duration_s: float, *, device: str = "cuda"):
    """The acceptance campus through the port's host engine; returns
    ``(result, health fleet summary, wall seconds)``."""
    import torch

    from repro_torch.core import compliance, fleet, health as hlt, pdu
    from repro_torch.power import scenario as SC

    c = CAMPUS
    s = SC.mixed_campus(n_racks, ARCHS, duration_s=duration_s, sample_hz=c["sample_hz"],
                        seed=c["seed"], fault_at_s=duration_s * 0.6,
                        noise_seed=c["noise_seed"], device=device)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, device=device)
    spec = compliance.GridSpec.create(device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.condition(
        s, cfg, spec, engine="host", qp_iters=c["qp_iters"], device=device,
        stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"]),
    )
    hsum = hlt.fleet_summary(res.health)  # reads back to the host
    if device != "cpu":
        torch.cuda.synchronize()
    return res, hsum, time.perf_counter() - t0


def _median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max((_max_err(x, y) for x, y in zip(a, b)), default=0.0)
    if a is None:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the campus shapes."""
    import torch

    from repro_torch.core import controller as ctrl, health as hlt, pdu
    from repro_torch.kernels import admm_step, ops, pdu_health
    from repro_torch.power import scenario as SC

    c = CAMPUS
    s = SC.mixed_campus(c["n_racks"], ARCHS, duration_s=c["duration_s"],
                        sample_hz=c["sample_hz"], seed=c["seed"],
                        fault_at_s=c["duration_s"] * 0.6, noise_seed=c["noise_seed"],
                        device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, device=dev)
    k = int(round(float(cfg.controller.dt) * c["sample_hz"]))
    chunk = SC.render(s, 0, k)
    st = pdu.init_state(cfg, chunk[0])
    t_len, r = chunk.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    applied = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    target = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    hw = pdu.hw_kwargs(cfg)
    # The campus keeps SoC inside its window, so drive two slices of racks
    # into it: one starts just below soc_max and charges at full power, one
    # just above soc_min and discharges, so the window clamp and its power
    # back-off run within the interval and are held against the plain
    # version too.
    soc0 = st.ess_state.soc.clone()
    n8 = r // 8
    soc0[:n8], applied[:n8], target[:n8] = hw["soc_max"] - 0.01, 1.0, 1.0
    soc0[n8:2 * n8], applied[n8:2 * n8], target[n8:2 * n8] = hw["soc_min"] + 0.01, -1.0, -1.0
    filt = st.filter_obj
    # The filter matrices as host arrays, as pdu.condition passes them.
    lc = tuple(m.cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0]))
    ph_args = (chunk, st.ess_state.g_filter, soc0, st.filter_state, *lc)
    ph_kw = dict(slew=(applied, target), health=(hlt.step_consts(cfg.health), tuple(st.health)),
                 **hw)
    out_k = ops.pdu_health_sim(*ph_args, force="cuda", **ph_kw)
    out_p = ops.pdu_health_sim(*ph_args, force="ref", **ph_kw)
    torch.cuda.synchronize()
    grid_k, soc_k, fin_k, h_k = out_k
    grid_p, soc_p, fin_p, h_p = out_p
    soc_max, soc_min = (torch.tensor(hw[k], dtype=torch.float32) for k in ("soc_max", "soc_min"))
    n_hi = int((soc_k[:, :n8] == soc_max).any(0).sum())
    n_lo = int((soc_k[:, n8:2 * n8] == soc_min).any(0).sum())
    print(f"pdu_health  SoC window clamp reached by {n_hi}/{n8} charging and {n_lo}/{n8} "
          f"discharging racks")
    _check(n_hi == n8 and n_lo == n8, "pdu_health: the SoC window clamp must fire")
    errs = {
        "grid": _max_err(grid_k, grid_p), "soc": _max_err(soc_k, soc_p),
        "ess+lc finals": _max_err(fin_k, fin_p), "wear carries": _max_err(h_k[:6], h_p[:6]),
        "block sums": _max_err(h_k[6:10], h_p[6:10]),
    }
    print(f"pdu_health  T={t_len} R={r} slew+wear  max|kernel - plain|: "
          + "  ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    # The dense-corrective variant without the wear fold, same shape.
    dense_kw = dict(corrective=torch.outer(torch.linspace(-1, 1, t_len, device=dev), target), **hw)
    out_k = ops.pdu_health_sim(*ph_args, force="cuda", **dense_kw)
    out_p = ops.pdu_health_sim(*ph_args, force="ref", **dense_kw)
    torch.cuda.synchronize()
    errs["dense variant"] = _max_err(out_k[:3], out_p[:3])
    print(f"pdu_health  T={t_len} R={r} dense corrective  max|kernel - plain| = "
          f"{errs['dense variant']:.3e}")
    # Same arithmetic and rounding on both sides (see csrc/pdu_health.cu);
    # the plain version's emulated FMA can double-round (p ~ 2^-29 per op)
    # and the LC filter carries such an ulp forward.
    _check(errs["soc"] <= 1e-6 and errs["wear carries"] <= 1e-6, "pdu_health SoC/wear vs plain")
    _check(errs["grid"] <= 1e-5 and errs["ess+lc finals"] <= 1e-5, "pdu_health grid/LC vs plain")
    _check(errs["dense variant"] <= 1e-5, "pdu_health dense variant vs plain")
    _check(errs["block sums"] <= 1e-3, "pdu_health block sums vs plain")
    prep = pdu_health.prepare(*ph_args, **ph_kw)
    ph_ms = _median_ms(lambda: pdu_health.launch(prep))
    ph_call_ms = _median_ms(lambda: ops.pdu_health_sim(*ph_args, force="cuda", **ph_kw))
    ph_plain_ms = _median_ms(lambda: ops.pdu_health_sim(*ph_args, force="ref", **ph_kw), reps=20)
    print(f"pdu_health  kernel {ph_ms:.4f} ms, wrapper call {ph_call_ms:.4f} ms, "
          f"plain {ph_plain_ms:.1f} ms (median of CUDA-event timings)")
    # Bytes moved once: rack power in, grid and SoC out (T x R each), plus
    # the per-rack rows (slew 2, state 5 in + 5 out, wear 11 in + 11 out).
    ph_bytes = 4 * (3 * t_len * r + (2 + 5 + 11 + 5 + 11) * r)
    # Float operations per rack-sample counted from the kernel source:
    # slew 3, ESS filter 3, battery power 4, SoC 7, window + back-off 8,
    # node 1, grid 5, LC 3 x 9, wear machine 22 (an FMA counts 2).
    ph_ops = 80 * t_len * r

    plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
    soc = 0.2 + 0.6 * torch.rand(r, generator=gen, device=dev)
    u_prev = (torch.rand(r, generator=gen, device=dev) - 0.5)
    q, lo, hi = ctrl._qp_state_terms(plan, soc, cfg.controller.s_mid.expand(r), u_prev)
    h = plan.horizon
    kq = plan.kkt_inv @ q
    kkt_stack = torch.cat([plan.kkt_inv_sigma, plan.kkt_inv_at], dim=1)
    x0 = torch.zeros_like(q)
    z0 = torch.clamp(plan.a_mat @ x0, lo, hi)
    y0 = torch.zeros_like(z0)
    ad_args = (kkt_stack, plan.a_mat[2 * h:], kq, lo, hi, x0, z0, y0)
    ad_kw = dict(rho=plan.rho, iters=c["qp_iters"])
    out_k = ops.admm_iterate(*ad_args, force="cuda", **ad_kw)
    out_p = ops.admm_iterate(*ad_args, force="ref", **ad_kw)
    torch.cuda.synchronize()
    ad_err = _max_err(out_k, out_p)
    print(f"admm_step   h={h} R={r} iters={c['qp_iters']}  max|kernel - plain| over x,z,y = {ad_err:.3e}")
    # Summation order of the products differs (FP32 FMA chain vs cuBLAS):
    # the reference's own Pallas-vs-ref envelope after 30 iterations.
    _check(ad_err <= 2e-5, "admm_step vs plain")
    prep = admm_step.prepare(*ad_args, **ad_kw)
    ad_ms = _median_ms(lambda: admm_step.launch(prep))
    ad_call_ms = _median_ms(lambda: ops.admm_iterate(*ad_args, force="cuda", **ad_kw))
    ad_plain_ms = _median_ms(lambda: ops.admm_iterate(*ad_args, force="ref", **ad_kw))
    print(f"admm_step   kernel {ad_ms:.4f} ms, wrapper call {ad_call_ms:.4f} ms, "
          f"plain {ad_plain_ms:.3f} ms")
    n2, n3 = 2 * h, 3 * h
    ad_bytes = 4 * (n2 * 5 * h + h * n2 + r * (n2 + 2 * n3 + n2 + 2 * n3 + n2 + 2 * n3))
    # Per iteration and column: x-update 2*(2h)(5h) + 2h, operand 2*3h,
    # G x 2*h*2h, z 4*3h, y 3*3h.
    ad_ops = c["qp_iters"] * r * (2 * n2 * 5 * h + n2 + 2 * n3 + 2 * h * n2 + 4 * n3 + 3 * n3)

    def entry(name, source, replaces, err, ms, call_ms, plain_ms, nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOP_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # No single PyTorch call computes either function.
            "library_ms": None,
            # "ms" is the kernel launch alone; the wrapper call adds its
            # host-side checks, packing and (pdu_health) epilogue sums.
            "kernel_ms": ms, "wrapper_ms": call_ms,
        }

    return {
        "pdu_health": entry(
            "pdu_health", "src/repro_torch/csrc/pdu_health.cu",
            "src/repro/kernels/pdu_health.py:224", max(errs.values()), ph_ms, ph_call_ms,
            ph_plain_ms, ph_bytes, ph_ops),
        "admm_step": entry(
            "admm_step", "src/repro_torch/csrc/admm_step.cu",
            "src/repro/kernels/admm_step.py:65", ad_err, ad_ms, ad_call_ms, ad_plain_ms,
            ad_bytes, ad_ops),
    }


def phase_quickstart(dev) -> None:
    """The quickstart flow through the port (a single rack: the kernels run
    one column)."""
    import torch

    from repro_torch.core import compliance, pdu
    from repro_torch.power import trace

    spec = compliance.GridSpec.create(beta=0.1, alpha=1e-4, f_c=2.0, device=dev)
    cfg = pdu.make_pdu(grid=spec, sample_dt=2e-3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rack, dt = trace.testbench_trace(
        trace.TestbenchSpec(duration_s=240.0, sample_hz=500.0, terminate_at_s=210.0),
        gen, device=dev)
    t0 = time.perf_counter()
    state = pdu.init_state(cfg, rack[0])
    grid, state, telem = pdu.condition(cfg, state, rack, qp_iters=40)
    before = compliance.check(rack, dt, spec)
    after = compliance.check(grid, dt, spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    soc_lo, soc_hi = float(telem.soc.min()), float(telem.soc.max())
    print(f"quickstart rack : ramp {float(before.max_ramp):8.3f}/s  "
          f"S(f>=2Hz) {float(before.worst_high_freq_mag):.2e}  ok={bool(before.ok)}")
    print(f"quickstart grid : ramp {float(after.max_ramp):8.4f}/s  "
          f"S(f>=2Hz) {float(after.worst_high_freq_mag):.2e}  ok={bool(after.ok)}")
    print(f"quickstart SoC in [{soc_lo:.4f}, {soc_hi:.4f}], {rack.shape[0]} samples, "
          f"{wall:.3f} s wall")
    _check(not bool(before.ok), "quickstart: the raw rack trace must fail the grid spec")
    _check(bool(after.ok), "quickstart: the conditioned grid must meet the spec")
    _check(0.10 <= soc_lo and soc_hi <= 0.90, "quickstart: SoC must stay in [0.10, 0.90]")


def phase_campus(dev) -> tuple[int, int]:
    """The acceptance campus; returns the kernels' launch counts."""
    from repro_torch.kernels import admm_step, pdu_health

    c = CAMPUS
    counts = None
    for run in ("first", "second"):
        pdu_health.pdu_health_sim.launches = 0
        admm_step.admm_iterate.launches = 0
        res, hsum, wall = run_campus(c["n_racks"], c["duration_s"], device=dev)
        counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
        print(f"campus {run} run: {wall:.3f} s wall, launches pdu_health={counts[0]} "
              f"admm_step={counts[1]}")
        _check(counts == (18, 18), f"campus: each kernel must launch 18 times, got {counts}")
    got = campus_summary(res, hsum)
    print(f"campus rack: max ramp {got['rack_max_ramp']:.6f}/s ramp_ok={got['rack_ramp_ok']} "
          f"worst line {got['rack_worst_line']:.3e} spectrum_ok={got['rack_spectrum_ok']}")
    print(f"campus grid: max ramp {got['grid_max_ramp']:.6f}/s ramp_ok={got['grid_ramp_ok']} "
          f"worst line {got['grid_worst_line']:.3e} (exact DFT {got['grid_worst_line_exact']:.3e}) "
          f"spectrum_ok={got['grid_spectrum_ok']} ok={got['grid_ok']}")
    print("campus health: " + json.dumps(hsum))
    print("campus vs JAX: " + json.dumps({k: [got[k], JAX_CAMPUS[k]] for k in got}))
    bad = compare_campus(got, JAX_CAMPUS)
    _check(not bad, "campus differs from the JAX package: " + "; ".join(bad))
    return counts


def phase_profile(dev, out_dir: Path) -> None:
    """One more campus run under torch.profiler: device time by kernel and
    the device's busy share of the run's wall time (both inflated a little
    by the profiler itself).  Writes the table and a Chrome trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = CAMPUS
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_campus(c["n_racks"], c["duration_s"], device=dev)
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # Device-side entries only (the kernels); the host ops that launched
    # them repeat the same time.
    rows = sorted(((dev_us(e), e.count, e.key) for e in avgs
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
    (out_dir / "campus_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out_dir / "campus_trace.json"))
    print(f"profile: campus run {wall * 1e3:.1f} ms wall under the profiler, kernels "
          f"{busy_us / 1e3:.2f} ms in {sum(r[1] for r in rows)} launches "
          f"(device busy {100 * busy_us / 1e3 / (wall * 1e3):.1f} %)")
    for us, count, key in rows[:12]:
        print(f"profile:   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one campus run; write the table and trace here")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.utils.devices import resolve_device

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    kernels = phase_kernels(dev)
    phase_quickstart(dev)
    ph_count, ad_count = phase_campus(dev)
    kernels["pdu_health"]["launches"] = ph_count
    kernels["admm_step"]["launches"] = ad_count
    if opts.profile is not None:
        phase_profile(dev, opts.profile)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [kernels["pdu_health"], kernels["admm_step"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
