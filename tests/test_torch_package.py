"""Package-level contract of the port (``repro_torch``).

* Importing every module pulls in neither JAX nor the JAX package
  (checked in a fresh interpreter).
* Entry points that create tensors default to ``device="cuda"`` and raise
  on a machine without a card instead of running on the CPU.
* The kernel dispatch: CPU tensors take the plain versions, ``force``
  cannot demand the CUDA kernel for them, and the kernel wrappers refuse
  CPU tensors.
"""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import burn, compliance, controller, fleet, pdu
from repro_torch.kernels import admm_step, gemm_burn, lc_filter, ops, pdu_health, pdu_sim
from repro_torch.models import encdec, transformer
from repro_torch.data import DataConfig
from repro_torch.launch import serve as launch_serve, train as launch_train
from repro_torch.optim import AdamWConfig
from repro_torch.power import integration, phases, scenario, trace
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, train

SRC = Path(repro_torch.__file__).resolve().parents[1]


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_import_pulls_in_neither_jax_nor_repro():
    mods = _all_modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.core.fleet" in mods
    assert "repro_torch.serve.engine" in mods and "repro_torch.launch.serve" in mods
    assert "repro_torch.train.loop" in mods and "repro_torch.launch.train" in mods
    assert "repro_torch.power.integration" in mods and "repro_torch.optim.adamw" in mods
    assert "repro_torch.models.rwkv6" in mods and "repro_torch.kernels.rwkv6_scan" in mods
    assert "repro_torch.models.mamba2" in mods and "repro_torch.models.encdec" in mods
    assert {"repro_torch.core.burn", "repro_torch.kernels.lc_filter", "repro_torch.kernels.pdu_sim",
            "repro_torch.kernels.gemm_burn"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _no_cuda(monkeypatch):
    """Make this process look like a machine without a card (it is one
    here; the patch keeps the test meaningful anywhere)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: pdu.make_pdu(),
        lambda: compliance.GridSpec.create(),
        lambda: controller.ControllerConfig.create(),
        lambda: scenario.workload(),
        lambda: scenario.mixed_campus(8, ("llama3_2_1b",), duration_s=10.0),
        lambda: trace.testbench_trace(trace.TestbenchSpec(duration_s=1.0)),
        lambda: trace.titanx_testbench(),
        lambda: burn.calibrate(None, 0.06, 1.0),
        lambda: convert.workload_params_from_numpy({"p_idle": 0.1}),
        lambda: transformer.init(smoke_config("llama3_2_1b")),
        lambda: transformer.Transformer(smoke_config("chameleon_34b")),
        lambda: transformer.init_decode_state(smoke_config("llama3_2_1b"), 1, 8),
        lambda: transformer.init(smoke_config("rwkv6_7b")),
        lambda: transformer.init_decode_state(smoke_config("rwkv6_7b"), 1, 8),
        lambda: transformer.init(smoke_config("zamba2_2_7b")),
        lambda: transformer.Transformer(smoke_config("zamba2_2_7b")),
        lambda: transformer.init_decode_state(smoke_config("zamba2_2_7b"), 1, 8),
        lambda: ServeEngine(smoke_config("zamba2_2_7b"),
                            transformer.Transformer(smoke_config("zamba2_2_7b"), device="cpu")),
        lambda: launch_train.main(["--arch", "zamba2-2.7b", "--steps", "1"]),
        lambda: launch_serve.main(["--arch", "zamba2-2.7b"]),
        lambda: encdec.init(smoke_config("whisper_large_v3")),
        lambda: encdec.EncDec(smoke_config("whisper_large_v3")),
        lambda: ServeEngine(smoke_config("whisper_large_v3"),
                            encdec.EncDec(smoke_config("whisper_large_v3"), device="cpu")),
        lambda: convert.lm_params_from_numpy({}, smoke_config("whisper_large_v3")),
        lambda: train(smoke_config("whisper_large_v3"), DataConfig(batch=2, seq_len=8),
                      AdamWConfig(), TrainConfig(steps=1)),
        lambda: launch_train.main(["--arch", "whisper-large-v3", "--steps", "1"]),
        lambda: launch_serve.main(["--arch", "whisper-large-v3"]),
        lambda: convert.lm_params_from_numpy({}, smoke_config("llama3_2_1b")),
        lambda: ServeEngine(smoke_config("llama3_2_1b"),
                            transformer.Transformer(smoke_config("llama3_2_1b"), device="cpu")),
        lambda: scenario.from_phase_timeline([1.0, 2.0], [1.0, 0.4], 200.0),
        lambda: scenario.scenario_from_model("llama3_2_1b", duration_s=10.0),
        lambda: trace.phase_timeline_trace([1.0, 2.0], [1.0, 0.4], 200.0),
        lambda: trace.phase_timeline_trace_reference([1.0, 2.0], [1.0, 0.4], 200.0),
        lambda: trace.testbench_trace_reference(trace.TestbenchSpec(duration_s=1.0)),
        lambda: fleet.staggered_fleet(torch.full((100,), 0.5), 4, max_offset_samples=10),
        lambda: phases.training_scenario(phases.StepCost(1e17, 1e14, 1e14),
                                         phases.HardwareConstants(), phases.PhaseModel(), 2, 200.0),
        lambda: integration.PowerSim(phases.StepCost(1e17, 1e14, 1e14),
                                     phases.HardwareConstants(), phases.PhaseModel()),
        lambda: train(smoke_config("llama3_2_1b"), DataConfig(batch=2, seq_len=8), AdamWConfig(),
                      TrainConfig(steps=1)),
        lambda: launch_train.main(["--steps", "1"]),
    ],
)
def test_default_device_raises_without_a_card(monkeypatch, entry):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_fleet_default_device_raises_without_a_card(monkeypatch):
    cfg = pdu.make_pdu(sample_dt=0.005, device="cpu")
    tr = torch.full((2000, 2), 0.5)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.condition(tr, cfg)


def test_fleet_device_must_match_config():
    cfg = pdu.make_pdu(sample_dt=0.005, device="cpu")
    with pytest.raises(ValueError, match="device"):
        fleet.condition(torch.full((2000, 2), 0.5), cfg, device="meta")


def test_dispatch_on_cpu_tensors():
    x = torch.zeros(24, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.admm_iterate(torch.zeros(24, 60), torch.zeros(12, 24), x, torch.zeros(36, 3),
                         torch.zeros(36, 3), x, torch.zeros(36, 3), torch.zeros(36, 3),
                         rho=1.0, iters=1, force="cuda")
    with pytest.raises(ValueError, match="force"):
        ops.admm_iterate(torch.zeros(24, 60), torch.zeros(12, 24), x, torch.zeros(36, 3),
                         torch.zeros(36, 3), x, torch.zeros(36, 3), torch.zeros(36, 3),
                         rho=1.0, iters=1, force="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        admm_step.admm_iterate(torch.zeros(24, 60), torch.zeros(12, 24), x, torch.zeros(36, 3),
                               torch.zeros(36, 3), x, torch.zeros(36, 3), torch.zeros(36, 3),
                               rho=1.0, iters=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pdu_health.pdu_health_sim(torch.zeros(4, 2), torch.zeros(2), torch.zeros(2),
                                  torch.zeros(2, 3), torch.eye(3), torch.zeros(3, 2),
                                  torch.zeros(3), beta=0.1, dt=0.005, q_max=60.0,
                                  eta_c=0.97, eta_d=0.97, p_max=1.0, soc_min=0.1, soc_max=0.9)
    # The ESS availability operands run the plain version on CPU tensors
    # and demand the kernel's CUDA tensors under force="cuda".
    hw = dict(beta=0.1, dt=0.005, q_max=60.0, eta_c=0.97, eta_d=0.97, p_max=1.0,
              soc_min=0.1, soc_max=0.9)
    args = (torch.zeros(4, 2), torch.zeros(2), torch.zeros(2), torch.zeros(2, 3), torch.eye(3),
            torch.zeros(3, 2), torch.zeros(3))
    ev = (torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, 2, dtype=torch.int32),
          torch.ones(2), 0, 3)
    for mask in (dict(ess_on=torch.ones(2)), dict(ess_on=torch.ones(4, 2)),
                 dict(ess_events=ev, ess_edge=2)):
        assert ops.pdu_health_sim(*args, **mask, **hw)[0].shape == (4, 2)
        with pytest.raises(ValueError, match="CUDA"):
            ops.pdu_health_sim(*args, **mask, force="cuda", **hw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lc_filter.lc_filter(torch.eye(3), torch.zeros(3, 2), torch.ones(3), torch.zeros(2, 3),
                            torch.zeros(4, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pdu_sim.pdu_sim(torch.zeros(4, 2), torch.zeros(2), torch.zeros(2), torch.zeros(2, 3),
                        torch.eye(3), torch.zeros(3, 2), torch.zeros(3), torch.zeros(4, 2),
                        beta=0.1, dt=0.005,
                        q_max=60.0, eta_c=0.97, eta_d=0.97, p_max=1.0, soc_min=0.1, soc_max=0.9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gemm_burn.gemm_burn(torch.zeros(4, 2), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm_burn(torch.zeros(4, 2), torch.zeros(2, 3), force="cuda")
    # Plain versions run on CPU tensors, in automatic mode and under "ref".
    assert pdu_health.pdu_health_sim.launches == 0 and admm_step.admm_iterate.launches == 0
    for force in (None, "ref"):
        assert ops.gemm_burn(torch.ones(4, 2), torch.ones(2, 3), 3, force=force).shape == (4, 3)
        assert ops.lc_filter(torch.eye(3), torch.zeros(3, 2), torch.ones(3), torch.zeros(2, 3),
                             torch.zeros(4, 2), force=force)[0].shape == (4, 2)
    assert gemm_burn.gemm_burn.launches == 0 and lc_filter.lc_filter.launches == 0
    args = (torch.zeros(24, 60), torch.zeros(12, 24), x, torch.zeros(36, 3), torch.ones(36, 3),
            x, torch.zeros(36, 3), torch.zeros(36, 3))
    for force in (None, "ref"):
        xo, zo, yo = ops.admm_iterate(*args, rho=1.0, iters=2, force=force)
        assert xo.shape == (24, 3) and zo.shape == (36, 3)
    xo, zo, yo = ops.admm_iterate(*(a[:, 0] if a.shape[1] == 3 else a for a in args),
                                  rho=1.0, iters=2)
    assert xo.shape == (24,) and zo.shape == (36,)
    assert pdu_health.pdu_health_sim.launches == 0 and admm_step.admm_iterate.launches == 0
