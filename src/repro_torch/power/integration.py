"""PowerSim: EasyRider in the training loop (counterpart of
``repro.power.integration``).

Each training step contributes a phase timeline (compute -> exposed
collective; checkpoint stalls when they happen) derived from the step's
cost model.  PowerSim compiles those phases into a segment-table scenario,
renders it to a rack power trace at ``sample_hz`` on the device, streams
it through the EasyRider PDU (``pdu.condition``: one ``pdu_health`` and
one ``admm_step`` launch per controller interval on the card, the single
rack lifted to one column; state carried across steps), monitors
compliance online (cross-chunk ramp observers and an open-ended spectral
line bank, so the monitoring state is O(1) however long the run), and
exposes battery SoC and wear telemetry, which the fault-tolerance layer
uses for emergency checkpoints.

The trainer only reports when steps happen; conditioning runs entirely
in the PDU model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import compliance, fleet, health as hlt, pdu
from repro_torch.power import phases as P
from repro_torch.power import scenario as SC
from repro_torch.power.device import DevicePower
from repro_torch.utils.devices import resolve_device


@dataclasses.dataclass
class PowerSimConfig:
    sample_hz: float = 200.0
    grid: compliance.GridSpec | None = None
    # Accelerator power model driving phase rendering (idle/comm power
    # fractions); None keeps the PhaseModel's own device (default TPU_V5E).
    device: DevicePower | None = None
    # Battery wear telemetry folded into the conditioning step.
    track_health: bool = True


class PowerSim:
    def __init__(
        self,
        cost: P.StepCost,
        hw: P.HardwareConstants,
        model: P.PhaseModel,
        cfg: PowerSimConfig | None = None,
        *,
        device="cuda",
    ):
        self.dev = resolve_device(device)
        self.cfg = cfg or PowerSimConfig()
        self.grid_spec = self.cfg.grid or compliance.GridSpec.create(device=self.dev)
        if self.cfg.device is not None:
            model = dataclasses.replace(model, device=self.cfg.device)
        self.cost = cost
        self.hw = hw
        self.model = model
        self.pdu_cfg = pdu.make_pdu(
            sample_dt=1.0 / self.cfg.sample_hz,
            track_health=self.cfg.track_health,
            device=self.dev,
        )
        self.state = None
        self.soc = 0.5
        # Streaming monitors.  The run's total length is unknown up front,
        # so the spectral bank runs open-ended (rectangular window, fixed
        # operator line grid).
        self._ramp_rack = compliance.ramp_observer_init(device=self.dev)
        self._ramp_grid = compliance.ramp_observer_init(device=self.dev)
        self._bank = compliance.make_online_bank(
            1.0 / self.cfg.sample_hz, float(self.grid_spec.f_c)
        )
        self._spec_rack = compliance.spectrum_observer_init(self._bank, device=self.dev)
        self._spec_grid = compliance.spectrum_observer_init(self._bank, device=self.dev)
        # pdu.condition advances whole controller intervals (k samples);
        # sub-interval chunks would desync the carried state, so samples
        # are buffered until a full interval is available.
        self._k = max(int(round(float(self.pdu_cfg.controller.dt) * self.cfg.sample_hz)), 1)
        self._pending = torch.zeros((0,), dtype=torch.float32, device=self.dev)
        self._step = fleet.make_condition_step(self.pdu_cfg, qp_iters=25)

    @property
    def max_ramp_seen(self) -> float:
        return float(self._ramp_grid.max_ramp)

    def _condition(self, chunk: torch.Tensor, dt: float) -> None:
        # Rendered chunks stay on the device through buffering,
        # conditioning and the observers; the only host transfer is the
        # scalar SoC readout.
        self._pending = torch.cat([self._pending, chunk])
        n = (self._pending.shape[0] // self._k) * self._k
        if n == 0:
            return
        trace, self._pending = self._pending[:n], self._pending[n:]
        if self.state is None:
            self.state = pdu.init_state(self.pdu_cfg, trace[0])
        grid, self.state, telem = self._step(self.state, trace)
        self.soc = float(telem.soc[-1])
        self._ramp_rack = compliance.ramp_observer_update(self._ramp_rack, trace, dt)
        self._ramp_grid = compliance.ramp_observer_update(self._ramp_grid, grid, dt)
        self._spec_rack = compliance.spectrum_observer_update(self._bank, self._spec_rack, trace)
        self._spec_grid = compliance.spectrum_observer_update(self._bank, self._spec_grid, grid)

    def on_step(self, *, checkpoint_stall: bool = False) -> None:
        durs, pows = P.step_phases(self.cost, self.hw, self.model)
        if checkpoint_stall:
            durs = np.append(durs, self.model.checkpoint_stall_s)
            d = self.model.device
            pows = np.append(pows, d.p_idle_w / d.p_peak_w)
        # Compile the step's phases into the scenario IR and render the
        # chunk on the device.
        s = SC.from_phase_timeline(durs, pows, self.cfg.sample_hz, device=self.dev)
        chunk, dt = SC.render_trace(s)
        self._condition(chunk, dt)

    def report(self) -> dict:
        rep_rack = compliance.report_from_observers(
            self.grid_spec, self._ramp_rack, self._bank, self._spec_rack
        )
        rep_grid = compliance.report_from_observers(
            self.grid_spec, self._ramp_grid, self._bank, self._spec_grid
        )
        out = {
            "rack_max_ramp": float(rep_rack.max_ramp),
            "grid_max_ramp": float(rep_grid.max_ramp),
            "grid_ramp_ok": bool(rep_grid.ramp_ok),
            "grid_worst_hf": float(rep_grid.worst_high_freq_mag),
            "final_soc": self.soc,
        }
        if self.cfg.track_health and self.state is not None:
            rep = hlt.report(
                self.pdu_cfg.health, self.pdu_cfg.ess_params,
                self.state.health, 1.0 / self.cfg.sample_hz,
            )
            out.update(
                battery_efc=float(rep.efc),
                battery_half_cycles=float(rep.half_cycles),
                battery_max_dod=float(rep.max_dod),
                battery_capacity_fade=float(rep.capacity_fade),
                battery_projected_life_years=float(rep.projected_life_s / (365.25 * 86400.0)),
            )
        return out
