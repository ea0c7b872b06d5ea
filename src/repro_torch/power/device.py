"""Accelerator power-state models (paper §2.2 numbers).

Published peak/idle figures the paper cites:
  H100:    700 W peak / 140 W idle  (5:1)
  B200:   1000 W peak /  50 W idle  (20:1)
  TitanX:  250 W peak /  15 W idle  (the paper's 2-GPU testbed)
  v5e:     ~220 W peak / ~60 W idle (TPU target; public board figures)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DevicePower:
    name: str
    p_peak_w: float
    p_idle_w: float
    p_comm_w: float  # draw during exposed communication (HBM+NIC, no MXU)

    @property
    def peak_to_idle(self) -> float:
        return self.p_peak_w / self.p_idle_w

    def fraction(self, watts: float) -> float:
        return watts / self.p_peak_w


H100 = DevicePower("h100", 700.0, 140.0, 220.0)
B200 = DevicePower("b200", 1000.0, 50.0, 180.0)
TITAN_X = DevicePower("titan_x", 250.0, 15.0, 40.0)
TPU_V5E = DevicePower("tpu_v5e", 220.0, 60.0, 95.0)

DEVICES = {d.name: d for d in (H100, B200, TITAN_X, TPU_V5E)}
