"""DSDE policy (paper §3.1-3.3): KLD-variance stability SL adaptation."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import adapter as adapter_lib
from repro_torch.core.policies.base import register
from repro_torch.core.policies.static import KLDTrackingPolicy


@register("dsde")
@dataclasses.dataclass(frozen=True)
class DSDEPolicy(KLDTrackingPolicy):
    """Per-sequence per-iteration SL from the WVIR stability penalty."""

    def initial_sl_value(self) -> int:
        return self.spec.calibration_sl   # Eq. (1) calibration phase

    def predict(self, state, active: torch.Tensor):
        sl, state, tel = adapter_lib.predict_sl(state, self.spec, active)
        tel = dict(tel, mean_kld=state.mu_kld_last)
        return sl, state, tel
