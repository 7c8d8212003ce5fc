"""Static-SL baseline policy; keeps the KLD diagnostics as telemetry."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import adapter as adapter_lib
from repro_torch.core.policies.base import PolicyObservation, SpecPolicy, register


@dataclasses.dataclass(frozen=True)
class KLDTrackingPolicy(SpecPolicy):
    """Policies that keep the adapter's KLD diagnostics updated (static
    without using them for prediction, dsde with)."""

    def init_state(self, batch: int, device="cpu"):
        return adapter_lib.init_adapter_state(batch, self.spec, device)

    def observe(self, state, obs: PolicyObservation):
        return adapter_lib.observe(
            state, self.spec, kld=obs.kld, proposed_valid=obs.proposed_valid,
            num_accepted=obs.num_accepted, active=obs.active)


@register("static")
@dataclasses.dataclass(frozen=True)
class StaticPolicy(KLDTrackingPolicy):
    def initial_sl_value(self) -> int:
        return self.spec.static_sl

    def max_lookahead(self) -> int:
        # pick_bucket floors K at sl_min
        return max(self.spec.static_sl, self.spec.sl_min) + 1

    def predict(self, state, active: torch.Tensor):
        sl = adapter_lib.static_sl(state.mu_kld_last.shape[0], self.spec,
                                   state.mu_kld_last.device)
        return sl, state, {"mean_kld": state.mu_kld_last}
