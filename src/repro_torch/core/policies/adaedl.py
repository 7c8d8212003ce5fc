"""AdaEDL baseline policy (``repro.core.policies.adaedl``): a fixed base
SL per round, and drafting stops early when the entropy-based lower
bound on token acceptance drops under the threshold (the policy that
exercises the ``draft_keep`` hook)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import adapter as adapter_lib
from repro_torch.core.policies.base import register
from repro_torch.core.policies.static import KLDTrackingPolicy
from repro_torch.core.signals import draft_entropy


@register("adaedl")
@dataclasses.dataclass(frozen=True)
class AdaEDLPolicy(KLDTrackingPolicy):
    def initial_sl_value(self) -> int:
        return self.spec.adaedl_base

    def draft_keep(self, logits: torch.Tensor) -> torch.Tensor:
        ent = draft_entropy(logits[:, None])[:, 0]
        return adapter_lib.adaedl_stop_threshold(ent, self.spec)

    def max_lookahead(self) -> int:
        # pick_bucket floors K at sl_min
        return max(self.spec.adaedl_base, self.spec.sl_min) + 1

    def predict(self, state, active: torch.Tensor):
        sl = torch.full(state.mu_kld_last.shape, self.spec.adaedl_base,
                        dtype=torch.int32, device=state.mu_kld_last.device)
        return sl, state, {"mean_kld": state.mu_kld_last}
