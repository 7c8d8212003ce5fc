"""Autoregressive baseline: no speculation at all (K = 0 every round)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policies.base import (HostRoundContext, SpecPolicy,
                                            as_host_round_context, register)


@register("autoregressive")
@dataclasses.dataclass(frozen=True)
class AutoregressivePolicy(SpecPolicy):
    def initial_sl_value(self) -> int:
        return 0

    def uses_draft(self) -> bool:
        return False

    def lookahead(self, ctx: HostRoundContext) -> np.ndarray:
        # one decode slot per round, no speculative lookahead
        ctx = as_host_round_context(ctx, hook="lookahead")
        return np.ones_like(np.asarray(ctx.sl_next))

    def max_lookahead(self) -> int:
        return 1

    def predict(self, state, active: torch.Tensor):
        return (torch.zeros(active.shape, dtype=torch.int32,
                            device=active.device), state, {})
