"""SLO-aware speculation control (``repro.core.policies.slo``;
DESIGN.md §15).

DSDE on the device (the same SL adaptation, so the same streams when no
deadline is set), plus a host-side arbitration of the draft bucket from
the round's :class:`HostRoundContext` alone:

1. each live slot with a deadline affords ``deadline_remaining_i /
   ceil(tokens_remaining_i / (K+1))`` seconds a round (the best case:
   every position accepted); the batch's tightness is the least;
2. from DSDE's K, shrink while the latency model predicts a round at K
   costs more than the tightness at K;
3. never below ``sl_min`` (an infeasible batch runs there; admission
   is where infeasibility is surfaced).

Lapsed deadlines (remaining <= 0) are left out of the tightness.  With
no live deadline, or before the latency model is ready, step 2 is
skipped and the policy is DSDE.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.policies.base import (HostRoundContext,
                                            as_host_round_context, register)
from repro_torch.core.policies.dsde import DSDEPolicy


def batch_tightness_s(ctx: HostRoundContext, k: int) -> Optional[float]:
    """The batch's tightest per-round wall budget at bucket ``k``, or
    None when no live finite positive deadline constrains the round."""
    if not ctx.has_deadlines():
        return None
    act = np.asarray(ctx.active, bool)
    dl = np.asarray(ctx.deadline_remaining_s, float)[act]
    if ctx.tokens_remaining is not None:
        rem = np.asarray(ctx.tokens_remaining)[act].astype(float)
    else:
        rem = np.ones(dl.shape)
    live = np.isfinite(dl) & (dl > 0.0)
    if not live.any():
        return None
    rounds = np.maximum(np.ceil(rem[live] / float(k + 1)), 1.0)
    return float((dl[live] / rounds).min())


@register("slo")
@dataclasses.dataclass(frozen=True)
class SLOPolicy(DSDEPolicy):
    """DSDE + deadline-aware host arbitration of the draft bucket."""

    def pick_bucket(self, ctx: HostRoundContext,
                    active: Optional[np.ndarray] = None) -> int:
        ctx = as_host_round_context(ctx, active, hook="pick_bucket")
        k = super().pick_bucket(ctx)
        lm = ctx.latency_model
        if lm is None or not lm.ready():
            return k
        b_eff = int(np.asarray(ctx.active, bool).sum())
        while k > self.spec.sl_min:
            budget = batch_tightness_s(ctx, k)
            if budget is None or lm.predict_round_s(k, b_eff) <= budget:
                break
            k -= 1
        return k
