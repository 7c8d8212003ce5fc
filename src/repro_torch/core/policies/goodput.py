"""Goodput-driven speculation control (``repro.core.policies.goodput``;
TurboSpec-style, beyond the paper).

A per-sequence EMA ``a`` of the draft-token acceptance rate, and under
the i.i.d.-acceptance approximation

    E[emitted | k]  =  1 + a (1 - a^k) / (1 - a)

per round of cost ``1 + c*k`` (``c`` the relative cost of a draft step),
the SL of each sequence is

    SL_i  =  argmax_k  E[emitted | k] / (1 + c*k),   k in [sl_min, sl_max]

capped by Eq. (11)'s SL_cap when ``use_sl_cap`` is set.  The argmax takes
the first maximum on ties, in ``torch`` as in ``numpy`` and ``jnp``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import adapter as adapter_lib
from repro_torch.core.config import SpecDecodeConfig
from repro_torch.core.policies.base import PolicyObservation, SpecPolicy, register

# per-draft-step cost used only when the config leaves
# ``goodput_draft_cost=None`` and no drafter resolved it (direct policy
# use); the serving engine resolves None from ``Drafter.step_cost()``
FALLBACK_DRAFT_COST = 0.08


def resolved_draft_cost(spec: SpecDecodeConfig) -> float:
    return (spec.goodput_draft_cost
            if spec.goodput_draft_cost is not None else FALLBACK_DRAFT_COST)


def _goodput_curve(spec: SpecDecodeConfig, acc, xp):
    """Goodput G [B, nK] over the k-grid [sl_min .. sl_max], for ``xp``
    ``torch`` (the round, on ``acc``'s device) or ``numpy`` (the host's
    initial SL): one formula for both.  The grid is int64 as numpy's
    ``arange`` makes it, and the cost factor fp32."""
    if xp is torch:
        ks = torch.arange(spec.sl_min, spec.sl_max + 1, device=acc.device)
        ks_f = ks.to(torch.float32)
    else:
        ks = np.arange(spec.sl_min, spec.sl_max + 1)
        ks_f = ks.astype(np.float32)
    a = xp.clip(acc, 1e-3, 0.999)[:, None]                   # [B, 1]
    e_acc = a * (1.0 - a ** ks[None, :]) / (1.0 - a)         # [B, nK]
    goodput = (1.0 + e_acc) / (1.0 + resolved_draft_cost(spec) * ks_f[None, :])
    return ks, goodput


@functools.lru_cache(maxsize=None)
def _initial_sl_host(spec: SpecDecodeConfig) -> int:
    """argmax SL at the optimistic prior, in numpy (admission runs it on
    the host, so no device work)."""
    ks, g = _goodput_curve(
        spec, np.array([spec.goodput_init_acc], np.float32), np)
    return int(ks[int(np.argmax(g[0]))])


class GoodputState(NamedTuple):
    acc_ema: torch.Tensor    # [B] f32 EMA of the per-round acceptance
    obs_count: torch.Tensor  # [B] int32 rounds folded in (0 = prior only)
    sl_pred: torch.Tensor    # [B] int32 last prediction


@register("goodput")
@dataclasses.dataclass(frozen=True)
class GoodputPolicy(SpecPolicy):
    def init_state(self, batch: int, device="cpu") -> GoodputState:
        return GoodputState(
            acc_ema=torch.full((batch,), self.spec.goodput_init_acc,
                               dtype=torch.float32, device=device),
            obs_count=torch.zeros((batch,), dtype=torch.int32, device=device),
            sl_pred=torch.full((batch,), self.initial_sl_value(),
                               dtype=torch.int32, device=device))

    def initial_sl_value(self) -> int:
        # the prior's own argmax, so the first rounds already speculate
        # at the depth it implies
        return _initial_sl_host(self.spec)

    def observe(self, state: GoodputState, obs: PolicyObservation
                ) -> GoodputState:
        prop = obs.num_proposed.to(torch.float32)
        took = (prop > 0) & obs.active
        a_step = obs.num_accepted.to(torch.float32) / prop.clamp(min=1.0)
        d = self.spec.goodput_ema
        ema = torch.where(took, d * state.acc_ema + (1.0 - d) * a_step,
                          state.acc_ema)
        count = state.obs_count + took.to(torch.int32)
        return state._replace(acc_ema=ema, obs_count=count)

    def predict(self, state: GoodputState, active: torch.Tensor):
        ks, goodput = _goodput_curve(self.spec, state.acc_ema, torch)
        sl = ks[torch.argmax(goodput, dim=-1)].to(torch.int32)
        tel = {"acc_ema": state.acc_ema,
               "goodput_sl_raw": sl.to(torch.float32)}
        if self.spec.use_sl_cap:
            capped, cap = adapter_lib.apply_sl_cap(
                sl.to(torch.float32), self.spec, active)
            sl = torch.round(capped).clamp(self.spec.sl_min,
                                           self.spec.sl_max).to(torch.int32)
            tel["sl_cap"] = cap
        return sl, state._replace(sl_pred=sl), tel
