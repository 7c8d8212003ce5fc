"""The speculation-policy interface (DESIGN.md §6; ``repro.core.policies.base``).

* :class:`SpecPolicy` — a frozen object built from a
  :class:`SpecDecodeConfig`.  Device-side hooks (``init_state`` /
  ``observe`` / ``predict``) run inside the round on tensors; host-side
  hooks (``pick_bucket`` / ``lookahead``) take a :class:`HostRoundContext`
  built from numpy arrays the engine already holds.
* a string registry (:func:`register` / :func:`build_policy`) keyed by
  ``SpecDecodeConfig.policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.config import SpecDecodeConfig

State = Any


@dataclasses.dataclass
class HostRoundContext:
    """Batch-global host-side view of one serving round: per-slot SL
    predictions and live mask, as numpy arrays the engine already holds.
    (The reference's deadline, token-budget and latency-model fields
    come with the ``slo`` policy.)"""

    sl_next: np.ndarray
    active: np.ndarray


def masked_row_reset(fresh: State, state: State, rows: torch.Tensor) -> State:
    """Replace rows of every tensor of ``state`` (a tensor or a nested
    tuple / NamedTuple of tensors) with ``fresh`` where the [B] bool mask
    ``rows`` is set."""
    if isinstance(state, torch.Tensor):
        m = rows.reshape(rows.shape + (1,) * (state.dim() - 1))
        return torch.where(m, fresh, state)
    parts = [masked_row_reset(f, s, rows) for f, s in zip(fresh, state)]
    return type(state)(*parts) if hasattr(state, "_fields") else type(state)(parts)


class PolicyObservation(NamedTuple):
    """Post-hoc statistics of one verification step."""
    kld: torch.Tensor             # [B, K] per-position KL(target || draft)
    proposed_valid: torch.Tensor  # [B, K] bool
    num_accepted: torch.Tensor    # [B]
    num_proposed: torch.Tensor    # [B]
    active: torch.Tensor          # [B] bool, live slots


@dataclasses.dataclass(frozen=True)
class SpecPolicy:
    """Per-sequence speculation-length controller; all mutable state
    lives in the object ``init_state`` returns."""

    spec: SpecDecodeConfig

    # ------------------------------------------------------- device-side
    def init_state(self, batch: int, device="cpu") -> State:
        return ()

    def initial_sl_value(self) -> int:
        raise NotImplementedError

    def initial_sl(self, batch: int, device="cpu") -> torch.Tensor:
        return torch.full((batch,), self.initial_sl_value(),
                          dtype=torch.int32, device=device)

    def reset_rows(self, state: State, rows: torch.Tensor) -> State:
        return masked_row_reset(self.init_state(rows.shape[0], rows.device),
                                state, rows)

    def observe(self, state: State, obs: PolicyObservation) -> State:
        return state

    def predict(self, state: State, active: torch.Tensor
                ) -> Tuple[torch.Tensor, State, Dict[str, torch.Tensor]]:
        """(sl [B] int32, new_state, telemetry) for the next round."""
        raise NotImplementedError

    def draft_keep(self, logits: torch.Tensor) -> Optional[torch.Tensor]:
        """In-draft early stop mask [B], or None for no early stop."""
        return None

    # --------------------------------------------------------- host-side
    def uses_draft(self) -> bool:
        return True

    def lookahead(self, ctx: HostRoundContext) -> np.ndarray:
        """KV slots each sequence needs next round: SL_i + 1 bonus."""
        return np.asarray(ctx.sl_next) + 1

    def max_lookahead(self) -> int:
        """Worst-case KV slots one round can consume (admission)."""
        return self.spec.sl_max + 1

    def max_bucket(self) -> int:
        """Largest bucket any round can run (``pick_bucket``'s upper
        bound): the pipelined engine's bucket at temperature > 0."""
        if not self.uses_draft():
            return 0
        return self.max_lookahead() - 1

    def pick_bucket(self, ctx: HostRoundContext) -> int:
        """K = max live SL prediction, floored at sl_min."""
        if not self.uses_draft():
            return 0
        sl = np.asarray(ctx.sl_next)
        act = np.asarray(ctx.active)
        live = sl[act] if act.any() else sl
        return int(max(live.max() if live.size else self.spec.sl_min,
                       self.spec.sl_min))


_REGISTRY: Dict[str, Type[SpecPolicy]] = {}


def register(name: str) -> Callable[[Type[SpecPolicy]], Type[SpecPolicy]]:
    def deco(cls: Type[SpecPolicy]) -> Type[SpecPolicy]:
        _REGISTRY[name] = cls
        return cls
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build_policy(spec: SpecDecodeConfig) -> SpecPolicy:
    try:
        cls = _REGISTRY[spec.policy]
    except KeyError:
        raise KeyError(
            f"unknown speculation policy {spec.policy!r}; "
            f"registered: {', '.join(available_policies())}") from None
    return cls(spec)
