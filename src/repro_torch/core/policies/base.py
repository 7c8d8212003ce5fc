"""The speculation-policy interface (DESIGN.md §6; ``repro.core.policies.base``).

* :class:`SpecPolicy` — a frozen object built from a
  :class:`SpecDecodeConfig`.  Device-side hooks (``init_state`` /
  ``observe`` / ``predict`` / ``draft_keep``) run inside the round on
  tensors and never read one back to the host; host-side hooks
  (``pick_bucket`` / ``lookahead``) take a :class:`HostRoundContext`
  built from numpy arrays the engine already holds (the bare-array
  form still works, with a ``DeprecationWarning``, through
  :func:`as_host_round_context`).
* a string registry (:func:`register` / :func:`build_policy`) keyed by
  ``SpecDecodeConfig.policy``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.config import SpecDecodeConfig

State = Any


@dataclasses.dataclass
class HostRoundContext:
    """Batch-global host-side view of one serving round, from numpy
    arrays the engine already holds (building it never syncs).

    ``deadline_remaining_s`` is +inf for slots without a deadline (and
    for empty slots), ``tokens_remaining`` 0 for empty slots; both are
    None when the builder has no per-request view, which policies read
    as "no deadlines".  ``latency_model`` is the engine's
    :class:`RoundLatencyModel` (or None): check ``ready()`` before
    acting on its predictions."""

    sl_next: np.ndarray                               # [B] int, SL predictions
    active: np.ndarray                                # [B] bool, live slots
    deadline_remaining_s: Optional[np.ndarray] = None  # [B] float, +inf unset
    tokens_remaining: Optional[np.ndarray] = None      # [B] int, budget left
    latency_model: Optional[Any] = None
    round_ordinal: int = 0

    @classmethod
    def from_arrays(cls, sl_next: np.ndarray,
                    active: Optional[np.ndarray] = None) -> "HostRoundContext":
        """Context over bare arrays; with no ``active`` every slot is
        live."""
        sl = np.asarray(sl_next)
        act = (np.ones(sl.shape, bool) if active is None
               else np.asarray(active).astype(bool))
        return cls(sl_next=sl, active=act)

    def _live_deadlines(self) -> Optional[np.ndarray]:
        """Finite, still attainable (> 0) deadlines of active slots: a
        lapsed deadline cannot be met at any K, so it must not pin the
        batch to minimum speculation."""
        if self.deadline_remaining_s is None:
            return None
        act = np.asarray(self.active, bool)
        if not act.any():
            return None
        dl = np.asarray(self.deadline_remaining_s, float)[act]
        dl = dl[np.isfinite(dl) & (dl > 0.0)]
        return dl if dl.size else None

    def has_deadlines(self) -> bool:
        """True iff some live slot carries an attainable deadline."""
        return self._live_deadlines() is not None

    def tightest_deadline_s(self) -> Optional[float]:
        """Smallest live attainable deadline remaining, or None."""
        dl = self._live_deadlines()
        return None if dl is None else float(dl.min())


def as_host_round_context(ctx: Any, active: Optional[np.ndarray] = None,
                          hook: str = "pick_bucket") -> HostRoundContext:
    """A host hook's argument as a :class:`HostRoundContext`: a context
    passes through; the older bare form (an SL array, optionally with an
    ``active`` mask) is wrapped, with a ``DeprecationWarning``."""
    if isinstance(ctx, HostRoundContext):
        if active is not None:
            raise TypeError(
                f"SpecPolicy.{hook}: pass either a HostRoundContext or the "
                "legacy (sl_next, active) arrays, not both")
        return ctx
    warnings.warn(
        f"SpecPolicy.{hook} with bare numpy positionals is deprecated; "
        "pass a HostRoundContext (e.g. HostRoundContext.from_arrays(sl, "
        "active) or LookaheadScheduler.host_context()). The positional "
        "form will be removed next release.",
        DeprecationWarning, stacklevel=3)
    return HostRoundContext.from_arrays(ctx, active)


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
        ctx = as_host_round_context(ctx, hook="lookahead")
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

    def pick_bucket(self, ctx: HostRoundContext,
                    active: Optional[np.ndarray] = None) -> int:
        """K = max live SL prediction, floored at sl_min."""
        ctx = as_host_round_context(ctx, active, hook="pick_bucket")
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
