"""The drafter interface (DESIGN.md §9; ``repro.core.drafters.base``).

A :class:`Drafter` is a frozen object built from ``(SpecDecodeConfig,
target ModelConfig, optional draft ModelConfig)``.  It owns proposal
generation (:meth:`propose`, which returns the proposal distribution
too), its own per-sequence cache (:meth:`init_cache` / :meth:`prefill`
/ :meth:`commit`), and the policy-observation divergence
(:meth:`observation_kld`).  Host-side hooks say whether the engine must
hand it draft params and whether it mirrors the target's block pool.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.core.config import ModelConfig, SpecDecodeConfig
from repro_torch.core.signals import kld_per_position

State = Any


class DraftProposal(NamedTuple):
    tokens: torch.Tensor   # [B, K] int32 proposed draft tokens
    logits: torch.Tensor   # [B, K, V] f32 — the proposal distribution q
    cache: State           # drafter cache after proposing (pre-commit)
    eff_sl: torch.Tensor   # [B] int32 — positions actually proposed


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Rough decode FLOPs/token of one forward (projections + MLP + LM
    head), the single source for :meth:`Drafter.step_cost` ratios."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    attn = 2 * d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = 2 * d * cfg.d_ff * 3
    return float(cfg.num_layers * (attn + mlp) + 2 * d * cfg.vocab_size)


@dataclasses.dataclass(frozen=True)
class Drafter:
    spec: SpecDecodeConfig
    cfg_t: ModelConfig
    cfg_d: Optional[ModelConfig] = None

    # --------------------------------------------------------- host-side
    def uses_draft_model(self) -> bool:
        return False

    def mirrors_kv(self) -> bool:
        return False

    def step_cost(self) -> float:
        return 0.0

    # ------------------------------------------------------- device-side
    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[Tuple[int, int]] = None,
                   dtype=torch.float32, device="cpu",
                   kv_quant: str = "none") -> State:
        """``paged`` is the target's pool geometry ``(num_blocks,
        block_size)``, None for a dense ring; ``kv_quant`` the pool's
        storage mode.  A drafter that keeps KV uses the same layout."""
        return ()

    def prefill(self, params_d, cache: State, idx: torch.Tensor,
                tokens: torch.Tensor, prompt_lens: torch.Tensor,
                table_rows: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None) -> State:
        """Absorb an admission group: right-padded prompts ``tokens [R,
        S]`` landing in batch slots ``idx [R]``, with block-table rows
        ``table_rows [R, max_blocks]`` on the paged pool, or fresh ring
        rows of a ``max_len`` cache when ``table_rows`` is None."""
        return cache

    def propose(self, params_d, draft_cache: State, pending: torch.Tensor,
                k: int, sl_i: torch.Tensor, policy: Any,
                step_u: Callable[[int], torch.Tensor],
                live: torch.Tensor, *, params_t=None,
                target_cache: Optional[dict] = None) -> DraftProposal:
        """Up to ``k`` proposals per sequence (``sl_i [B]`` the budget, 0
        for dead rows).  ``step_u(j)`` gives the [B] uniforms of draft
        step j (identity-threaded).  ``params_t`` / ``target_cache`` are
        the target's parameters and pre-round cache, for a drafter that
        drafts with the target itself."""
        raise NotImplementedError

    def commit(self, tokens: torch.Tensor, snapshot: State, drafted: State,
               n_committed: torch.Tensor) -> State:
        """Commit ``n_committed[b]`` of the round's ``tokens [B, K+1]``
        (pending + proposals).  ``snapshot`` is the pre-round cache,
        ``drafted`` the one :meth:`propose` returned."""
        return snapshot

    def reset_rows(self, cache: State, rows: torch.Tensor) -> State:
        """Clear the rows ``rows [B]`` bool that an admission replaces
        (identity unless the drafter keeps per-row state that prefill
        does not rewrite)."""
        return cache

    def observation_kld(self, target_logits: torch.Tensor,
                        draft_logits: torch.Tensor, tokens: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
        """KL(p_target ‖ q_draft) per proposed position — the fused KLD
        kernel on CUDA, its plain version on CPU."""
        return kld_per_position(target_logits, draft_logits, tokens, valid)


_REGISTRY: Dict[str, Type[Drafter]] = {}


def register_drafter(name: str) -> Callable[[Type[Drafter]], Type[Drafter]]:
    def deco(cls: Type[Drafter]) -> Type[Drafter]:
        _REGISTRY[name] = cls
        return cls
    return deco


def available_drafters() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build_drafter(spec: SpecDecodeConfig, cfg_t: ModelConfig,
                  cfg_d: Optional[ModelConfig] = None) -> Drafter:
    try:
        cls = _REGISTRY[spec.drafter]
    except KeyError:
        raise KeyError(
            f"unknown drafter {spec.drafter!r}; "
            f"registered: {', '.join(available_drafters())}") from None
    return cls(spec, cfg_t, cfg_d)
