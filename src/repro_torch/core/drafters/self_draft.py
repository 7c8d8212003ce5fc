"""Early-exit self-speculation (``repro.core.drafters.self_draft``): the
target's own first ``self_draft_layers`` layers draft, with the final
norm and LM head applied to the truncated hidden state.

The draft loop reads and writes a leading-layer view of the target
cache (``cache["k"][:n]``, ``cache["v"][:n]``): no second model, no
draft cache, no mirrored blocks.  The port writes the cache in place,
so the drafted K/V and ``kv_pos`` entries stay in the target cache;
verification rewrites positions ``len .. len+SL`` across all layers
before any query reads them, and every other drafted slot lies past the
committed length, where it is overwritten before it is read (the
overwrite-or-mask rollback argument, DESIGN.md §4).  So the streams are
the reference's, whose functional cache drops the drafted slice.

Supported families: the stacked homogeneous ones (dense / moe / vlm).
The reference slices ``k`` and ``v`` but not an int8 pool's per-layer
``k_scale`` / ``v_scale``, and its layer scan raises ``ValueError`` on
the mismatched stacks; the port raises the same error type when the
engine builds the drafter's cache on an int8 pool.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.drafters.base import (DraftProposal, Drafter,
                                            model_flops_per_token,
                                            register_drafter)
from repro_torch.core.drafters.model import autoregressive_draft_loop
from repro_torch.models.weights import map_params

_SELF_DRAFT_FAMILIES = ("dense", "moe", "vlm")


@register_drafter("self")
@dataclasses.dataclass(frozen=True)
class SelfDrafter(Drafter):
    """Truncated-target early-exit proposer sharing the target cache."""

    def __post_init__(self):
        if self.cfg_t.family not in _SELF_DRAFT_FAMILIES:
            raise ValueError(
                f"self-draft supports scanned stacks {_SELF_DRAFT_FAMILIES}"
                f", not family {self.cfg_t.family!r}")
        n = self.spec.self_draft_layers
        if not 1 <= n < self.cfg_t.num_layers:
            raise ValueError(
                f"self_draft_layers={n} must be in [1, "
                f"{self.cfg_t.num_layers - 1}] for {self.cfg_t.name}")

    # uses_draft_model / mirrors_kv: base defaults (False / False): the
    # draft KV lives in the target cache's own blocks

    def step_cost(self) -> float:
        return (model_flops_per_token(self._truncated_cfg())
                / max(model_flops_per_token(self.cfg_t), 1.0))

    def init_cache(self, batch, max_len, paged=None, dtype=torch.float32,
                   device="cpu", kv_quant="none"):
        if kv_quant != "none":
            raise ValueError(
                f"self-draft slices the target's K/V pools but not an "
                f"{kv_quant} pool's per-layer scales (as the reference "
                "does, whose layer scan then raises)")
        return ()          # stateless: everything lives in the target cache

    def propose(self, params_d, draft_cache, pending, k, sl_i, policy,
                step_u, live, *, params_t=None, target_cache=None):
        n = self.spec.self_draft_layers
        params_s = dict(params_t, layers=map_params(lambda a: a[:n],
                                                    params_t["layers"]))
        cache_s = dict(target_cache, k=target_cache["k"][:n],
                       v=target_cache["v"][:n])
        toks, logits, _, eff = autoregressive_draft_loop(
            params_s, self._truncated_cfg(), cache_s, pending, k, sl_i,
            policy, step_u, live, self.spec.temperature)
        return DraftProposal(tokens=toks, logits=logits, cache=draft_cache,
                             eff_sl=eff)

    # commit: base default (the snapshot): nothing persists between rounds

    def _truncated_cfg(self):
        return dataclasses.replace(
            self.cfg_t, num_layers=self.spec.self_draft_layers,
            name=self.cfg_t.name + "-selfdraft")
