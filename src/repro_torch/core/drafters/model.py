"""The draft-model proposer (``repro.core.drafters.model``): a separate
small model proposes K tokens per round from its own KV cache, in the
target's layout: a dense ring, or a pool that mirrors the target's block
ids so one allocator decision covers both pools."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import prefill as prefill_lib
from repro_torch.core.config import ModelConfig
from repro_torch.core.drafters.base import (DraftProposal, Drafter,
                                            model_flops_per_token,
                                            register_drafter)
from repro_torch.core.sampling import sample_token
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import commit as commit_model
from repro_torch.models.transformer import forward


def autoregressive_draft_loop(params, cfg: ModelConfig, cache: dict,
                              pending: torch.Tensor, k: int,
                              sl_i: torch.Tensor, policy: Any,
                              step_u: Callable[[int], torch.Tensor],
                              active: torch.Tensor, temperature: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, dict,
                                         torch.Tensor]:
    """K+1 single-token decode steps of ``params`` against ``cache`` (the
    last step only writes the last draft token's KV, so the cache is
    complete on total acceptance).  Row validity ``j < sl_i`` gives the
    ragged SL inside the bucket.  Returns (draft_tokens [B,K],
    draft_logits [B,K,V], drafted_cache, eff_sl [B])."""
    b = pending.shape[0]
    dev = pending.device
    tok = pending
    stop = torch.zeros((b,), dtype=torch.bool, device=dev)
    eff = torch.zeros((b,), dtype=torch.int32, device=dev)
    toks, logits = [], []
    cur = dict(cache)
    for j in range(k + 1):
        # step j writes position len+j, needed only up to the committed
        # horizon (j <= SL_i); inactive rows never write to a pool (a
        # ring ignores the mask: its writes are masked by kv_pos <= q_pos)
        wm = ((j <= sl_i) & active)[:, None]
        lg, cur = forward(params, cfg, tok[:, None], cache=cur,
                          mode="decode", write_mask=wm)
        lj = lg[:, 0]
        nxt = sample_token(step_u(j), lj, temperature,
                           cfg.vocab_size).to(torch.int32)
        keep = policy.draft_keep(lj)
        if keep is not None:
            stop = stop | ~keep
        live = (j < sl_i) & (j < k) & ~stop
        eff = eff + live.to(torch.int32)
        # the next step's positions: a NEW length tensor (the pre-round
        # cache dict keeps the original as the commit snapshot)
        cur["length"] = cur["length"] + 1
        toks.append(nxt)
        logits.append(lj)
        tok = nxt
    cur["length"] = cache["length"]          # restore; commit later
    draft_tokens = torch.stack(toks[:k], 1) if k else torch.zeros(
        (b, 0), dtype=torch.int32, device=dev)
    draft_logits = torch.stack(logits[:k], 1)
    return draft_tokens, draft_logits, cur, eff


@register_drafter("model")
@dataclasses.dataclass(frozen=True)
class ModelDrafter(Drafter):
    """Separate small draft model with a KV cache in the target's layout:
    a dense ring, or a pool that mirrors the target's block ids."""

    def uses_draft_model(self) -> bool:
        return True

    def mirrors_kv(self) -> bool:
        return True

    def step_cost(self) -> float:
        return (model_flops_per_token(self.cfg_d)
                / max(model_flops_per_token(self.cfg_t), 1.0))

    def init_cache(self, batch, max_len, paged=None, dtype=torch.float32,
                   device="cpu", kv_quant="none"):
        if paged is None:
            return cache_lib.cache_struct(self.cfg_d, batch, max_len, dtype,
                                          device)
        # the mirror inherits the target pool's storage mode, so a block
        # id means the same bytes on both sides
        n_blocks, bs = paged
        return cache_lib.paged_cache_struct(self.cfg_d, batch, max_len,
                                            n_blocks, bs, dtype, device,
                                            kv_quant=kv_quant)

    def prefill(self, params_d, cache, idx, tokens, prompt_lens,
                table_rows=None, max_len=None):
        if table_rows is None:
            rows, _ = prefill_lib.prefill_rows(params_d, self.cfg_d, tokens,
                                               prompt_lens, max_len)
            return prefill_lib.set_slots(cache, rows, idx)
        rows, _ = prefill_lib.prefill_paged_rows(
            params_d, self.cfg_d, cache["k"], cache["v"], cache["kv_pos"],
            table_rows, tokens, prompt_lens, cache.get("k_scale"),
            cache.get("v_scale"))
        return prefill_lib.scatter_paged_rows(cache, rows, idx)

    def propose(self, params_d, draft_cache, pending, k, sl_i, policy,
                step_u, live, *, params_t=None, target_cache=None):
        toks, logits, cache, eff = autoregressive_draft_loop(
            params_d, self.cfg_d, draft_cache, pending, k, sl_i, policy,
            step_u, live, self.spec.temperature)
        return DraftProposal(tokens=toks, logits=logits, cache=cache,
                             eff_sl=eff)

    def commit(self, tokens, snapshot, drafted, n_committed):
        return commit_model(snapshot, drafted, n_committed)
