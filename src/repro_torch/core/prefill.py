"""Multi-row prefill into the paged pool (``repro.core.prefill``), shared
by the engine (target) and the model drafter (draft mirror): one call
per admission group per model."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import forward


def prefill_paged_rows(params, cfg: ModelConfig, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, kv_pos: torch.Tensor,
                       table_rows: torch.Tensor, tokens: torch.Tensor,
                       prompt_lens: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[dict, torch.Tensor]:
    """Prefill R right-padded prompts ``tokens [R, S]`` straight into
    their allocated blocks (``table_rows [R, max_blocks]``; the pools,
    and the scale pools ``k_scale``/``v_scale`` of an int8 pool, are
    written in place).  Returns (cache view with per-row ``length``,
    last-token logits [R, V])."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
            < prompt_lens[:, None])
    view = cache_lib.paged_prefill_view(pool_k, pool_v, kv_pos, table_rows,
                                        k_scale, v_scale)
    logits, view = forward(params, cfg, tokens, cache=view, mode="prefill",
                           input_mask=mask)
    view["length"] = prompt_lens.to(torch.int32)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = logits[rows, (prompt_lens.long() - 1).clamp(min=0)]
    return view, last


def scatter_paged_rows(big: dict, rows: dict, idx: torch.Tensor) -> dict:
    """Fold a :func:`prefill_paged_rows` result into the batched cache:
    the pools are the same tensors, per-row ``length`` is scattered at
    ``idx``.  Block tables are the engine's to write."""
    out = dict(big)
    length = big["length"].clone()
    length[idx.long()] = rows["length"]
    out["length"] = length
    return out
