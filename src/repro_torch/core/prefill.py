"""Multi-row prefill (``repro.core.prefill``), shared by the engine
(target) and the model drafter (draft mirror): one call per admission
group per model.  :func:`prefill_rows` builds fresh dense-ring rows that
:func:`set_slots` scatters into the batched ring; :func:`prefill_paged_rows`
writes straight into allocated pool blocks."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import forward


# ring leaves whose leading axis is the batch axis (the others are
# [layers, batch, ...])
BATCH_AXIS0 = ("length", "kv_pos")


def _last_logits(logits: torch.Tensor, prompt_lens: torch.Tensor
                 ) -> torch.Tensor:
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, (prompt_lens.long() - 1).clamp(min=0)]


def prefill_rows(params, cfg: ModelConfig, tokens: torch.Tensor,
                 prompt_lens: torch.Tensor, max_len: int
                 ) -> Tuple[dict, torch.Tensor]:
    """Prefill R right-padded prompts ``tokens [R, S]`` into fresh dense
    ring rows of a ``max_len`` cache.  With ``S >= W`` the ring keeps the
    last W columns, as the reference's does: the engine pads a group to
    the reference's prompt bucket, so both keep the same tokens.
    Returns (ring rows with per-row ``length``, last-token logits [R, V])."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
            < prompt_lens[:, None])
    rows = cache_lib.cache_struct(cfg, tokens.shape[0], max_len,
                                  device=tokens.device)
    logits, rows = forward(params, cfg, tokens, cache=rows, mode="prefill",
                           input_mask=mask)
    rows["length"] = prompt_lens.to(torch.int32)
    return rows, _last_logits(logits, prompt_lens)


def set_slots(big: dict, rows: dict, idx: torch.Tensor) -> dict:
    """Scatter a :func:`prefill_rows` group into the batched ring at the
    R slots ``idx``: the rings and ``kv_pos`` in place, ``length`` into
    a new tensor (a round keeps the pre-round dict as its snapshot)."""
    idx = idx.long()
    out = dict(big)
    for key, val in big.items():
        if key == "length":
            out[key] = val.clone()
            out[key][idx] = rows[key]
        elif key in BATCH_AXIS0:
            val[idx] = rows[key]
        else:
            val[:, idx] = rows[key]
    return out


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
    return view, _last_logits(logits, prompt_lens)


def scatter_paged_rows(big: dict, rows: dict, idx: torch.Tensor) -> dict:
    """Fold a :func:`prefill_paged_rows` result into the batched cache:
    the pools are the same tensors, per-row ``length`` is scattered at
    ``idx``.  Block tables are the engine's to write."""
    out = dict(big)
    length = big["length"].clone()
    length[idx.long()] = rows["length"]
    out["length"] = length
    return out
