"""Multi-row prefill (``repro.core.prefill``), shared by the engine
(target) and the model drafter (draft mirror): one call per admission
group per model.  :func:`prefill_rows` builds fresh dense-ring rows that
:func:`set_slots` scatters into the batched ring; :func:`prefill_paged_rows`
writes straight into allocated pool blocks; :func:`prefill_paged_tail`,
its prefix-cache sibling, computes only the uncached tail of each row
after the group's copy-on-write block copies.

On a serving mesh (``plan``) a group's rows run whole on every rank, over
this rank's heads (SSD heads, experts' width); a ring, or recurrent rows
(a hybrid pool's too), whose rows split over *data* take only the rows
this rank holds (``own``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import forward


# ring leaves whose leading axis is the batch axis (the others are
# [layers, batch, ...]; an audio ring's cross K/V too)
BATCH_AXIS0 = ("length", "kv_pos", "enc_valid")


def _last_logits(logits: torch.Tensor, prompt_lens: torch.Tensor
                 ) -> torch.Tensor:
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, (prompt_lens.long() - 1).clamp(min=0)]


def prefill_rows(params, cfg: ModelConfig, tokens: torch.Tensor,
                 prompt_lens: torch.Tensor, max_len: int, plan=None
                 ) -> Tuple[dict, torch.Tensor]:
    """Prefill R right-padded prompts ``tokens [R, S]`` into fresh dense
    ring rows of a ``max_len`` cache.  With ``S >= W`` the ring keeps the
    last W columns, as the reference's does: the engine pads a group to
    the reference's prompt bucket, so both keep the same tokens.
    Returns (ring rows with per-row ``length``, last-token logits [R, V])."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
            < prompt_lens[:, None])
    rows = cache_lib.cache_struct(cfg, tokens.shape[0], max_len,
                                  device=tokens.device, plan=plan,
                                  whole_rows=True)
    logits, rows = forward(params, cfg, tokens, cache=rows, mode="prefill",
                           input_mask=mask, plan=plan)
    rows["length"] = prompt_lens.to(torch.int32)
    return rows, _last_logits(logits, prompt_lens)


def _scatter_recurrent(out: dict, big: dict, rows: dict,
                       idx: torch.Tensor,
                       own: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> None:
    """The recurrent rows (``ssd``, ``lru``, ``conv`` ``[layers, batch,
    ...]``) of a prefilled group into NEW tensors at the slots ``idx``
    (never in place: a round keeps the pre-round cache as its commit
    snapshot); ``own``: as :func:`set_slots` takes it.  The group's rows
    start from zero state, so a slot that was preempted and readmitted
    starts from its prompt, never from the old occupant's state."""
    for key in cache_lib.RECURRENT_KEYS:
        if key in big:
            new = rows[key].to(big[key].dtype)
            if own is None:
                out[key] = big[key].index_copy(1, idx, new)
            else:
                out[key] = big[key].index_copy(1, own[1], new[:, own[0]])


def set_slots(big: dict, rows: dict, idx: torch.Tensor,
              own: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
    """Scatter a :func:`prefill_rows` group into the batched ring at the
    R slots ``idx``: the rings and ``kv_pos`` in place, ``length`` and
    the recurrent rows into new tensors (a round keeps the pre-round
    dict as its snapshot).  ``own`` (a ring whose rows split over
    *data*): (group rows, local rows) of the slots this rank holds, where
    its K/V rings and recurrent rows take their rows."""
    idx = idx.long()
    out = dict(big)
    _scatter_recurrent(out, big, rows, idx, own)
    for key, val in big.items():
        if key in cache_lib.RECURRENT_KEYS:
            continue
        if key == "length":
            out[key] = val.clone()
            out[key][idx] = rows[key]
        elif key in BATCH_AXIS0:
            val[idx] = rows[key]
        elif own is not None:
            val[:, own[1]] = rows[key][:, own[0]]
        else:
            val[:, idx] = rows[key]
    return out


def prefill_paged_rows(params, cfg: ModelConfig, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, kv_pos: torch.Tensor,
                       table_rows: torch.Tensor, tokens: torch.Tensor,
                       prompt_lens: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None, plan=None
                       ) -> Tuple[dict, torch.Tensor]:
    """Prefill R right-padded prompts ``tokens [R, S]`` straight into
    their allocated blocks (``table_rows [R, max_blocks]``; the pools,
    and the scale pools ``k_scale``/``v_scale`` of an int8 pool, are
    written in place; a hybrid stack's recurrent rows are fresh rows of
    the view).  Returns (cache view with per-row ``length``,
    last-token logits [R, V])."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
            < prompt_lens[:, None])
    view = cache_lib.paged_prefill_view(pool_k, pool_v, kv_pos, table_rows,
                                        k_scale, v_scale, cfg=cfg, plan=plan)
    logits, view = forward(params, cfg, tokens, cache=view, mode="prefill",
                           input_mask=mask, plan=plan)
    view["length"] = prompt_lens.to(torch.int32)
    return view, _last_logits(logits, prompt_lens)


def prefill_paged_tail(params, cfg: ModelConfig, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, kv_pos: torch.Tensor,
                       table_rows: torch.Tensor, tokens: torch.Tensor,
                       start_lens: torch.Tensor, tail_lens: torch.Tensor,
                       cow_src: torch.Tensor, cow_dst: torch.Tensor,
                       plan=None, k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[dict, torch.Tensor]:
    """Partial-prefix prefill (DESIGN.md §12): row r's first
    ``start_lens[r]`` positions are already in shared pool blocks, and
    ``tokens [R, S]`` holds its right-padded tail of ``tail_lens[r]``
    tokens.  First the group's copy-on-write pairs ``cow_src/cow_dst
    [R]`` (int64, sentinel = the pool's block count) run, so a row whose
    tail rewrites the last slot of a shared block lands in its private
    fork; the scale pools of an int8 pool copy with their blocks.  Then
    a decode-mode pass over a view whose lengths are preset to
    ``start_lens`` places the tail at ``start + arange(S)`` and attends
    through the shared blocks (the paged attention kernel on CUDA
    tensors); ``write_mask`` sends the padding's KV writes to the drop
    block.  On a mesh (``plan``) the copies run on this rank's pool (its
    KV heads; the block axis is whole on every rank, so a block id names
    the same block everywhere) and the pass over its shards.  Returns
    (cache view with ``length = start + tail``, logits [R, V] at each
    row's last tail token)."""
    cache_lib.copy_blocks(pool_k, pool_v, kv_pos, cow_src, cow_dst)
    if k_scale is not None:
        cache_lib.copy_scales(k_scale, v_scale, cow_src, cow_dst)
    view = cache_lib.paged_prefill_view(pool_k, pool_v, kv_pos, table_rows,
                                        k_scale, v_scale, lengths=start_lens,
                                        cfg=cfg, plan=plan)
    write_mask = (torch.arange(tokens.shape[1], device=tokens.device)[None]
                  < tail_lens[:, None])
    logits, view = forward(params, cfg, tokens, cache=view, mode="decode",
                           write_mask=write_mask, plan=plan)
    view["length"] = (start_lens + tail_lens).to(torch.int32)
    return view, _last_logits(logits, tail_lens)


def scatter_paged_rows(big: dict, rows: dict, idx: torch.Tensor,
                       own: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> dict:
    """Fold a :func:`prefill_paged_rows` or :func:`prefill_paged_tail`
    result into the batched cache:
    the pools are the same tensors, per-row ``length`` and the hybrid
    family's recurrent rows (``lru``, ``conv``) are scattered at ``idx``
    into new tensors (``own``: this rank's of recurrent rows split over
    *data*, as :func:`set_slots` takes it).  Block tables are the
    engine's to write."""
    out = dict(big)
    idx = idx.long()
    length = big["length"].clone()
    length[idx] = rows["length"]
    out["length"] = length
    _scatter_recurrent(out, big, rows, idx, own)
    return out
