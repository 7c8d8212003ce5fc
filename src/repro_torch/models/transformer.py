"""The dense-family transformer of the port (``repro.models.transformer``).

``forward(params, cfg, tokens, cache=..., mode=...)`` has the
reference's three modes:

* ``"train"``   — full causal pass, no cache;
* ``"prefill"`` — right-padded prompts (``input_mask``) written into the
  cache, attention over the fresh K/V;
* ``"decode"``  — T tokens against the cache (T = 1 for a draft step,
  K+1 for verification), K/V written first, then attention straight off
  the cache — the CUDA kernel when the cache is a CUDA tensor, its plain
  version on the CPU.

The cache is a dense ring or a block-paged pool (``models/cache.py``).
A ring write lands at ``p % W`` and takes no write mask (a write past a
row's horizon is masked later by ``kv_pos <= q_pos``, as in the
reference); decode attends through :func:`ragged_attention`.  A pool
write goes through the block table (``write_mask`` drops per-token
writes); decode attends through :func:`paged_ragged_attention`.

An int8 pool (``k_scale`` in the cache) quantizes on every write; decode
attends through :func:`paged_ragged_attention_quant`, and prefill
attends over the fake-quantized fresh K/V, the values any later read of
the stored pool reconstructs (the reference's order).

The pool writes happen in place (see ``models/cache.py``); the returned
cache dict shares the pool tensors with the one passed in.  ``commit``
is length arithmetic on the verified cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.paged_attention import paged_ragged_attention
from repro_torch.kernels.paged_attention_quant import paged_ragged_attention_quant
from repro_torch.kernels.ragged_attention import ragged_attention
from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import (attend, attn_output, mlp_apply,
                                       qkv_project, rmsnorm, rope_angles)
from repro_torch.models.weights import Params


def _layer(params: Params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` parameters."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in params["layers"].items()}


def _attn_sublayer(p: dict, cfg: ModelConfig, x: torch.Tensor, layer: int,
                   mode: str, positions: torch.Tensor, rope,
                   input_mask: Optional[torch.Tensor],
                   cache: Optional[cache_lib.CacheT],
                   slots: Optional[torch.Tensor]) -> torch.Tensor:
    q, k, v = qkv_project(p, x, rope)
    b, t = x.shape[:2]
    window = cfg.attention_window
    quant = cache is not None and cache_lib.is_quantized(cache)
    ring = cache is not None and not cache_lib.is_paged(cache)
    if quant:
        scales = (cache["k_scale"][layer], cache["v_scale"][layer])
    if mode in ("train", "prefill"):
        valid = (input_mask if input_mask is not None
                 else torch.ones((b, t), dtype=torch.bool, device=x.device))
        ka, va = (cache_lib.fake_quantize_kv(torch.stack((k, v))).unbind(0)
                  if quant else (k, v))
        out = attend(q, ka, va, q_pos=positions, kv_pos=positions,
                     kv_valid=valid, window=window)
        if quant:
            cache_lib.write_kv_paged_quant(cache["k"][layer], cache["v"][layer],
                                           *scales, k, v, slots)
        elif ring:
            cache_lib.write_kv(cache["k"][layer], cache["v"][layer], k, v, slots)
        elif cache is not None:
            cache_lib.write_kv_paged(cache["k"][layer], cache["v"][layer], k, v,
                                     slots)
        return attn_output(p, out)
    pool_k, pool_v = cache["k"][layer], cache["v"][layer]
    if ring:
        cache_lib.write_kv(pool_k, pool_v, k, v, slots)
        out = ragged_attention(q.contiguous(), pool_k, pool_v, positions,
                               cache["kv_pos"], window=window)
    elif quant:
        cache_lib.write_kv_paged_quant(pool_k, pool_v, *scales, k, v, slots)
        out = paged_ragged_attention_quant(q.contiguous(), pool_k, pool_v,
                                           *scales, cache["block_table"],
                                           positions, cache["kv_pos"],
                                           window=window)
    else:
        cache_lib.write_kv_paged(pool_k, pool_v, k, v, slots)
        out = paged_ragged_attention(q.contiguous(), pool_k, pool_v,
                                     cache["block_table"], positions,
                                     cache["kv_pos"], window=window)
    return attn_output(p, out)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[cache_lib.CacheT] = None, mode: str = "train",
            input_mask: Optional[torch.Tensor] = None,
            write_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[cache_lib.CacheT]]:
    """Returns (logits [B, T, Vp] float32, cache).  ``write_mask [B, T]``
    (decode, paged pool) drops the KV writes of masked positions, so a
    short-SL sequence never writes outside its allocated blocks; a ring
    ignores it, as in the reference."""
    assert mode in ("train", "prefill", "decode")
    assert (cache is None) == (mode == "train"), (
        "train runs without a cache; prefill and decode need one")
    x = params["embed"][tokens.long()]
    b, t = x.shape[:2]
    ar = torch.arange(t, dtype=torch.int32, device=x.device)[None]
    if mode == "decode":
        positions = cache["length"][:, None] + ar
    else:
        positions = ar.expand(b, t)
    # per-call quantities every layer shares: RoPE angles, write slots
    rope = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    slots = None
    valid = input_mask if mode == "prefill" else None
    if cache is not None and not cache_lib.is_paged(cache):
        slots = cache_lib.ring_slots(positions, cache_lib.cache_window(cache))
        cache_lib.write_pos(cache["kv_pos"], positions, slots, valid=valid)
    elif cache is not None:
        slots = cache_lib.write_slots(
            positions, cache["block_table"], cache["kv_pos"].shape[1],
            cache["kv_pos"].shape[0],
            keep=write_mask if mode == "decode" else None)
        cache_lib.write_pos_paged(cache["kv_pos"], positions, slots,
                                  valid=valid)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        x = x + _attn_sublayer(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                               i, mode, positions, rope, input_mask, cache,
                               slots)
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["embed"].t()
    return logits.float(), (None if cache is None else dict(cache))


def commit(snapshot: cache_lib.CacheT, verified: cache_lib.CacheT,
           n_committed: torch.Tensor) -> cache_lib.CacheT:
    """Commit ``n_committed[b]`` of the tokens just verified: the ring
    or pool already holds their K/V, so this is ``length`` arithmetic
    (stale speculative slots are overwritten or masked, DESIGN.md §4)."""
    return cache_lib.commit_length(verified,
                                   snapshot["length"] + n_committed.to(torch.int32))
