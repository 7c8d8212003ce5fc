"""Model assembly of the port (``repro.models.transformer``): all six
of the reference's families, dense, MoE, SSM (Mamba-2), hybrid (RG-LRU +
local attention), vlm (qwen2-vl: M-RoPE) and audio (an encoder-decoder).

``forward(params, cfg, tokens, cache=..., mode=...)`` has the
reference's three modes:

* ``"train"``   — full causal pass, no cache; ``remat=True`` keeps only
  each layer's input for the backward pass and runs the layer again
  there (the reference's ``jax.checkpoint`` per layer);
* ``"prefill"`` — right-padded prompts (``input_mask``) written into the
  cache, attention over the fresh K/V;
* ``"decode"``  — T tokens against the cache (T = 1 for a draft step,
  K+1 for verification), K/V written first, then attention straight off
  the cache — the CUDA kernel when the cache is a CUDA tensor, its plain
  version on the CPU.

Train and prefill calls of ``BLOCKWISE_THRESHOLD`` tokens or more
attend blockwise (``models/flash.py``), as the reference does, so train
mode never holds the T x T scores.

An MoE layer replaces the MLP with :func:`models.moe.moe_apply`, whose
expert capacity counts every row of the call.  Under ``kv_head_pad`` the
cache stores each real KV head replicated (``_pad_kv``), and decode
attends over the replicated heads.

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

An SSM layer is the Mamba-2 mixer (``models/ssm.py``); the ssm cache
has no K/V.  A hybrid stack runs RecurrentGemma's (rec, rec, attn)
groups, then a tail of recurrent layers (``models/rglru.py``); its
attention layers are local (window ``rglru.local_attention_window``) and
index the K/V ring or pool by their attention index, not their layer
index.  A prefill over right-padded prompts masks the recurrent steps of
the padding (``update_mask``), as the reference does.

A vlm stack is the dense stack; a caller may pass ``embeds`` (the
vision stub's patch embeddings) in place of tokens and ``rope_positions
[B, T, 3]`` for M-RoPE.  An audio stack is an encoder-decoder:
:func:`encode` runs the bidirectional encoder over frame embeddings,
:func:`build_cross_cache` projects its output to every decoder layer's
cross K/V, and each decoder layer runs self-attention (on the dense
ring), cross-attention (no RoPE, not causal, over ``enc_valid``) and the
MLP.  With a cache the cross K/V come from it (``cross_k``/``cross_v``,
``enc_valid``); in train mode from ``encoder_embeds``.

The pool writes happen in place (see ``models/cache.py``); the returned
cache dict shares the pool tensors with the one passed in, but holds new
recurrent tensors.  ``commit`` is length arithmetic on the verified
cache for the attention families, and the reference's masked re-advance
from the pre-round snapshot for the recurrent ones.

On a serving mesh (``plan``, a ``core.tp.MeshPlan``; every family) the
parameters and caches are this rank's shards: the lookup is
vocab-parallel, each attention sublayer (self, local, cross and the
encoder's) runs its query heads over the KV heads its cache keeps
(``HeadLayout``), ``attn_output``, the MLP, the MoE experts and the
Mamba-2 mixer end in the all-reduce over *model* where they contract a
split dim, and the logits are gathered whole over the vocabulary.  The
RG-LRU block replicates.  On a ring whose rows split over *data* the
call runs this rank's rows (``kv_pos``, ``length``, ``enc_valid`` and
the tokens stay whole; an MoE layer gathers the call's rows to route
them) and gathers the logits' rows.  A hybrid pool splits its recurrent
rows over *data* too: each data rank runs its own rows through the
RG-LRU layers and gathers every row before a local-attention layer, so
the pool that every data rank writes stays whole and equal.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import FAMILIES, ModelConfig
from repro_torch.kernels.paged_attention import paged_ragged_attention
from repro_torch.kernels.paged_attention_quant import paged_ragged_attention_quant
from repro_torch.kernels.ragged_attention import ragged_attention
from repro_torch.core import tp as tp_lib
from repro_torch.core.cost_hooks import fill_skipped, trips
from repro_torch.core.dtensor_ops import (attend_sharded, batch_only,
                                          embed_sharded, gather_fsdp,
                                          replicated_call, shard_as)
from repro_torch.models import cache as cache_lib
from repro_torch.models.flash import flash_attend
from repro_torch.models.layers import (attend, attn_output, head_proj,
                                       mlp_apply, qkv_project, rmsnorm,
                                       rope_angles)
from repro_torch.models.moe import moe_apply, moe_apply_mesh
from repro_torch.models.rglru import rglru_block
from repro_torch.models.ssm import mamba_mixer
from repro_torch.models.weights import Params, map_params


# train and prefill calls of this many tokens attend blockwise
# (``models/flash.py``), as the reference's do
BLOCKWISE_THRESHOLD = 2048


def _layer(params: Params, i: int, stack: str = "layers",
           sharded: bool = False) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` parameters
    ``params[stack]`` (the decoder's ``layers``, or an encoder-decoder's
    ``enc_layers``); ``sharded`` (DTensor parameters, the dry run):
    gathered over the batch axes first (FSDP)."""
    p = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
             else v[i]) for k, v in params[stack].items()}
    return gather_fsdp(p) if sharded else p


def _sharded(x) -> bool:
    """Whether ``x`` is a DTensor (the dry run on a mesh)."""
    return hasattr(x, "device_mesh")


def _tp_in(h: torch.Tensor) -> torch.Tensor:
    """A sublayer's input: on a DTensor, whole over every axis but the
    batch's (sequence parallelism's all-gather); else ``h``."""
    return batch_only(h) if _sharded(h) else h


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``; on DTensors ``h`` (a partial sum over the model axis)
    is first reduced to ``x``'s layout (all-reduce, or reduce-scatter
    under sequence parallelism)."""
    if _sharded(x):
        h = h.redistribute(x.device_mesh, x.placements)
    return x + h


def _attention(fn, q, k, v, **kw) -> torch.Tensor:
    """An attention core (``attend`` or ``flash_attend``); on DTensors on
    each device's batch and head shards (``attend_sharded``)."""
    if not _sharded(q):
        return fn(q, k, v, **kw)
    return attend_sharded(fn, q, k, v, **kw)


def _embed(table: torch.Tensor, tokens: torch.Tensor, plan=None,
           layout=None) -> torch.Tensor:
    """The token embeddings: rows of ``table``; a DTensor table (the dry
    run) looks up vocab-parallel (``core.dtensor_ops.embed_sharded``)
    where indexing would gather the whole table; a serving mesh's
    vocab-split table too, on local rows (``core.tp.embed_lookup``)."""
    if _sharded(table):
        return embed_sharded(table, tokens)
    if layout is not None and layout.vocab:
        return tp_lib.embed_lookup(table, tokens, layout.vocab_lo, plan)
    return table[tokens.long()]


def _pad_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's copy of fresh K/V under ``kv_head_pad``: padded head j
    is real head j // r, matching the query heads' grouping exactly.  On
    a mesh ``k``/``v`` hold a rank's run of real heads, each repeated r
    times as well."""
    pad = cfg.kv_head_pad
    if pad is None or cfg.num_kv_heads >= pad:
        return k, v
    b, t, kv, d = k.shape
    r = pad // cfg.num_kv_heads
    return tuple(x[:, :, :, None].expand(b, t, kv, r, d)
                 .reshape(b, t, kv * r, d) for x in (k, v))


def _pin_heads(x: torch.Tensor, attn_sharding) -> torch.Tensor:
    """``x [B, T, H, D]`` held to the head-axis TP layout (the
    reference's ``pin_heads``) when its heads divide the axis; a no-op
    without ``attn_sharding`` (single card)."""
    if attn_sharding is None or x.shape[2] % attn_sharding[1]:
        return x
    return shard_as(x, attn_sharding[0])


def _expand_kv(k: torch.Tensor, v: torch.Tensor, h: int, attn_sharding
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V for sharded train/prefill attention: when the KV heads do not
    divide the head axis, repeated to all ``h`` query heads (GQA as
    MHA, the same values), so the attention stays sharded on the full
    head dim instead of running replicated (the reference's
    ``expand_kv``); then pinned."""
    kv = k.shape[2]
    if kv != h and kv % attn_sharding[1]:
        k, v = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
    return _pin_heads(k, attn_sharding), _pin_heads(v, attn_sharding)


def _attn_sublayer(p: dict, cfg: ModelConfig, x: torch.Tensor, layer: int,
                   mode: str, positions: torch.Tensor, rope,
                   input_mask: Optional[torch.Tensor],
                   cache: Optional[cache_lib.CacheT],
                   slots: Optional[torch.Tensor],
                   window: Optional[int], causal: bool = True,
                   attn_sharding=None, plan=None) -> torch.Tensor:
    q, k, v = qkv_project(p, cfg, x, rope)
    layout = None if plan is None else plan.layout(cfg)
    reduce_plan = plan if layout is not None and layout.heads else None
    if layout is not None and layout.real_kv is not None:
        # query heads split over KV heads that replicate: the group they read
        k, v = k[:, :, layout.real_kv], v[:, :, layout.real_kv]
    b, t = x.shape[:2]
    quant = cache is not None and cache_lib.is_quantized(cache)
    ring = cache is not None and not cache_lib.is_paged(cache)
    if quant:
        scales = (cache["k_scale"][layer], cache["v_scale"][layer])
    if mode in ("train", "prefill"):
        valid = (input_mask if input_mask is not None
                 else torch.ones((b, t), dtype=torch.bool, device=x.device))
        ka, va = (cache_lib.fake_quantize_kv(torch.stack((k, v))).unbind(0)
                  if quant else (k, v))
        if attn_sharding is not None:
            q = _pin_heads(q, attn_sharding)
            ka, va = _expand_kv(ka, va, q.shape[2], attn_sharding)
        if t >= BLOCKWISE_THRESHOLD:
            out = _attention(flash_attend, q, ka, va, kv_valid=input_mask,
                             window=window, causal=causal)
        else:
            out = _attention(attend, q, ka, va, q_pos=positions,
                             kv_pos=positions, kv_valid=valid, window=window,
                             causal=causal)
        k, v = _cache_heads(cfg, k, v, layout)
        if quant:
            cache_lib.write_kv_paged_quant(cache["k"][layer], cache["v"][layer],
                                           *scales, k, v, slots)
        elif ring:
            cache_lib.write_kv(cache["k"][layer], cache["v"][layer], k, v, slots)
        elif cache is not None:
            cache_lib.write_kv_paged(cache["k"][layer], cache["v"][layer], k, v,
                                     slots)
        return attn_output(p, out, reduce_plan)
    pool_k, pool_v = cache["k"][layer], cache["v"][layer]
    k, v = _cache_heads(cfg, k, v, layout)
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
    return attn_output(p, out, reduce_plan)


def _cache_heads(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, layout
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh K/V as the cache stores them: padded (``_pad_kv``), then on
    a mesh cut to the KV heads this rank's cache keeps."""
    k, v = _pad_kv(cfg, k, v)
    if layout is not None and layout.cache_kv is not None:
        k, v = k[:, :, layout.cache_kv], v[:, :, layout.cache_kv]
    return k, v


def _mlp_plan(cfg: ModelConfig, plan):
    """The plan an MLP's down projection reduces over: ``plan`` where the
    width splits over *model*, else None."""
    return plan if plan is not None and plan.layout(cfg).mlp else None


def _block(p: dict, cfg: ModelConfig, x: torch.Tensor, layer: int,
           mode: str, positions: torch.Tensor, rope,
           input_mask: Optional[torch.Tensor],
           cache: Optional[cache_lib.CacheT],
           slots: Optional[torch.Tensor], attn_sharding=None,
           moe_sharding=None, plan=None, rows=None
           ) -> Tuple[torch.Tensor, dict]:
    """One pre-norm layer: attention, then the MLP or the MoE block, each
    residual.  Returns (x, the MoE block's aux; empty for dense).
    ``rows``: the call's rows ``x`` holds on a data-split ring."""
    x = _residual(x, _attn_sublayer(
        p["attn"], cfg, _tp_in(rmsnorm(x, p["ln1"], cfg.norm_eps)), layer,
        mode, positions, rope, input_mask, cache, slots,
        cfg.attention_window, attn_sharding=attn_sharding, plan=plan))
    h = _tp_in(rmsnorm(x, p["ln2"], cfg.norm_eps))
    if cfg.family == "moe":
        if plan is not None:
            h, aux = moe_apply_mesh(p["moe"], cfg.moe, h, plan, rows,
                                    plan.layout(cfg).mlp)
        else:
            h, aux = (moe_apply(p["moe"], cfg.moe, h) if moe_sharding is None
                      else moe_apply(p["moe"], cfg.moe, h,
                                     shardings=moe_sharding))
        return _residual(x, h), aux
    return _residual(x, mlp_apply(p["mlp"], h, _mlp_plan(cfg, plan))), {}


def _ssm_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[dict], update_mask: Optional[torch.Tensor],
               mode: str, plan=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba-2 layer (pre-norm, residual): the chunked form in train
    and prefill, the token recurrence in decode; on a mesh over this
    rank's SSD heads."""
    heads = None if plan is None else plan.layout(cfg).ssd

    def mixer(pm, h, st, um):
        return mamba_mixer(pm, cfg, h, state=st, update_mask=um,
                           use_chunked=mode in ("train", "prefill"),
                           heads=heads, plan=plan)
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    if not _sharded(h):
        h, new_state = mixer(p["mixer"], h, state, update_mask)
    else:
        h, new_state = replicated_call(mixer, p["mixer"], h, state,
                                       update_mask)
    return _residual(x, h), new_state


def _rec_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[dict], update_mask: Optional[torch.Tensor],
               mode: str, plan=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """One RG-LRU layer of a hybrid stack: the recurrent block, then the
    MLP, each pre-norm and residual (the scan in train and prefill, the
    step recurrence in decode).  On a mesh the block is whole on every
    rank and the MLP splits."""
    def block(pt, h, st, um):
        return rglru_block(pt, cfg, h, state=st, update_mask=um,
                           sequential=mode == "decode")
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if not _sharded(h):
        h, new_state = block(p["temporal"], h, state, update_mask)
    else:
        h, new_state = replicated_call(block, p["temporal"], h, state,
                                       update_mask)
    x = _residual(x, h)
    return _residual(x, mlp_apply(
        p["mlp"], _tp_in(rmsnorm(x, p["ln2"], cfg.norm_eps)),
        _mlp_plan(cfg, plan))), new_state


def _local_attn_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      attn_index: int, mode: str, positions: torch.Tensor,
                      rope, input_mask: Optional[torch.Tensor],
                      cache: Optional[cache_lib.CacheT],
                      slots: Optional[torch.Tensor],
                      attn_sharding=None, plan=None) -> torch.Tensor:
    """One local-attention layer of a hybrid stack, whose K/V live at
    ``attn_index`` of the cache's layer axis (attention layers only)."""
    x = _residual(x, _attn_sublayer(
        p["temporal"], cfg, _tp_in(rmsnorm(x, p["ln1"], cfg.norm_eps)),
        attn_index, mode, positions, rope, input_mask, cache, slots,
        cfg.rglru.local_attention_window, attn_sharding=attn_sharding,
        plan=plan))
    return _residual(x, mlp_apply(
        p["mlp"], _tp_in(rmsnorm(x, p["ln2"], cfg.norm_eps)),
        _mlp_plan(cfg, plan)))


def _cross_attend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor,
                  enc_valid: torch.Tensor, plan=None) -> torch.Tensor:
    """Decoder -> encoder cross-attention over one layer's cross K/V
    ``[B, S_enc, KV, D]``: no RoPE, not causal, keys masked by
    ``enc_valid [B, S_enc]`` (a row with no valid key gets 0).  On a
    mesh over this rank's query heads and the KV heads its cross cache
    keeps (:func:`build_cross_cache`)."""
    q = head_proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    b, t, s = x.shape[0], x.shape[1], ck.shape[1]
    i32 = dict(dtype=torch.int32, device=x.device)
    out = _attention(attend, q, ck, cv, q_pos=torch.zeros((b, t), **i32),
                     kv_pos=torch.zeros((b, s), **i32), kv_valid=enc_valid,
                     causal=False)
    heads = plan is not None and plan.layout(cfg).heads
    return attn_output(p, out, plan if heads else None)


def _audio_block(p: dict, cfg: ModelConfig, x: torch.Tensor, layer: int,
                 mode: str, positions: torch.Tensor, rope,
                 input_mask: Optional[torch.Tensor],
                 cache: Optional[cache_lib.CacheT],
                 slots: Optional[torch.Tensor], ck: torch.Tensor,
                 cv: torch.Tensor, enc_valid: torch.Tensor,
                 attn_sharding=None, plan=None) -> torch.Tensor:
    """One decoder layer of an encoder-decoder: self-attention (the
    dense ring in decode), cross-attention over ``ck``/``cv``, the MLP,
    each pre-norm (``ln1``, ``ln2``, ``ln3``) and residual."""
    x = _residual(x, _attn_sublayer(
        p["self_attn"], cfg, _tp_in(rmsnorm(x, p["ln1"], cfg.norm_eps)),
        layer, mode, positions, rope, input_mask, cache, slots, None,
        attn_sharding=attn_sharding, plan=plan))
    x = _residual(x, _cross_attend(
        p["cross_attn"], cfg, _tp_in(rmsnorm(x, p["ln2"], cfg.norm_eps)), ck,
        cv, enc_valid, plan))
    return _residual(x, mlp_apply(
        p["mlp"], _tp_in(rmsnorm(x, p["ln3"], cfg.norm_eps)),
        _mlp_plan(cfg, plan)))


def encode(params: Params, cfg: ModelConfig, embeds: torch.Tensor,
           enc_valid: Optional[torch.Tensor] = None,
           attn_sharding=None, plan=None) -> torch.Tensor:
    """The bidirectional encoder over front-end embeddings ``[B, S, d]``
    (``enc_valid [B, S]`` masks padded frames as keys): RoPE over the
    frame positions, attention not causal, then ``enc_norm``.  (Its
    input needs no gradient, so its first layer's backward differs from
    the rest: the light iteration of :func:`trips` runs first.)
    ``plan``: on a serving mesh's shards, over whichever rows it is
    given (the output is whole over *model*)."""
    b, s = embeds.shape[:2]
    if enc_valid is None:
        enc_valid = torch.ones((b, s), dtype=torch.bool, device=embeds.device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=embeds.device)[None].expand(b, s)
    rope = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    x = embeds
    sharded = _sharded(x)
    for i in trips(cfg.num_encoder_layers):
        p = _layer(params, i, "enc_layers", sharded)
        x = _residual(x, _attn_sublayer(
            p["attn"], cfg, _tp_in(rmsnorm(x, p["ln1"], cfg.norm_eps)), i,
            "train", positions, rope, enc_valid, None, None, None,
            causal=False, attn_sharding=attn_sharding, plan=plan))
        x = _residual(x, mlp_apply(
            p["mlp"], _tp_in(rmsnorm(x, p["ln2"], cfg.norm_eps)),
            _mlp_plan(cfg, plan)))
    enc_norm = params["enc_norm"]
    return rmsnorm(x, gather_fsdp(enc_norm) if sharded else enc_norm,
                   cfg.norm_eps)


def build_cross_cache(params: Params, cfg: ModelConfig, enc_out: torch.Tensor,
                      plan=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V ``[L, B, S, KV, D]`` of the encoder
    output ``enc_out [B, S, d]``; on a serving mesh (``plan``) the KV
    heads this rank's query heads read, as its self-attention cache keeps
    them (``HeadLayout``)."""
    p = params["layers"]["cross_attn"]
    layout = None if plan is None else plan.layout(cfg)
    ks, vs = [None] * cfg.num_layers, [None] * cfg.num_layers
    for i in trips(cfg.num_layers, heavy_first=True):
        k = head_proj(enc_out, p["wk"][i])
        v = head_proj(enc_out, p["wv"][i])
        if cfg.qkv_bias:
            k, v = k + p["bk"][i], v + p["bv"][i]
        if layout is not None:
            if layout.real_kv is not None:
                k, v = k[:, :, layout.real_kv], v[:, :, layout.real_kv]
            k, v = _cache_heads(cfg, k, v, layout)
        ks[i], vs[i] = k, v
    return torch.stack(fill_skipped(ks)), torch.stack(fill_skipped(vs))


def _run(fn, remat: bool, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _hybrid_layers(params: Params, cfg: ModelConfig, sharded: bool = False):
    """``(kind, params, index)`` of every layer of a hybrid stack in
    order: ``kind`` "rec" or "attn"; ``index`` the layer's place on the
    cache's recurrent or attention layer axis.  The groups' leaves are
    ``[ngroups, bpa, ...]`` (rec) and ``[ngroups, ...]`` (attn), the
    tail's unstacked.  The groups, all of one shape, go by
    :func:`trips`; ``sharded``: as :func:`_layer`.  A fourth item says
    whether the layer is in a group: train mode's remat covers the
    groups only, as the reference's checkpointed group scan does (its
    unrolled tail runs without)."""
    bpa = cfg.rglru.blocks_per_attention
    ngroups, tail = divmod(cfg.num_layers, bpa + 1)
    lp = params["layers"]
    groups = lp.get("groups")
    gather = gather_fsdp if sharded else (lambda p: p)
    for g in trips(ngroups, heavy_first=True):
        for j in range(bpa):
            yield ("rec", gather(map_params(lambda a: a[g, j], groups["rec"])),
                   g * bpa + j, True)
        yield ("attn", gather(map_params(lambda a: a[g], groups["attn"])), g,
               True)
    for j in range(tail):
        yield "rec", gather(lp["tail"][j]), ngroups * bpa + j, False


def forward(params: Params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            *, cache: Optional[cache_lib.CacheT] = None, mode: str = "train",
            embeds: Optional[torch.Tensor] = None,
            input_mask: Optional[torch.Tensor] = None,
            rope_positions: Optional[torch.Tensor] = None,
            write_mask: Optional[torch.Tensor] = None,
            update_mask: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            enc_valid: Optional[torch.Tensor] = None,
            remat: bool = False, with_aux: bool = False,
            act_sharding=None,
            attn_sharding=None, moe_sharding=None, plan=None):
    """Returns (logits [B, T, Vp] float32, cache), and the MoE blocks'
    aux losses averaged over the layers as a third item with
    ``with_aux`` (the reference's ``aux``; empty for the other
    families).  ``write_mask [B, T]`` (decode, paged pool) drops the KV
    writes of masked positions, so a short-SL sequence never writes
    outside its allocated blocks; a ring ignores it, as in the reference.
    ``update_mask [B, T]`` (recurrent families) makes the masked steps
    identities on the recurrent state; a prefill over right-padded
    prompts sets it from ``input_mask``, as the reference does.  The
    returned cache holds NEW recurrent tensors (``ssd``, ``lru``,
    ``conv``): the one passed in keeps its state.  ``remat`` applies to
    train mode only.

    ``embeds [B, T, d]`` replace the token embeddings (a front-end stub's
    output; ``tokens`` may then be None); ``rope_positions`` ([B, T], or
    [B, T, 3] for M-RoPE) feed RoPE in place of the sequence positions,
    which still place the K/V and mask the attention.  An audio stack
    reads its cross K/V from the cache, or in train mode encodes
    ``encoder_embeds [B, S, d]`` (``enc_valid [B, S]``: the valid frames,
    all by default); train mode without them raises ``AssertionError``,
    as the reference's does.

    The sharding hooks (``launch/sharding.py``; the dry run passes them,
    the single-card paths never do): ``act_sharding`` holds the residual
    stream ``[B, S, d]`` between blocks (sequence parallelism),
    ``attn_sharding`` = (sharding, head-axis size) pins q/k/v heads in
    train and prefill attention, ``moe_sharding`` the MoE dispatch
    buffers.  On DTensors they redistribute; on plain tensors they do
    nothing.  The layer stacks iterate by ``core.cost_hooks.trips``:
    ``range`` outside the dry run's weighting counter.

    ``plan`` (a ``core.tp.MeshPlan``; the serving engine on a mesh):
    ``params`` and ``cache`` are this rank's shards, and the logits come
    back whole on every rank (module docstring).  The masks, ``embeds``
    and ``rope_positions`` are the whole call's."""
    assert mode in ("train", "prefill", "decode")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the {', '.join(FAMILIES)} families, not "
            f"family {cfg.family!r} (ROADMAP A7)")
    assert (cache is None) == (mode == "train"), (
        "train runs without a cache; prefill and decode need one")
    layout = None if plan is None else plan.layout(cfg)
    paged = cache is not None and cache_lib.is_paged(cache)
    ring = cache is not None and "kv_pos" in cache and not paged
    # a ring (or recurrent rows) split over data: this rank runs its own
    # rows; a hybrid pool whose recurrent rows split runs its own rows
    # through the RG-LRU layers alone (``rec_rows``)
    split = None if cache is None else tp_lib.split_rows(cache, plan)
    rows = None if paged else split
    rec_rows = split if paged else None
    # kv_pos is whole on every rank: its writes take every row's validity
    valid = input_mask if mode == "prefill" else None
    if rows is not None:
        tokens, embeds, rope_positions, input_mask, update_mask = (
            None if a is None else a[rows[0]:rows[1]]
            for a in (tokens, embeds, rope_positions, input_mask,
                      update_mask))
    sharded = _sharded(params["embed"])
    if sharded:
        params = dict(params, **gather_fsdp(
            {k: params[k] for k in ("embed", "final_norm", "lm_head",
                                    "enc_norm") if k in params}))
    x = (embeds if embeds is not None
         else _embed(params["embed"], tokens, plan, layout))
    if sharded:
        x = batch_only(x)
    b, t = x.shape[:2]
    ar = torch.arange(t, dtype=torch.int32, device=x.device)[None]
    if mode == "decode":
        positions = cache["length"][:, None] + ar
    else:
        positions = ar.expand(b if rows is None else cache["length"].shape[0],
                              t)
    # the positions of every row (kv_pos is whole), then of this rank's
    pos_all = positions
    if rows is not None:
        positions = positions[rows[0]:rows[1]]
    if (mode == "prefill" and input_mask is not None and update_mask is None
            and has_recurrent_state(cfg)):
        # right-padded ragged prompts: the recurrent state must not
        # advance over the padding (attention masks it by kv validity)
        update_mask = input_mask.float()
    # per-call quantities every layer shares: RoPE angles, write slots
    rope = (None if cfg.attention_free else
            rope_angles(positions if rope_positions is None else rope_positions,
                        cfg.resolved_head_dim, cfg.rope_theta,
                        cfg.mrope_sections))
    slots = None
    attn_cache = cache
    if ring:
        w = cache_lib.cache_window(cache)
        slots = cache_lib.ring_slots(positions, w)
        # kv_pos is whole on every rank; the K/V rows and the attention
        # are this rank's
        cache_lib.write_pos(cache["kv_pos"], pos_all,
                            slots if rows is None
                            else cache_lib.ring_slots(pos_all, w),
                            valid=valid)
        if rows is not None:
            attn_cache = dict(cache, kv_pos=cache["kv_pos"][rows[0]:rows[1]])
    elif cache is not None and "kv_pos" in cache:
        slots = cache_lib.write_slots(
            positions, cache["block_table"], cache["kv_pos"].shape[1],
            cache["kv_pos"].shape[0],
            keep=write_mask if mode == "decode" else None)
        cache_lib.write_pos_paged(cache["kv_pos"], positions, slots,
                                  valid=valid)
    remat = remat and mode == "train"
    new_state = {}
    aux: dict = {}
    # x holds this rank's rows of a hybrid pool's call (``rec_rows``)
    own_rows = False

    def between(x):
        return shard_as(x, act_sharding)
    if cfg.family == "ssm":
        states = [None] * cfg.num_layers
        for i in trips(cfg.num_layers, heavy_first=True):
            st = (None if cache is None else
                  {k: cache[k][i] for k in ("ssd", "conv")})
            x, states[i] = _run(_ssm_block, remat, _layer(params, i, sharded=sharded),
                                cfg, x, st, update_mask, mode, plan)
            x = between(x)
        if cache is not None:
            states = fill_skipped(states)
            new_state = {k: torch.stack([st[k] for st in states])
                         for k in ("ssd", "conv")}
    elif cfg.family == "hybrid":
        states = [None] * cache_lib.hybrid_layer_counts(cfg)[1]
        rec_mask = (update_mask if rec_rows is None or update_mask is None
                    else update_mask[rec_rows[0]:rec_rows[1]])
        for kind, p, idx, grouped in _hybrid_layers(params, cfg, sharded):
            if kind == "attn":
                if own_rows:
                    # the pool is every data rank's: attend on every row
                    x, own_rows = tp_lib.gather_rows(x, plan), False
                x = between(_run(_local_attn_block, remat, p, cfg, x, idx,
                                 mode, positions, rope, input_mask,
                                 attn_cache, slots, attn_sharding, plan))
                continue
            if rec_rows is not None and not own_rows:
                x, own_rows = x[rec_rows[0]:rec_rows[1]], True
            st = (None if cache is None else
                  {k: cache[k][idx] for k in ("lru", "conv")})
            x, states[idx] = _run(_rec_block, remat and grouped, p, cfg, x,
                                  st, rec_mask, mode, plan)
            x = between(x)
        if cache is not None and states:
            states = fill_skipped(states)
            new_state = {k: torch.stack([st[k] for st in states])
                         for k in ("lru", "conv")}
    elif cfg.family == "audio":
        if cache is not None:
            ck, cv, ev = cache["cross_k"], cache["cross_v"], cache["enc_valid"]
            if rows is not None:
                ev = ev[rows[0]:rows[1]]
        else:
            assert encoder_embeds is not None, (
                "audio train mode needs encoder_embeds")
            ev = (enc_valid if enc_valid is not None else
                  torch.ones(encoder_embeds.shape[:2], dtype=torch.bool,
                             device=x.device))
            ck, cv = build_cross_cache(
                params, cfg, encode(params, cfg, encoder_embeds, ev,
                                    attn_sharding=attn_sharding))
        for i in trips(cfg.num_layers, heavy_first=True):
            x = between(_run(_audio_block, remat,
                             _layer(params, i, sharded=sharded), cfg, x,
                             i, mode, positions, rope, input_mask, attn_cache,
                             slots, ck[i], cv[i], ev, attn_sharding, plan))
    else:
        for i in trips(cfg.num_layers, heavy_first=True):
            x, aux_i = _run(_block, remat, _layer(params, i, sharded=sharded),
                            cfg, x, i,
                            mode, positions, rope, input_mask, attn_cache,
                            slots, attn_sharding, moe_sharding, plan, rows)
            x = between(x)
            aux = {k: aux.get(k, 0.0) + a for k, a in aux_i.items()}
    x = _tp_in(rmsnorm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    if layout is not None and layout.vocab:
        logits = tp_lib.gather_vocab(logits, plan)
    if rows is not None or own_rows:
        logits = tp_lib.gather_rows(logits, plan)
    out = (logits, None if cache is None else dict(cache, **new_state))
    if not with_aux:
        return out
    return out + ({k: a / cfg.num_layers for k, a in aux.items()},)


def commit(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           snapshot: cache_lib.CacheT, verified: cache_lib.CacheT,
           n_committed: torch.Tensor, plan=None) -> cache_lib.CacheT:
    """Commit ``n_committed[b]`` of the ``tokens [B, T]`` just verified.

    Attention families (dense, moe, vlm, audio): the ring or pool
    already holds their K/V, so this
    is ``length`` arithmetic (stale speculative slots are overwritten or
    masked, DESIGN.md §4).  Recurrent families: a masked re-advance from
    ``snapshot``, the pre-round cache (the reference's): a second decode
    pass over the T tokens whose ``update_mask`` makes the rejected steps
    identities, so the state holds exactly the accepted prefix.  Its K/V
    writes are kept to the accepted positions (``write_mask``): on a pool
    they land where the verify pass wrote the same bits, the rest on the
    drop block; a ring rewrites slots of the round's own positions.
    ``plan``: as :func:`forward` takes it."""
    new_len = snapshot["length"] + n_committed.to(torch.int32)
    if not has_recurrent_state(cfg):
        return cache_lib.commit_length(verified, new_len)
    t = tokens.shape[1]
    accepted = (torch.arange(t, device=tokens.device)[None]
                < n_committed[:, None])
    _, advanced = forward(params, cfg, tokens, cache=snapshot, mode="decode",
                          update_mask=accepted.float(), write_mask=accepted,
                          plan=plan)
    return cache_lib.commit_length(advanced, new_len)


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """Whether the family keeps per-slot recurrent state that the block
    pool cannot recover (ssm and hybrid): the engine turns prefix caching
    off for such a stack, and ``commit`` re-advances it, as the
    reference does."""
    return cfg.family in ("ssm", "hybrid")
