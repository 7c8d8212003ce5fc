"""The KV caches of the port (``repro.models.cache``): the dense ring
and the block-paged pool.

A **dense ring** cache (``paged_kv=False``, the reference's default) is a
dict of tensors:

* ``k``/``v`` — rings ``[L, B, W, KV, D]``, one W-wide row per batch
  slot; position ``p`` of row ``b`` lives at slot ``p % W``.  W is
  ``max_len``, or ``window + RING_SLACK`` for a windowed model, so a
  windowed ring wraps;
* ``kv_pos [B, W]`` int32 — absolute position stored in each slot (-1 =
  empty), with the validity rule below;
* ``length [B]`` int32 — committed tokens per sequence.

A **block-paged** cache is a dict of tensors:

* ``k``/``v`` — pools ``[L, n_blocks + 1, block_size, KV, D]`` shared by
  every sequence (the extra block is the drop target, below);
* ``kv_pos [n_blocks + 1, block_size]`` int32 — absolute position stored in
  each pool slot (-1 = empty); a slot is valid for a query at position
  ``q`` iff ``0 <= kv_pos <= q``;
* ``block_table [B, max_blocks]`` int32 — logical -> physical block per
  sequence (-1 = unallocated); position ``p`` of sequence ``b`` lives at
  slot ``block_table[b, p // bs] * bs + p % bs``;
* ``length [B]`` int32 — committed tokens per sequence;
* ``k_scale``/``v_scale [L, n_blocks + 1, block_size, KV]`` fp32 — only
  in an int8 pool (``kv_quant="int8"``): ``k``/``v`` are then int8 and
  each stored vector has its own amax scale (``x ≈ int8 * scale``).

Where the reference is functional (``.at[].set`` returns a new pool),
the port writes the rings, the pools and ``kv_pos`` IN PLACE: every
caller drops the old buffers the moment a write returns, and rollback
never needs the pre-write values — stale speculative slots are
overwritten by the next write at the same position or masked by
``kv_pos > q`` (the reference's overwrite-or-mask argument, DESIGN.md
§4).  ``length`` is never bumped in place: it is replaced by a new
tensor, because a round keeps the pre-round cache dict as its commit
snapshot.

The pools and ``kv_pos`` hold ONE block more than the allocator hands
out: block ``num_blocks`` is the drop target.  The reference drops a
write by scattering it to the out-of-range flat slot ``num_blocks * bs``
(``mode="drop"``); the port sends it to that same slot, which exists
and is never referenced by a block table.  Selecting the kept writes
with a boolean mask instead would make the host wait for the device at
every layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig

CacheT = Dict[str, Any]


# ---------------------------------------------------------------------------
# dense ring (paged_kv=False)
# ---------------------------------------------------------------------------

# ring slots beyond the attention window: a T-token decode/verify call
# writes T entries before its first query reads, so without slack it
# would overwrite the oldest keys still in the window (SL_max + 1 = 11)
RING_SLACK = 16


def _kv_window(cfg: ModelConfig, max_len: int) -> int:
    if cfg.attention_window is not None:
        return min(max_len, cfg.attention_window + RING_SLACK)
    return max_len


def kv_buf_shape(cfg: ModelConfig, batch: int, window: int,
                 layers: int) -> Tuple[int, ...]:
    return (layers, batch, window, cfg.num_kv_heads, cfg.resolved_head_dim)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.float32, device="cpu") -> CacheT:
    """Fresh dense-ring cache: zero rings, every slot empty, every length
    0 (the dense family's leaves of the reference's ``cache_struct``)."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} has no dense ring in the port")
    w = _kv_window(cfg, max_len)
    shape = kv_buf_shape(cfg, batch, w, cfg.num_layers)
    return {"length": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full((batch, w), -1, dtype=torch.int32,
                                 device=device)}


def cache_window(cache: CacheT) -> int:
    return cache["kv_pos"].shape[-1]


def is_paged(cache: CacheT) -> bool:
    return "block_table" in cache


def _last_columns(x: torch.Tensor, window: int) -> torch.Tensor:
    return x[:, -window:] if x.shape[1] >= window else x


def ring_slots(positions: torch.Tensor, window: int) -> torch.Tensor:
    """Flat ring slot ``b * W + p % W`` [B*T'] int64 of each [B,T]
    position, shared by one model call's K/V and kv_pos writes.  When
    ``T >= W`` only the last W columns are written (T' = W), as the
    reference's ``write_kv`` keeps the last W tokens of a long prefill;
    the kept columns then fall on distinct slots."""
    positions = _last_columns(positions, window)
    rows = torch.arange(positions.shape[0], device=positions.device)[:, None]
    return (rows * window + positions.long() % window).reshape(-1)


def write_kv(k_buf: torch.Tensor, v_buf: torch.Tensor, k_new: torch.Tensor,
             v_new: torch.Tensor, slots: torch.Tensor) -> None:
    """Scatter [B,T,KV,D] new KV into one layer's rings ``[B, W, KV, D]``
    at :func:`ring_slots`, in place (``T >= W``: the last W tokens).  No
    write mask: a write past a row's horizon lands in the ring and is
    masked later by ``kv_pos <= q_pos``, as in the reference."""
    b, w = k_buf.shape[:2]
    for buf, new in ((k_buf, k_new), (v_buf, v_new)):
        new = _last_columns(new, w)
        buf.view((b * w,) + buf.shape[2:]).index_copy_(
            0, slots, new.reshape((-1,) + new.shape[2:]).to(buf.dtype))


def write_pos(kv_pos: torch.Tensor, positions: torch.Tensor,
              slots: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> None:
    """Update the ring's slot-position map ``[B, W]`` in place (once per
    model call) at :func:`ring_slots`; ``valid`` marks entries written
    as -1 (ragged prefill padding)."""
    w = kv_pos.shape[1]
    newpos = positions if valid is None else torch.where(valid, positions, -1)
    kv_pos.view(-1).index_copy_(0, slots,
                                _last_columns(newpos, w).reshape(-1)
                                .to(kv_pos.dtype))


# ---------------------------------------------------------------------------
# block-paged pool (paged_kv=True)
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """The port's paged plane carries the dense family."""
    return cfg.family == "dense"


def max_blocks_per_seq(max_len: int, block_size: int) -> int:
    return -(-max_len // block_size)


# ---------------------------------------------------------------------------
# int8 storage (kv_quant="int8"; the reference's DESIGN.md §13)
# ---------------------------------------------------------------------------

KV_QUANT_MODES = ("none", "int8")
INT8_QMAX = 127.0


def is_quantized(cache: CacheT) -> bool:
    return "k_scale" in cache


def supports_kv_quant(cfg: ModelConfig) -> bool:
    """The families whose paged cache is a pure attention pool (the
    reference's list; the port carries the dense one so far)."""
    return cfg.family in ("dense", "moe", "vlm")


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KV, D] -> (int8 values, fp32 per-[..., KV] amax scales).
    Every step in fp32 with round-half-even (``torch.round``, like
    ``jnp.round``), so the values and scales are bit-identical to the
    reference's; a zero vector maps to scale 1.0."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.where(amax > 0, amax / INT8_QMAX, 1.0)
    q = torch.round(xf / scale[..., None]).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: int8 [..., KV, D] and scales
    [..., KV] -> fp32, one ``int8 * scale`` product per element."""
    return q.float() * scale[..., None]


def fake_quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """``dequantize(quantize(x))`` at x's dtype: what prefill attention
    reads, so prefill and later reads of the stored pool see the same
    values."""
    q, s = quantize_kv(x)
    return dequantize_kv(q, s).to(x.dtype)


def kv_block_bytes(cfg: ModelConfig, block_size: int, kv_quant: str,
                   dtype=torch.float32) -> int:
    """Device bytes one pool block costs across all layers (K + V, plus
    the scales of an int8 pool)."""
    elems = cfg.num_layers * block_size * cfg.num_kv_heads * cfg.resolved_head_dim
    if kv_quant == "int8":
        scales = cfg.num_layers * block_size * cfg.num_kv_heads
        return 2 * (elems * 1 + scales * 4)
    if kv_quant == "none":
        return 2 * elems * torch.tensor([], dtype=dtype).element_size()
    raise ValueError(f"unknown kv_quant mode {kv_quant!r}")


def equal_byte_blocks(cfg: ModelConfig, fp_blocks: int, block_size: int,
                      fp_dtype=torch.float32) -> int:
    """How many int8 blocks the bytes of ``fp_blocks`` fp blocks buy."""
    fp = kv_block_bytes(cfg, block_size, "none", dtype=fp_dtype)
    q8 = kv_block_bytes(cfg, block_size, "int8")
    return fp_blocks * fp // q8


def paged_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                       num_blocks: int, block_size: int,
                       dtype=torch.float32, device="cpu",
                       kv_quant: str = "none") -> CacheT:
    """Fresh paged cache: zero pools of ``num_blocks`` blocks plus the
    drop block, every slot empty, every table entry unallocated, every
    length 0.  ``kv_quant="int8"`` stores the pools as int8 and adds the
    fp32 scale pools, drop block included."""
    if not supports_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged KV layout")
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
    if kv_quant != "none" and not supports_kv_quant(cfg):
        raise ValueError(f"family {cfg.family!r} has no quantized KV layout")
    maxb = max_blocks_per_seq(max_len, block_size)
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    pool_dtype = torch.int8 if kv_quant == "int8" else dtype
    cache = {"length": torch.zeros((batch,), **i32),
             "kv_pos": torch.full((num_blocks + 1, block_size), -1, **i32),
             "block_table": torch.full((batch, maxb), -1, **i32),
             "k": torch.zeros(shape, dtype=pool_dtype, device=device),
             "v": torch.zeros(shape, dtype=pool_dtype, device=device)}
    if kv_quant == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def paged_prefill_view(pool_k: torch.Tensor, pool_v: torch.Tensor,
                       kv_pos: torch.Tensor, table_rows: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None) -> CacheT:
    """Batch-R cache view over the shared pools for prefilling a group
    of requests straight into their allocated blocks: the pool leaves
    (and the scale pools of an int8 pool) ARE the live pools (writes
    land in place), ``length`` is fresh."""
    rows = table_rows.shape[0]
    view = {"length": torch.zeros((rows,), dtype=torch.int32,
                                  device=pool_k.device),
            "k": pool_k, "v": pool_v, "kv_pos": kv_pos,
            "block_table": table_rows}
    if k_scale is not None:
        view["k_scale"], view["v_scale"] = k_scale, v_scale
    return view


def write_slots(positions: torch.Tensor, block_table: torch.Tensor,
                block_size: int, n_blocks: int,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat pool slot [B*T] int64 of each [B,T] position through the
    table, shared by one model call's K/V and kv_pos writes.
    Out-of-range, unallocated, or ``~keep`` entries map to the first slot
    of the drop block ``n_blocks`` (the last pool block)."""
    maxb = block_table.shape[1]
    pos = positions.long()
    blk = pos // block_size
    phys = torch.gather(block_table.long(), 1, blk.clamp(0, maxb - 1))
    ok = (pos >= 0) & (blk < maxb) & (phys >= 0)
    if keep is not None:
        ok = ok & keep
    return torch.where(ok, phys * block_size + pos % block_size,
                       (n_blocks - 1) * block_size).reshape(-1)


def write_kv_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   slots: torch.Tensor) -> None:
    """Scatter [B,T,KV,D] new KV into one layer's pools ``[N + 1, bs,
    KV, D]`` at :func:`write_slots`, in place."""
    n, bs = pool_k.shape[:2]
    fk = pool_k.view((n * bs,) + pool_k.shape[2:])
    fv = pool_v.view((n * bs,) + pool_v.shape[2:])
    fk.index_copy_(0, slots, k_new.reshape((-1,) + k_new.shape[2:]).to(pool_k.dtype))
    fv.index_copy_(0, slots, v_new.reshape((-1,) + v_new.shape[2:]).to(pool_v.dtype))


def write_kv_paged_quant(pool_k: torch.Tensor, pool_v: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         slots: torch.Tensor) -> None:
    """Quantize-on-write into one layer's int8 pools ``[N + 1, bs, KV,
    D]`` and scale pools ``[N + 1, bs, KV]``, in place.  Values and
    scales go to the same :func:`write_slots`, so a dropped value write
    drops its scale too."""
    n, bs = pool_k.shape[:2]
    # K and V quantized in one pass (fewer launches; every vector is
    # quantized on its own, so the values are the same)
    q, s = quantize_kv(torch.stack((k_new, v_new)))
    for i, (pool, scales) in enumerate(((pool_k, k_scale), (pool_v, v_scale))):
        pool.view((n * bs,) + pool.shape[2:]).index_copy_(
            0, slots, q[i].reshape((-1,) + q.shape[3:]))
        scales.view((n * bs,) + scales.shape[2:]).index_copy_(
            0, slots, s[i].reshape((-1,) + s.shape[3:]))


def write_pos_paged(kv_pos: torch.Tensor, positions: torch.Tensor,
                    slots: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> None:
    """Update the pool-level slot-position map in place (once per model
    call) at :func:`write_slots`.  ``valid`` marks entries written as -1
    (ragged prefill padding)."""
    newpos = positions if valid is None else torch.where(valid, positions, -1)
    kv_pos.view(-1).index_copy_(0, slots, newpos.reshape(-1).to(kv_pos.dtype))


def gather_paged_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    block_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence dense views [B, max_blocks*bs, KV, D] of the pool
    (unallocated entries gather block 0; :func:`gather_paged_pos` masks
    them)."""
    idx = block_table.clamp(min=0).long()
    b, maxb = block_table.shape
    bs = pool_k.shape[1]
    return (pool_k[idx].reshape((b, maxb * bs) + pool_k.shape[2:]),
            pool_v[idx].reshape((b, maxb * bs) + pool_v.shape[2:]))


def gather_paged_kv_quant(pool_k: torch.Tensor, pool_v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          block_table: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized fp32 per-sequence views [B, max_blocks*bs, KV, D] of
    an int8 pool (the plain attention version's input; the kernel
    dequantizes tile by tile instead)."""
    idx = block_table.clamp(min=0).long()
    b, maxb = block_table.shape
    bs = pool_k.shape[1]
    k = dequantize_kv(pool_k[idx], k_scale[idx])
    v = dequantize_kv(pool_v[idx], v_scale[idx])
    return (k.reshape((b, maxb * bs) + k.shape[3:]),
            v.reshape((b, maxb * bs) + v.shape[3:]))


def gather_paged_pos(kv_pos: torch.Tensor,
                     block_table: torch.Tensor) -> torch.Tensor:
    """Per-sequence [B, max_blocks*bs] view of the pool-level kv_pos;
    unallocated table entries read as -1."""
    g = kv_pos[block_table.clamp(min=0).long()]               # [B,MAXB,bs]
    g = torch.where((block_table >= 0)[:, :, None], g, -1)
    return g.reshape(block_table.shape[0], -1)


def reset_blocks(kv_pos: torch.Tensor, block_ids) -> None:
    """Mark freshly (re)allocated blocks empty, in place.  Mandatory on
    allocation: a block recycled from another sequence still holds
    kv_pos values that could satisfy ``0 <= kv_pos <= q`` for its new
    owner.  ``block_ids``: ids, or an int64 tensor of them on kv_pos's
    device."""
    if not isinstance(block_ids, torch.Tensor):
        block_ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                                    device=kv_pos.device)
    kv_pos[block_ids] = -1


def commit_length(cache: CacheT, new_length: torch.Tensor) -> CacheT:
    out = dict(cache)
    out["length"] = new_length.to(torch.int32)
    return out
