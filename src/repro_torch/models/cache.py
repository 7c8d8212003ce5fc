"""The block-paged KV cache of the port (the paged plane of
``repro.models.cache``).

A cache is a dict of tensors:

* ``k``/``v`` — pools ``[L, n_blocks + 1, block_size, KV, D]`` shared by
  every sequence (the extra block is the drop target, below);
* ``kv_pos [n_blocks + 1, block_size]`` int32 — absolute position stored in
  each pool slot (-1 = empty); a slot is valid for a query at position
  ``q`` iff ``0 <= kv_pos <= q``;
* ``block_table [B, max_blocks]`` int32 — logical -> physical block per
  sequence (-1 = unallocated); position ``p`` of sequence ``b`` lives at
  slot ``block_table[b, p // bs] * bs + p % bs``;
* ``length [B]`` int32 — committed tokens per sequence.

Where the reference is functional (``.at[].set`` returns a new pool),
the port writes the pools and ``kv_pos`` IN PLACE: every caller drops
the old pool the moment a write returns, and rollback never needs the
pre-write values — stale speculative slots are overwritten by the next
write at the same position or masked by ``kv_pos > q`` (the reference's
overwrite-or-mask argument, DESIGN.md §4).  ``length`` is never bumped
in place: it is replaced by a new tensor, because a round keeps the
pre-round cache dict as its commit snapshot.

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


def supports_paged(cfg: ModelConfig) -> bool:
    """The port's paged plane carries the dense family."""
    return cfg.family == "dense"


def max_blocks_per_seq(max_len: int, block_size: int) -> int:
    return -(-max_len // block_size)


def kv_block_bytes(cfg: ModelConfig, block_size: int,
                   dtype=torch.float32) -> int:
    """Device bytes one pool block costs across all layers (K + V)."""
    elems = cfg.num_layers * block_size * cfg.num_kv_heads * cfg.resolved_head_dim
    return 2 * elems * torch.tensor([], dtype=dtype).element_size()


def paged_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                       num_blocks: int, block_size: int,
                       dtype=torch.float32, device="cpu") -> CacheT:
    """Fresh paged cache: zero pools of ``num_blocks`` blocks plus the
    drop block, every slot empty, every table entry unallocated, every
    length 0."""
    if not supports_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged KV layout")
    maxb = max_blocks_per_seq(max_len, block_size)
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {"length": torch.zeros((batch,), **i32),
            "kv_pos": torch.full((num_blocks + 1, block_size), -1, **i32),
            "block_table": torch.full((batch, maxb), -1, **i32),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_prefill_view(pool_k: torch.Tensor, pool_v: torch.Tensor,
                       kv_pos: torch.Tensor,
                       table_rows: torch.Tensor) -> CacheT:
    """Batch-R cache view over the shared pools for prefilling a group
    of requests straight into their allocated blocks: the pool leaves
    ARE the live pools (writes land in place), ``length`` is fresh."""
    rows = table_rows.shape[0]
    return {"length": torch.zeros((rows,), dtype=torch.int32,
                                  device=pool_k.device),
            "k": pool_k, "v": pool_v, "kv_pos": kv_pos,
            "block_table": table_rows}


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
    owner."""
    ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                          device=kv_pos.device)
    kv_pos[ids] = -1


def commit_length(cache: CacheT, new_length: torch.Tensor) -> CacheT:
    out = dict(cache)
    out["length"] = new_length.to(torch.int32)
    return out
