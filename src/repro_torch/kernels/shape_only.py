"""Shape-only forms of the attention kernels, for the dry run
(``launch/dryrun.py``).

A stand-in tensor (a fake tensor of the dry run's ``OpCounter``, or a
DTensor over fake shards) has no memory, so the kernels' wrappers cannot
launch on it.  Each dispatcher sends such a tensor here instead (its one
check on the real path: ``type(q) is not torch.Tensor``).  Here a call
returns an output of the kernel's shape and dtype and records one call
of the kernel with the counter, its FLOPs and bytes by the kernel's own
formula at the FULL extent of its shapes: every slot of the ring, every
block the table can address (a dry run has no positions, and that is
what the reference's lowered program counts).  The plain versions'
gathers are not counted; the kernels make none.

* FLOPs: 4·B·T·H·S·D (the QK^T and PV products over S slots);
* bytes: q read and the output written, the K/V heads the query heads
  read (int8 values plus fp32 scales for B4), the position map, the
  table, q's positions.

On DTensors (the dense ring of a dry run on a mesh, the only cache its
steps build) the call runs on each device's shards.  A ring whose slot
axis is split over a mesh axis (``cache_seq``) is not gathered: q is
gathered over that axis (DTensor issues it), every device attends over
its own slots for all heads, and the partial results merge across the
axis, the split-KV merge of B5 done across devices, recorded as an
all-reduce of the fp32 partials and their two row statistics.  A ring
whose KV heads are split attends with q split the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_hooks import stand_ins_only


def _counter():
    return stand_ins_only("an attention kernel's shape-only branch")


def attention_cost(b: int, t: int, h: int, d: int, slots: int,
                   kv_read: int, q_itemsize: int, kv_itemsize: float,
                   extra_bytes: int) -> tuple:
    """(FLOPs, bytes) of one verify-attention call over ``slots`` slots
    a row, reading ``kv_read`` KV heads of ``kv_itemsize`` bytes an
    element; ``extra_bytes``: positions, tables, scales."""
    flops = 4.0 * b * t * h * slots * d
    nbytes = (2 * b * t * h * d * q_itemsize
              + 2 * b * slots * kv_read * d * kv_itemsize + extra_bytes)
    return flops, float(nbytes)


def _kv_read(h_local: int, h: int, kv_local: int, kv: int) -> int:
    """KV heads one device's ``h_local`` query heads read (GQA groups of
    h / kv query heads share one)."""
    g = max(1, h // kv)
    return min(kv_local, max(1, -(-h_local // g)))


def ring_attention(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   window: Optional[int] = None) -> torch.Tensor:
    """B5 (``ragged_verify_attention``) on stand-ins: q [B,T,H,D], the
    ring [B,W,KV,D], q_pos [B,T], kv_pos [B,W]."""
    counter = _counter()
    if hasattr(q, "device_mesh") or hasattr(k_buf, "device_mesh"):
        return _ring_sharded(counter, q, k_buf, q_pos, kv_pos)
    b, t, h, d = q.shape
    w, kv = k_buf.shape[1], k_buf.shape[2]
    counter.record_kernel("ragged_verify_attention", *attention_cost(
        b, t, h, d, w, kv, q.element_size(), k_buf.element_size(),
        4 * (b * w + b * t)))
    return torch.empty_like(q)


def _ring_sharded(counter, q, k_buf, q_pos, kv_pos) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_buf.device_mesh
    ring_pl = k_buf.placements
    q_pl = q.placements if hasattr(q, "placements") else (Replicate(),) * mesh.ndim
    target, merge_axes = [], []
    for i, p in enumerate(ring_pl):
        if p == Shard(0):
            target.append(Shard(0))               # batch
        elif p == Shard(1):
            target.append(Replicate())            # slots: all heads here
            merge_axes.append(i)
        elif p == Shard(2):
            target.append(Shard(2))               # KV heads: q's follow
        else:
            target.append(q_pl[i] if q_pl[i] == Shard(2) else Replicate())
    q = q.redistribute(mesh, target) if hasattr(q, "redistribute") else \
        DTensor.from_local(q, mesh, (Replicate(),) * mesh.ndim,
                           run_check=False).redistribute(mesh, target)
    pos_pl = [Shard(0) if p == Shard(0) else Replicate() for p in ring_pl]
    if hasattr(q_pos, "redistribute"):
        q_pos = q_pos.redistribute(mesh, pos_pl)
    ql, kl = q.to_local(), k_buf.to_local()
    b, t, hl, d = ql.shape
    w, kvl = kl.shape[1], kl.shape[2]
    kv_read = _kv_read(hl, q.shape[2], kvl, k_buf.shape[2])
    counter.record_kernel("ragged_verify_attention", *attention_cost(
        b, t, hl, d, w, kv_read, ql.element_size(), kl.element_size(),
        4 * (b * w + b * t)))
    out = torch.empty_like(ql)
    for _ in merge_axes:
        # fp32 partial outputs plus each row's running max and sum
        counter.record_collective("all-reduce", 4.0 * b * t * hl * (d + 2))
    return DTensor.from_local(out, mesh, tuple(target), run_check=False,
                              shape=q.shape, stride=q.stride())


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, block_table: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    window: Optional[int] = None, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """B1 (``paged_ragged_verify_attention``), or B4 with the int8
    pool's scales, on stand-ins: q [B,T,H,D], the pool [N,BS,KV,D], the
    table [B,MAXB], kv_pos [N,BS].  The cost reads every block the table
    can address (B x MAXB x BS slots a call)."""
    counter = _counter()
    if any(hasattr(x, "device_mesh") for x in (q, pool_k, block_table)):
        raise NotImplementedError(
            "the dry run costs no block pool on a mesh: the serving "
            "engine's mesh path runs it on local shards (core/tp.py)")
    b, t, h, d = q.shape
    bs, kv = pool_k.shape[1], pool_k.shape[2]
    slots = block_table.shape[1] * bs
    extra = 4 * (b * slots + block_table.numel() + b * t)
    if k_scale is None:
        name, kv_bytes = "paged_ragged_verify_attention", pool_k.element_size()
    else:
        # int8 values plus one fp32 scale a stored vector
        name = "paged_ragged_verify_attention_quant"
        kv_bytes = pool_k.element_size() + 4.0 / d
    counter.record_kernel(name, *attention_cost(
        b, t, h, d, slots, kv, q.element_size(), kv_bytes, extra))
    return torch.empty_like(q)

