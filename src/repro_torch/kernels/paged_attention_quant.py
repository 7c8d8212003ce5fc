"""Paged decode / verify attention over the int8 KV pool: the CUDA
kernel, its plain PyTorch version, and the dispatcher the model calls.

Replaces the TPU kernel ``paged_ragged_verify_attention_quant``
(``repro/kernels/ragged_attention.py``).  The kernel source is
``csrc/paged_attention_quant.cu`` with its body in
``csrc/paged_verify.cuh`` (shared with the fp pool's kernel); see their
headers for the design and bound.

* :func:`paged_ragged_verify_attention_quant_plain` — gather each
  sequence's int8 view and its scales through the table, dequantize in
  fp32, then masked softmax attention (a row with no valid slot gives
  0, as in the fp version).
* :func:`paged_ragged_verify_attention_quant_cuda` — the kernel's
  wrapper: checks, allocates the output, launches on the current
  stream, counts the launch.
* :func:`paged_ragged_attention_quant` — the dispatcher: the plain
  version for tensors on the CPU, the kernel for CUDA tensors, nothing
  else.
* :func:`paged_ragged_verify_attention_quant_split_plain` — the kernel's
  split-and-merge algorithm in plain PyTorch, for the CPU tests (no main
  path calls it).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention import (launch_query_groups,
                                                 plan_splits, query_groups,
                                                 split_attention_plain,
                                                 split_ranges, split_scratch)
from repro_torch.models.cache import gather_paged_kv_quant, gather_paged_pos
from repro_torch.models.layers import attend

# launches of the CUDA kernel since the last reset
LAUNCHES = {"paged_ragged_verify_attention_quant": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_ragged_verify_attention_quant_plain(
        q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        block_table: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
        window: Optional[int] = None) -> torch.Tensor:
    """q [B,T,H,D] float32/bfloat16; pool_k/pool_v [N,BS,KV,D] int8;
    k_scale/v_scale [N,BS,KV] float32; block_table [B,MAXB] (-1 =
    unallocated); q_pos [B,T]; kv_pos [N,BS] (-1 = empty).  Returns
    [B,T,H,D] in q's dtype, accumulated in fp32."""
    k, v = gather_paged_kv_quant(pool_k, pool_v, k_scale, v_scale,
                                 block_table)
    pos = gather_paged_pos(kv_pos, block_table)
    return attend(q, k, v, q_pos=q_pos, kv_pos=pos, kv_valid=pos >= 0,
                  window=window)


def paged_ragged_verify_attention_quant_split_plain(
        q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        block_table: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
        window: Optional[int] = None, splits: int = 1) -> torch.Tensor:
    """:func:`paged_ragged_verify_attention_quant_plain` computed as the
    kernel does: the table cut into ``splits`` ranges, partials merged in
    split order."""
    views = ((*gather_paged_kv_quant(pool_k, pool_v, k_scale, v_scale,
                                     block_table[:, lo:hi]),
              gather_paged_pos(kv_pos, block_table[:, lo:hi]))
             for lo, hi in split_ranges(block_table.shape[1], splits))
    return split_attention_plain(q, q_pos, views, window)


def _lib():
    fn = load_library("paged_attention_quant").paged_attention_quant
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, I, I, P, P]
        fn.restype = I
    return fn


def paged_ragged_verify_attention_quant_cuda(
        q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        block_table: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
        window: Optional[int] = None, splits: Optional[int] = None
        ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version).  q is float32 or bfloat16, the pools int8, the scales
    float32, indices int32; everything contiguous on one device.
    ``splits`` forces S (tests); by default ``split_plan`` picks it.
    Query rows past one launch's (``query_groups``) go to further
    launches of the same call."""
    b, t, h, d = q.shape
    n, bs, kv, d2 = pool_k.shape
    maxb = block_table.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"int8 paged attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise TypeError(f"pools must be int8, got {pool_k.dtype}/{pool_v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    for name, x in (("block_table", block_table), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if (d2 != d or h % kv or tuple(pool_v.shape) != tuple(pool_k.shape)
            or tuple(k_scale.shape) != (n, bs, kv)
            or tuple(v_scale.shape) != (n, bs, kv)
            or tuple(block_table.shape) != (b, maxb)
            or tuple(q_pos.shape) != (b, t) or tuple(kv_pos.shape) != (n, bs)):
        raise ValueError(
            f"shapes q{tuple(q.shape)} pool{tuple(pool_k.shape)} "
            f"scale{tuple(k_scale.shape)} table{tuple(block_table.shape)} "
            f"q_pos{tuple(q_pos.shape)} kv_pos{tuple(kv_pos.shape)}")
    groups = query_groups(h, kv, t, d)
    plans = [plan_splits(b, hi - lo, h, kv, d, bs, maxb, splits, dev)
             for lo, hi in groups]
    tensors = (q, pool_k, pool_v, k_scale, v_scale, block_table, q_pos, kv_pos)
    if any(x.device != dev for x in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all inputs must be contiguous")
    if b == 0 or t == 0:
        return torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _lib()

    def launch(qg, pg, og, tg, s):
        err = fn(qg.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(),
                 block_table.data_ptr(), pg.data_ptr(), kv_pos.data_ptr(),
                 og.data_ptr(), b, tg, h, kv, d, bs, maxb,
                 -1 if window is None else int(window), 1.0 / math.sqrt(d),
                 _DTYPES[q.dtype], s,
                 split_scratch(b, tg, h, kv, d, s, dev, stream), stream)
        if err != 0:
            raise RuntimeError(
                f"paged_attention_quant launch failed: cudaError {err}")
    out = launch_query_groups(q, q_pos, groups, plans, launch)
    LAUNCHES["paged_ragged_verify_attention_quant"] += 1
    return out


def paged_ragged_attention_quant(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_table: torch.Tensor,
                                 q_pos: torch.Tensor, kv_pos: torch.Tensor,
                                 window: Optional[int] = None) -> torch.Tensor:
    """Decode/verify attention straight off the int8 block pool: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (q, pool_k, pool_v, k_scale, v_scale, block_table, q_pos, kv_pos)
    if q.device.type == "cuda":
        return paged_ragged_verify_attention_quant_cuda(*args, window=window)
    if q.device.type == "cpu":
        return paged_ragged_verify_attention_quant_plain(*args, window=window)
    raise ValueError(f"no int8 paged attention for device {q.device}")
