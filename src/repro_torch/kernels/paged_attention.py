"""Paged decode / verify attention: the CUDA kernel, its plain PyTorch
version, and the dispatcher the model calls.

Replaces the TPU kernel ``paged_ragged_verify_attention``
(``repro/kernels/ragged_attention.py``).  The kernel source is
``csrc/paged_attention.cu``; see its header for the design and bound.

* :func:`paged_ragged_verify_attention_plain` — gather each sequence's
  view out of the pool through its table, then masked softmax
  attention (the reference's ``kernels/ref.py`` oracle, except that a
  row with no valid slot gives 0, as the Pallas kernel and the
  reference model's ``attend`` do).  The CPU tests and the chip check
  compare against it.
* :func:`paged_ragged_verify_attention_cuda` — the kernel's wrapper:
  checks, allocates the output, launches on the current stream, counts
  the launch.
* :func:`paged_ragged_attention` — the dispatcher: the plain version for
  tensors on the CPU, the kernel for CUDA tensors, nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.models.cache import gather_paged_kv, gather_paged_pos
from repro_torch.models.layers import attend

# launches of the CUDA kernel since the last reset (a plain counter: the
# chip check zeroes it before the serving path and reads it after)
LAUNCHES = {"paged_ragged_verify_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_ragged_verify_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                        pool_v: torch.Tensor,
                                        block_table: torch.Tensor,
                                        q_pos: torch.Tensor,
                                        kv_pos: torch.Tensor,
                                        window: Optional[int] = None
                                        ) -> torch.Tensor:
    """q [B,T,H,D]; pool_k/pool_v [N,BS,KV,D]; block_table [B,MAXB]
    (-1 = unallocated); q_pos [B,T]; kv_pos [N,BS] pool-level (-1 =
    empty).  Returns [B,T,H,D] in q's dtype, accumulated in fp32."""
    k, v = gather_paged_kv(pool_k, pool_v, block_table)
    pos = gather_paged_pos(kv_pos, block_table)
    return attend(q, k, v, q_pos=q_pos, kv_pos=pos, kv_valid=pos >= 0,
                  window=window)


def _lib():
    lib = load_library("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, I, P]
        fn.restype = I
    return fn


def paged_ragged_verify_attention_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                                       pool_v: torch.Tensor,
                                       block_table: torch.Tensor,
                                       q_pos: torch.Tensor,
                                       kv_pos: torch.Tensor,
                                       window: Optional[int] = None
                                       ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version).  q and the pools share a dtype (float32 or bfloat16);
    indices are int32; everything is contiguous on one device."""
    b, t, h, d = q.shape
    n, bs, kv, d2 = pool_k.shape
    maxb = block_table.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={pool_k.dtype} v={pool_v.dtype}:"
                        " need one of float32/bfloat16 for all three")
    for name, x in (("block_table", block_table), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if (d2 != d or h % kv or tuple(pool_v.shape) != tuple(pool_k.shape)
            or tuple(block_table.shape) != (b, maxb)
            or tuple(q_pos.shape) != (b, t) or tuple(kv_pos.shape) != (n, bs)
            or bs > 32):
        raise ValueError(
            f"shapes q{tuple(q.shape)} pool{tuple(pool_k.shape)} "
            f"table{tuple(block_table.shape)} q_pos{tuple(q_pos.shape)} "
            f"kv_pos{tuple(kv_pos.shape)} (block size must be <= 32)")
    tensors = (q, pool_k, pool_v, block_table, q_pos, kv_pos)
    if any(x.device != dev for x in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all inputs must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    fn = _lib()
    err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             block_table.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), b, t, h, kv, d, bs, maxb,
             -1 if window is None else int(window), 1.0 / math.sqrt(d),
             _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    LAUNCHES["paged_ragged_verify_attention"] += 1
    return out


def paged_ragged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode/verify attention straight off the block-paged pool: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return paged_ragged_verify_attention_cuda(q, pool_k, pool_v,
                                                  block_table, q_pos, kv_pos,
                                                  window)
    if q.device.type == "cpu":
        return paged_ragged_verify_attention_plain(q, pool_k, pool_v,
                                                   block_table, q_pos, kv_pos,
                                                   window)
    raise ValueError(f"no paged attention for device {q.device}")
