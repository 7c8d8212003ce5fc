"""Decode / verify attention over the dense per-slot KV ring: the CUDA
kernel, its plain PyTorch version, and the dispatcher the model calls.

Replaces the TPU kernel ``ragged_verify_attention``
(``repro/kernels/ragged_attention.py``).  The kernel source is
``csrc/ragged_attention.cu``; see its header for the design and bound.

* :func:`ragged_verify_attention_plain` — masked softmax attention over
  the ring (the reference's ``kernels/ref.py`` oracle, except that a row
  with no valid slot gives 0, as the Pallas kernel and the reference
  model's ``attend`` do).  The CPU tests and the chip check compare
  against it.
* :func:`ragged_verify_attention_cuda` — the kernel's wrapper: checks,
  allocates the output, launches on the current stream, counts the
  launch.
* :func:`ragged_attention` — the dispatcher: the plain version for
  tensors on the CPU, the kernel for CUDA tensors, nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.models.layers import attend

# launches of the CUDA kernel since the last reset (a plain counter: the
# chip check zeroes it before the serving path and reads it after)
LAUNCHES = {"ragged_verify_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ragged_verify_attention_plain(q: torch.Tensor, k_buf: torch.Tensor,
                                  v_buf: torch.Tensor, q_pos: torch.Tensor,
                                  kv_pos: torch.Tensor,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """q [B,T,H,D]; k_buf/v_buf [B,W,KV,D] (the ring, already holding the
    new tokens' KV); q_pos [B,T]; kv_pos [B,W] (-1 = empty).  Returns
    [B,T,H,D] in q's dtype, accumulated in fp32."""
    return attend(q, k_buf, v_buf, q_pos=q_pos, kv_pos=kv_pos,
                  kv_valid=kv_pos >= 0, window=window)


def _lib():
    lib = load_library("ragged_attention")
    fn = lib.ragged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.c_float, I, P]
        fn.restype = I
    return fn


def ragged_verify_attention_cuda(q: torch.Tensor, k_buf: torch.Tensor,
                                 v_buf: torch.Tensor, q_pos: torch.Tensor,
                                 kv_pos: torch.Tensor,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version).  q and the rings share a dtype (float32 or bfloat16);
    positions are int32; everything is contiguous on one device."""
    b, t, h, d = q.shape
    b2, w, kv, d2 = k_buf.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ragged attention kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES or k_buf.dtype != q.dtype or v_buf.dtype != q.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={k_buf.dtype} v={v_buf.dtype}:"
                        " need one of float32/bfloat16 for all three")
    for name, x in (("q_pos", q_pos), ("kv_pos", kv_pos)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if (b2 != b or d2 != d or h % kv or tuple(v_buf.shape) != tuple(k_buf.shape)
            or tuple(q_pos.shape) != (b, t) or tuple(kv_pos.shape) != (b, w)):
        raise ValueError(
            f"shapes q{tuple(q.shape)} ring{tuple(k_buf.shape)} "
            f"q_pos{tuple(q_pos.shape)} kv_pos{tuple(kv_pos.shape)}")
    tensors = (q, k_buf, v_buf, q_pos, kv_pos)
    if any(x.device != dev for x in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all inputs must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    fn = _lib()
    err = fn(q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
             q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
             b, t, h, kv, d, w, -1 if window is None else int(window),
             1.0 / math.sqrt(d), _DTYPES[q.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_attention launch failed: cudaError {err}")
    LAUNCHES["ragged_verify_attention"] += 1
    return out


def ragged_attention(q: torch.Tensor, k_buf: torch.Tensor,
                     v_buf: torch.Tensor, q_pos: torch.Tensor,
                     kv_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode/verify attention over the dense ring: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return ragged_verify_attention_cuda(q, k_buf, v_buf, q_pos, kv_pos,
                                            window)
    if q.device.type == "cpu":
        return ragged_verify_attention_plain(q, k_buf, v_buf, q_pos, kv_pos,
                                             window)
    raise ValueError(f"no ragged attention for device {q.device}")
