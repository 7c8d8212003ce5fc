"""Decode / verify attention over the dense per-slot KV ring: the CUDA
kernel, its plain PyTorch version, and the dispatcher the model calls.

Replaces the TPU kernel ``ragged_verify_attention``
(``repro/kernels/ragged_attention.py``).  The kernel source is
``csrc/ragged_attention.cu`` with its body in ``csrc/paged_verify.cuh``
(shared with the block pools' kernels); see their headers for the
design and bound.

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
* :func:`ring_split_ranges` — the kernel's split of a row's W slots:
  its ceil(W / 16) chunks cut by ``paged_attention.split_ranges``, S from
  ``paged_attention.split_plan`` over the chunks (shapes and SM count
  alone, so a launch makes no host sync).
* :func:`ragged_verify_attention_split_plain` — the kernel's algorithm in
  plain PyTorch (live-chunk skip, split, merge in split order), for the
  CPU tests (no main path calls it).
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
from repro_torch.models.layers import attend

# launches of the CUDA kernel since the last reset (a plain counter: the
# chip check zeroes it before the serving path and reads it after)
LAUNCHES = {"ragged_verify_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

CHUNK_SLOTS = 16         # ring slots a unit of the kernel (a warp's share)


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


def ring_chunks(w: int) -> int:
    """The kernel's units of a W-slot ring: ceil(W / 16) chunks."""
    return -(-w // CHUNK_SLOTS)


def ring_split_ranges(w: int, splits: int):
    """The ring slots [begin, end) of each split, as the kernel takes
    them: ``split_ranges`` over the row's chunks, the last chunk cut at
    W."""
    return [(min(lo * CHUNK_SLOTS, w), min(hi * CHUNK_SLOTS, w))
            for lo, hi in split_ranges(ring_chunks(w), splits)]


def live_slots(q_pos: torch.Tensor, kv_pos: torch.Tensor,
               window: Optional[int] = None) -> torch.Tensor:
    """[B,W] bool: the slots of the chunks that hold a slot valid for some
    query of the call, i.e. 0 <= kv_pos <= max q_pos and, with a window,
    kv_pos > min q_pos - window (the kernel stages only these)."""
    b, w = kv_pos.shape
    valid = (kv_pos >= 0) & (kv_pos <= q_pos.amax(1, keepdim=True))
    if window is not None:
        valid = valid & (kv_pos > q_pos.amin(1, keepdim=True) - window)
    pad = ring_chunks(w) * CHUNK_SLOTS - w
    live = torch.nn.functional.pad(valid, (0, pad)).reshape(
        b, -1, CHUNK_SLOTS).any(-1)
    return live.repeat_interleave(CHUNK_SLOTS, 1)[:, :w]


def ragged_verify_attention_split_plain(q: torch.Tensor, k_buf: torch.Tensor,
                                        v_buf: torch.Tensor,
                                        q_pos: torch.Tensor,
                                        kv_pos: torch.Tensor,
                                        window: Optional[int] = None,
                                        splits: int = 1) -> torch.Tensor:
    """:func:`ragged_verify_attention_plain` computed as the kernel does:
    the chunks without a live slot (:func:`live_slots`) never read (empty
    position, zero K/V), the ring cut into ``splits`` ranges
    (:func:`ring_split_ranges`), partials merged in split order
    (``split_attention_plain``)."""
    live = live_slots(q_pos, kv_pos, window)
    pos = torch.where(live, kv_pos, -1)
    keep = live[:, :, None, None]
    k = torch.where(keep, k_buf, torch.zeros((), dtype=k_buf.dtype))
    v = torch.where(keep, v_buf, torch.zeros((), dtype=v_buf.dtype))
    views = ((k[:, lo:hi], v[:, lo:hi], pos[:, lo:hi])
             for lo, hi in ring_split_ranges(k_buf.shape[1], splits))
    return split_attention_plain(q, q_pos, views, window)


def _lib():
    lib = load_library("ragged_attention")
    fn = lib.ragged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.c_float, I, I, P, P]
        fn.restype = I
    return fn


def ragged_verify_attention_cuda(q: torch.Tensor, k_buf: torch.Tensor,
                                 v_buf: torch.Tensor, q_pos: torch.Tensor,
                                 kv_pos: torch.Tensor,
                                 window: Optional[int] = None,
                                 splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version).  q and the rings share a dtype (float32 or bfloat16);
    positions are int32; everything is contiguous on one device.
    ``splits`` forces S (tests); by default ``split_plan`` picks it over
    the ring's 16-slot chunks.  Query rows past one launch's (see
    ``query_groups``) go to further launches of the same call."""
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
    groups = query_groups(h, kv, t, d)
    plans = [plan_splits(b, hi - lo, h, kv, d, CHUNK_SLOTS, ring_chunks(w),
                         splits, dev) for lo, hi in groups]
    tensors = (q, k_buf, v_buf, q_pos, kv_pos)
    if any(x.device != dev for x in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all inputs must be contiguous")
    if b == 0 or t == 0:
        return torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _lib()

    def launch(qg, pg, og, tg, s):
        err = fn(qg.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(),
                 pg.data_ptr(), kv_pos.data_ptr(), og.data_ptr(),
                 b, tg, h, kv, d, w, -1 if window is None else int(window),
                 1.0 / math.sqrt(d), _DTYPES[q.dtype], s,
                 split_scratch(b, tg, h, kv, d, s, dev, stream), stream)
        if err != 0:
            raise RuntimeError(f"ragged_attention launch failed: cudaError {err}")
    out = launch_query_groups(q, q_pos, groups, plans, launch)
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
