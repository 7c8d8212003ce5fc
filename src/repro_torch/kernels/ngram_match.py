"""Prompt-lookup suffix match for the n-gram drafter: the CUDA kernel,
its plain PyTorch version, and the dispatchers the drafter calls.

Replaces the TPU kernel ``ngram_suffix_propose``
(``repro/kernels/ngram_match.py``).  The kernel source is
``csrc/ngram_match.cu``; see its header for the design and bound.  Per
row of ``tokens [B, L]`` with ``ctx_len [B]`` real entries it finds the
most recent earlier occurrence of the trailing ``n``-gram that has at
least one known continuation token, and returns ``(proposed [B, K]
int32 zero-padded, count [B] int32)``.  Integer-exact: the kernel, the
plain version and the reference agree bit for bit.

* :func:`ngram_propose_plain` — a torch copy of the reference's oracle
  ``ngram_propose_ref`` (``repro/kernels/ref.py``), batched.
* :func:`ngram_suffix_propose_cuda` — the kernel's wrapper with the TPU
  kernel's arguments: checks, allocates the outputs, launches on the
  current stream, counts the launch.
* :func:`ngram_propose` — the dispatcher: the plain version for tensors
  on the CPU, the kernel for CUDA tensors, nothing else.
* :func:`ngram_propose_history` (plain version, wrapper and dispatcher
  alike) — what the drafter calls: the same function of a history
  buffer with the pending token at its committed length, which the
  kernel reads in place (the buffer is never written).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library

# launches of the CUDA kernel since the last reset
LAUNCHES = {"ngram_suffix_propose": 0}


def _empty(b: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((b, 0), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device))


def ngram_propose_plain(tokens: torch.Tensor, ctx_len: torch.Tensor, *,
                        n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, L] int32; ctx_len [B] int32.  The suffix
    ``tokens[c-n : c]``'s most recent match at a start ``i`` with ``i +
    n <= c - 1`` (and ``c >= n + 1``); up to ``k`` following tokens,
    clipped at ``c``."""
    assert n >= 1, "suffix length must be >= 1"
    b, l = tokens.shape
    dev = tokens.device
    if k == 0:
        return _empty(b, dev)
    tok = tokens.to(torch.int32)
    c = ctx_len.to(torch.int32)[:, None]                        # [B, 1]
    idx = torch.arange(l, dtype=torch.int32, device=dev)[None]  # [1, L]
    match = torch.ones((b, l), dtype=torch.bool, device=dev)
    for j in range(n):
        # suffix value s_j = row[c - n + j] (0 outside the row)
        sj = torch.where(idx == c - n + j, tok, 0).sum(1, keepdim=True)
        # row[i + j] as a static shift padded with -1 (never a token id);
        # a suffix longer than the row reads -1 throughout
        shifted = (torch.cat([tok[:, j:], torch.full((b, min(j, l)), -1,
                                                     dtype=torch.int32,
                                                     device=dev)], 1)
                   if j else tok)
        match = match & (shifted == sj)
    match = match & (idx + n <= c - 1) & (c >= n + 1)
    best = torch.where(match, idx, -1).amax(1, keepdim=True)     # [B, 1]
    cnt = torch.where(best >= 0, torch.clamp(c - (best + n), max=k), 0)
    pos = best + n + torch.arange(k, dtype=torch.int32, device=dev)[None]
    picked = torch.gather(tok, 1, pos.clamp(0, l - 1).long())
    picked = torch.where((pos >= 0) & (pos < l), picked, 0)
    keep = torch.arange(k, device=dev)[None] < cnt
    return (torch.where(keep, picked, 0).to(torch.int32),
            cnt[:, 0].to(torch.int32))


def ngram_propose_history_plain(buf: torch.Tensor, length: torch.Tensor,
                                pending: torch.Tensor, *, n: int, k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """buf [B, L] int32 history; length [B] int32 committed tokens;
    pending [B] int32, the token at ``length``.  :func:`ngram_propose_plain`
    of the buffer with ``pending`` written at ``length`` (no write where
    ``length`` is outside [0, L)) and ``ctx = min(length + 1, L)``: the
    reference drafter's ``buf.at[bi, ln].set(pending, mode="drop")`` and
    ``min(ln + 1, h)``."""
    col = torch.arange(buf.shape[1], device=buf.device)[None]
    work = torch.where(col == length[:, None], pending[:, None].to(torch.int32),
                       buf.to(torch.int32))
    ctx = torch.clamp(length + 1, max=buf.shape[1]).to(torch.int32)
    return ngram_propose_plain(work, ctx, n=n, k=k)


MAX_N = 16               # suffix values the kernel holds in registers


def _lib(name: str):
    fn = getattr(load_library("ngram_match"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        extra = [P] if name == "ngram_match_history" else []
        fn.argtypes = [P, P, *extra, P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def _launch(name: str, tokens: torch.Tensor, rows, *, n: int, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks the kernel's inputs (``tokens [B, L]`` and the int32 ``rows``
    of one value a row), allocates the outputs and launches ``name``."""
    b, l = tokens.shape
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError(f"n-gram kernel needs CUDA tensors, got {dev}")
    if tokens.dtype != torch.int32 or any(x.dtype != torch.int32 for x in rows):
        raise TypeError(f"n-gram kernel inputs must be int32, got "
                        f"{[tokens.dtype] + [x.dtype for x in rows]}")
    if (any(tuple(x.shape) != (b,) for x in rows) or not 1 <= n <= MAX_N
            or k < 0):
        raise ValueError(f"shapes tokens{tuple(tokens.shape)} "
                         f"{[tuple(x.shape) for x in rows]}, n={n} "
                         f"(1..{MAX_N}), k={k}")
    if any(x.device != dev for x in rows):
        raise ValueError("all inputs must be on one device")
    if not (tokens.is_contiguous() and all(x.is_contiguous() for x in rows)):
        raise ValueError("all inputs must be contiguous")
    if k == 0:
        return _empty(b, dev)
    out = torch.empty((b, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out, cnt
    if l == 0:
        raise ValueError("tokens need at least one column")
    err = _lib(name)(tokens.data_ptr(), *(x.data_ptr() for x in rows),
                     out.data_ptr(), cnt.data_ptr(), b, l, n, k,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES["ngram_suffix_propose"] += 1
    return out, cnt


def ngram_suffix_propose_cuda(tokens: torch.Tensor, ctx_len: torch.Tensor, *,
                              n: int, k: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version): contiguous int32 tokens [B, L] and ctx_len [B] on one
    device, 1 <= n <= 16.  ``k == 0`` returns empty tensors without a
    launch."""
    return _launch("ngram_match", tokens, (ctx_len,), n=n, k=k)


def ngram_propose_history_cuda(buf: torch.Tensor, length: torch.Tensor,
                               pending: torch.Tensor, *, n: int, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's drafter entry on CUDA tensors (same arguments as
    :func:`ngram_propose_history_plain`): contiguous int32 buf [B, L],
    length [B] and pending [B] on one device; ``buf`` is read only."""
    return _launch("ngram_match_history", buf, (length, pending), n=n, k=k)


def ngram_propose(tokens: torch.Tensor, ctx_len: torch.Tensor, *, n: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most recent earlier occurrence of each row's trailing n-gram and
    its k-token continuation: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if tokens.device.type == "cuda":
        return ngram_suffix_propose_cuda(tokens, ctx_len, n=n, k=k)
    if tokens.device.type == "cpu":
        return ngram_propose_plain(tokens, ctx_len, n=n, k=k)
    raise ValueError(f"no n-gram match for device {tokens.device}")


def ngram_propose_history(buf: torch.Tensor, length: torch.Tensor,
                          pending: torch.Tensor, *, n: int, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ngram_propose` of the history buffer with the pending token
    at ``length`` and ``ctx = min(length + 1, L)``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if buf.device.type == "cuda":
        return ngram_propose_history_cuda(buf, length, pending, n=n, k=k)
    if buf.device.type == "cpu":
        return ngram_propose_history_plain(buf, length, pending, n=n, k=k)
    raise ValueError(f"no n-gram match for device {buf.device}")
