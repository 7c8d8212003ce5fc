"""Fused KLD / acceptance signals: the CUDA kernel, its plain PyTorch
version, and the dispatcher the round calls.

Replaces the TPU kernel ``fused_kld_accept`` (``repro/kernels/
kld_accept.py``).  The kernel source is ``csrc/kld_accept.cu``; see its
header for the design and bound.  Per [B, T] row of target / draft
logits and proposed tokens it returns ``(KL(p || q) floored at 0,
H(q), p(tok), q(tok))``; a token outside [0, V) has probability 0.

* :func:`kld_accept_plain` — log_softmax sums, the yardstick.
* :func:`fused_kld_accept_cuda` — the kernel's wrapper: checks,
  allocates the outputs, launches on the current stream, counts the
  launch.
* :func:`kld_accept_signals` — the dispatcher: the plain version for
  tensors on the CPU, the kernel for CUDA tensors, nothing else.
* :func:`kld_chunks` / :func:`kld_split_ranges` — the kernel's cut of each
  row into C chunks (one thread block each, one cluster a row), C from
  the shapes and the card's SM count alone.
* :func:`kld_accept_split_plain` — the kernel's chunked algorithm in
  plain PyTorch (online-logsumexp states per chunk, merged in chunk
  order), for the CPU tests (no main path calls it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.paged_attention import NEG_INF, SMS, sm_count

LAUNCHES = {"fused_kld_accept": 0}

Signals = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_CHUNKS = 8           # blocks a row: the portable thread-block cluster
MIN_CHUNK = 1024         # logits a chunk at least


@functools.lru_cache(maxsize=256)
def kld_chunks(rows: int, v: int, sms: int = SMS) -> int:
    """C, the blocks of each row in the kernel's grid, from the shapes and
    the card's SM count ``sms`` alone: about three blocks per SM over the
    rows (enough 16-byte loads in flight to stream at the card's rate),
    at most ``MAX_CHUNKS`` (one cluster a row) and at most one a
    ``MIN_CHUNK`` logits."""
    want = -(-3 * sms // max(1, rows))
    return max(1, min(MAX_CHUNKS, want, v // MIN_CHUNK))


def row_units(x_ptr: int, y_ptr: int, v: int) -> Tuple[int, int]:
    """(head, width) of a row whose target / draft logits start at byte
    addresses ``x_ptr`` / ``y_ptr``, as the kernel reads it: where both
    sit alike modulo 16 bytes, the ``head`` scalars before the first
    16-byte boundary, then float4 units (width 4); else float units
    (head 0, width 1)."""
    px, py = (x_ptr >> 2) & 3, (y_ptr >> 2) & 3
    if px != py:
        return 0, 1
    return min((4 - px) & 3, v), 4


def kld_split_ranges(v: int, chunks: int, head: int = 0, width: int = 4):
    """The logits [begin, end) of each chunk of a row, as the kernel takes
    them: its n units cut into ``chunks`` ranges of ceil(n / chunks), the
    head in chunk 0 and the tail (the scalars after the last whole unit)
    in the last chunk."""
    n = (v - head) // width
    per = -(-n // chunks)
    out = []
    for c in range(chunks):
        lo, hi = min(c * per, n), min(c * per + per, n)
        out.append((0 if c == 0 else head + width * lo,
                    v if c == chunks - 1 else head + width * hi))
    return out


def kld_accept_plain(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                     draft_tokens: torch.Tensor) -> Signals:
    """log_softmax sums, as the reference's ``kld_accept_ref`` (with the
    kernel's floor of KL at 0, and probability 0 for a token outside
    [0, V), as the Pallas kernel gives)."""
    lp = torch.log_softmax(target_logits.float(), dim=-1)
    lq = torch.log_softmax(draft_logits.float(), dim=-1)
    p, q = lp.exp(), lq.exp()
    kld = (p * (lp - lq)).sum(-1).clamp(min=0.0)
    ent = -(q * lq).sum(-1)
    tok = draft_tokens.long()
    inside = (tok >= 0) & (tok < p.shape[-1])
    idx = tok.clamp(0, p.shape[-1] - 1)[..., None]
    return (kld, ent,
            torch.where(inside, torch.gather(p, -1, idx)[..., 0], 0.0),
            torch.where(inside, torch.gather(q, -1, idx)[..., 0], 0.0))


def _state(x: torch.Tensor, w: torch.Tensor):
    """The online-logsumexp state (m, s, a) of logits ``x`` with weights
    ``w``: m = max x, s = sum e^(x-m), a = sum e^(x-m) w; empty (NEG_INF,
    0, 0)."""
    if x.numel() == 0:
        return (torch.tensor(NEG_INF), torch.tensor(0.0), torch.tensor(0.0))
    m = x.max()
    e = torch.exp(x - m)
    return m, e.sum(), (e * w).sum()


def _merge(x, y):
    m = torch.maximum(x[0], y[0])
    ex, ey = torch.exp(x[0] - m), torch.exp(y[0] - m)
    return m, x[1] * ex + y[1] * ey, x[2] * ex + y[2] * ey


def kld_accept_split_plain(target_logits: torch.Tensor,
                           draft_logits: torch.Tensor,
                           draft_tokens: torch.Tensor,
                           chunks: Optional[int] = None) -> Signals:
    """:func:`kld_accept_plain` computed as the kernel does: each row cut
    into ``chunks`` ranges (:func:`kld_split_ranges`; by default
    :func:`kld_chunks`), each chunk's target and draft states merged in
    chunk order, then the kernel's finalisation."""
    b, t, v = target_logits.shape
    c = kld_chunks(b * t, v) if chunks is None else int(chunks)
    out = torch.zeros((4, b, t), dtype=torch.float32)
    for i in range(b):
        for j in range(t):
            x, y = target_logits[i, j], draft_logits[i, j]
            head, width = row_units(x.data_ptr(), y.data_ptr(), v)
            xf, yf = x.float(), y.float()
            p = q = _state(xf[:0], xf[:0])
            for lo, hi in kld_split_ranges(v, c, head, width):
                p = _merge(p, _state(xf[lo:hi], xf[lo:hi] - yf[lo:hi]))
                q = _merge(q, _state(yf[lo:hi], yf[lo:hi]))
            s_p, s_q = p[1].clamp(min=1e-30), q[1].clamp(min=1e-30)
            lse_p, lse_q = p[0] + torch.log(s_p), q[0] + torch.log(s_q)
            out[0, i, j] = (p[2] / s_p - lse_p + lse_q).clamp(min=0.0)
            out[1, i, j] = lse_q - q[2] / s_q
            tok = int(draft_tokens[i, j])
            if 0 <= tok < v:
                out[2, i, j] = torch.exp(xf[tok] - lse_p)
                out[3, i, j] = torch.exp(yf[tok] - lse_q)
    out = out.to(target_logits.device)
    return out[0], out[1], out[2], out[3]


def _lib():
    fn = load_library("kld_accept").kld_accept
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, L, L, L, L, I, P]
        fn.restype = I
    return fn


def fused_kld_accept_cuda(target_logits: torch.Tensor,
                          draft_logits: torch.Tensor,
                          draft_tokens: torch.Tensor,
                          chunks: Optional[int] = None) -> Signals:
    """The CUDA kernel.  Logits are float32 [B, T, V] with a unit stride
    along V (any stride over B and T, so ``t_logits[:, :k]`` needs no
    copy); tokens int32 [B, T] contiguous.  ``chunks`` forces C (tests);
    by default :func:`kld_chunks` picks it."""
    b, t, v = target_logits.shape
    dev = target_logits.device
    if dev.type != "cuda":
        raise ValueError(f"kld kernel needs CUDA tensors, got {dev}")
    if tuple(draft_logits.shape) != (b, t, v) or tuple(draft_tokens.shape) != (b, t):
        raise ValueError(f"shapes {tuple(target_logits.shape)} "
                         f"{tuple(draft_logits.shape)} {tuple(draft_tokens.shape)}")
    if target_logits.dtype != torch.float32 or draft_logits.dtype != torch.float32:
        raise TypeError("logits must be float32")
    if draft_tokens.dtype != torch.int32 or not draft_tokens.is_contiguous():
        raise TypeError("tokens must be contiguous int32")
    if target_logits.stride(2) != 1 or draft_logits.stride(2) != 1:
        raise ValueError("logits need a unit stride along the vocabulary")
    if draft_logits.device != dev or draft_tokens.device != dev:
        raise ValueError("all inputs must be on one device")
    c = kld_chunks(b * t, v, sm_count(dev)) if chunks is None else int(chunks)
    if not 1 <= c <= MAX_CHUNKS:
        raise ValueError(f"chunks must be in 1..{MAX_CHUNKS}, got {chunks}")
    outs = torch.empty((4, b, t), dtype=torch.float32, device=dev)
    if b * t == 0:
        return outs[0], outs[1], outs[2], outs[3]
    err = _lib()(target_logits.data_ptr(), draft_logits.data_ptr(),
                 draft_tokens.data_ptr(), outs[0].data_ptr(),
                 outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                 b, t, v, target_logits.stride(0), target_logits.stride(1),
                 draft_logits.stride(0), draft_logits.stride(1), c,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kld_accept launch failed: cudaError {err}")
    LAUNCHES["fused_kld_accept"] += 1
    return outs[0], outs[1], outs[2], outs[3]


def kld_accept_signals(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                       draft_tokens: torch.Tensor) -> Signals:
    """Per-position (KL(p||q), H(q), p(tok), q(tok)): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if target_logits.device.type == "cuda":
        return fused_kld_accept_cuda(target_logits, draft_logits, draft_tokens)
    if target_logits.device.type == "cpu":
        return kld_accept_plain(target_logits, draft_logits, draft_tokens)
    raise ValueError(f"no kld signals for device {target_logits.device}")
