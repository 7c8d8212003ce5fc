"""Fused KLD / acceptance signals: the CUDA kernel, its plain PyTorch
version, and the dispatcher the round calls.

Replaces the TPU kernel ``fused_kld_accept`` (``repro/kernels/
kld_accept.py``).  The kernel source is ``csrc/kld_accept.cu``; see its
header for the design and bound.  Per [B, T] row of target / draft
logits and proposed tokens it returns ``(KL(p || q) floored at 0,
H(q), p(tok), q(tok))``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library

LAUNCHES = {"fused_kld_accept": 0}

Signals = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def kld_accept_plain(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                     draft_tokens: torch.Tensor) -> Signals:
    """log_softmax sums, as the reference's ``kld_accept_ref`` (with the
    kernel's floor of KL at 0)."""
    lp = torch.log_softmax(target_logits.float(), dim=-1)
    lq = torch.log_softmax(draft_logits.float(), dim=-1)
    p, q = lp.exp(), lq.exp()
    kld = (p * (lp - lq)).sum(-1).clamp(min=0.0)
    ent = -(q * lq).sum(-1)
    idx = draft_tokens.long()[..., None]
    return (kld, ent, torch.gather(p, -1, idx)[..., 0],
            torch.gather(q, -1, idx)[..., 0])


def _lib():
    fn = load_library("kld_accept").kld_accept
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, L, L, L, L, P]
        fn.restype = I
    return fn


def fused_kld_accept_cuda(target_logits: torch.Tensor,
                          draft_logits: torch.Tensor,
                          draft_tokens: torch.Tensor) -> Signals:
    """The CUDA kernel.  Logits are float32 [B, T, V] with a unit stride
    along V (any stride over B and T, so ``t_logits[:, :k]`` needs no
    copy); tokens int32 [B, T] contiguous."""
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
    outs = torch.empty((4, b, t), dtype=torch.float32, device=dev)
    if b * t == 0:
        return outs[0], outs[1], outs[2], outs[3]
    err = _lib()(target_logits.data_ptr(), draft_logits.data_ptr(),
                 draft_tokens.data_ptr(), outs[0].data_ptr(),
                 outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                 b, t, v, target_logits.stride(0), target_logits.stride(1),
                 draft_logits.stride(0), draft_logits.stride(1),
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
