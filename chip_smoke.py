#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA
card.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — card name, ``nvidia-smi`` name and power limit, versions;
             TF32 is switched off for matmuls and convolutions.
2. build   — every CUDA source under ``src/repro_torch/csrc`` compiled
             (one ``nvcc`` each, in parallel) into ``build/kernels/``;
             then ptxas's registers, static shared memory and spills of
             every kernel of the three attention sources (B1, B4, B5),
             the fused KLD source (B2) and the n-gram source (B3).
3. kernels — each kernel against its plain PyTorch version on the card
             at the serving path's shapes (B1, B2, B4 and B5 also
             launched twice, which must give the same bits; B1 and B4
             also their wrappers' host time a call, and G * T 66 query
             rows a KV head, two launches a call; B5 also over partial
             rings, as a serve's rows hold them; B3 also at L 65536, on
             rows at a 4-byte offset and through the drafter's entry),
             with its tolerance, its time (the mean ``ms`` and the
             median ``ms_median`` of 30 event-bracketed launches), the
             plain version's time, a library call's time where one
             computes the same function, and the least time the card
             could take (bytes over 3.35 TB/s or operations over the
             peak for their operand type, 989 TFLOP/s for bf16 and 67
             TFLOP/s for fp32, whichever is larger); then an empty
             kernel timed the same way, the launch floor.
4. serve   — the host cost of one full-width decode step and of one
             KV write on each cache (forward phase), then
             ``ServingEngine(...).run`` at smollm-135m full width (30
             layers, d 576, 9/3 heads, vocab 49152 padded to 49280) with
             seeded random weights (``SERVES``): under the dsde policy
             the model drafter (target + 0.03 x noise) on the fp32 pool
             and on the int8 pool, the n-gram drafter on the int8 pool
             (undamped, printed only, and damped), the model drafter on
             the dense ring (synchronous and pipelined) and on the fp32
             pool pipelined; then the model drafter on the fp32 pool
             under adaedl, goodput and slo (whose streams must equal
             serve's), the self drafter (4 leading layers) on the dense
             ring, and slo with deadlines (half the requests 0.05 s,
             half 60 s: every request must finish and the admission
             gate must flag some).  Each kernel of a serve's path must
             launch during it; ``dispatch`` runs under
             ``torch.cuda.set_sync_debug_mode("warn")`` and must make
             no synchronising call; a serve with a twin must emit its
             twin's greedy streams.  Then some
             serves again under ``torch.profiler`` for a few rounds
             (device busy share, top kernels, the port's own kernels
             and host calls), and the paths at the reduced width on the
             card and on the CPU (plain versions) must emit the same
             greedy streams (the fp32 and int8 pools also at SL 16,
             verify passes past one launch of B1 and B4; adaedl,
             goodput and slo on the fp32 pool, goodput x n-gram on the
             int8 pool, the self drafter on the pool and the ring).

It ends with the script's seconds so far, the kernels line, the
``nvidia-smi`` line and the result line ``{"ok": true, "device":
{...}}``.  Any failure raises and exits
non-zero; without CUDA, or without the port beside it, it prints no
result.

    python3 chip_smoke.py --ab PARENT

runs a kernel A/B instead: the device and build phases, then this
file's kernel phase on the kernels of PARENT (another checkout, e.g.
unpacked with ``git archive``) and on this tree's in turns, parent,
change, change, parent, each in its own process on this card (rows
tagged ``ab_run`` and ``tree``; one timing harness for both trees; rows
of features the parent lacks are left out of its runs), and ptxas's
report of both trees' B3 source.  It prints no result line.
"""
import collections
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOP_S = 989e12         # H100 SXM bf16 tensor cores, dense
# the n-gram serve's target: residual output projections scaled by this
NGRAM_DAMP = 2e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timings(fn, iters: int = 30, flush=None):
    """Device ms of each of ``iters`` launches of ``fn``, each bracketed
    by CUDA events; ``flush`` (a large buffer) is rewritten before each
    launch so the kernel meets a cold L2, as between layers.  It is
    rewritten twice (about 0.2 ms of device time), so the card is still
    busy with it while the host enqueues the timed call: a wrapper's own
    host time (tens of us) never shows as device time between the
    events, unless the host stalls for longer (the median reads past
    such a stall, the mean does not)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def time_ms(fn, iters: int = 30, flush=None) -> float:
    """Mean device ms of ``fn`` (:func:`timings`)."""
    return statistics.fmean(timings(fn, iters, flush))


def kernel_ms(fn, flush) -> dict:
    """A kernel row's times: ``ms`` the mean (as every earlier row was
    read), ``ms_median`` the median of the same launches."""
    t = timings(fn, flush=flush)
    return {"ms": statistics.fmean(t), "ms_median": statistics.median(t)}


def host_us(fn, iters: int = 200) -> float:
    """Mean host microseconds of one call of ``fn``: what the caller's
    thread spends on it (checks, allocation, launch), the card running
    behind without a synchronise in between."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / iters


def paged_case(b, t, ctx, dtype, seed):
    """A full-context paged attention call: every row holds ``ctx``
    committed positions in scattered blocks, queries at the last ``t``."""
    import torch
    h, kv, d, bs = 9, 3, 64, 16
    g = torch.Generator(device="cpu").manual_seed(seed)
    maxb = ctx // bs
    n = b * maxb + 8
    q = torch.randn(b, t, h, d, generator=g).to(dtype)
    pk = torch.randn(n, bs, kv, d, generator=g).to(dtype)
    pv = torch.randn(n, bs, kv, d, generator=g).to(dtype)
    table = torch.randperm(n, generator=g)[:b * maxb].reshape(b, maxb).int()
    kv_pos = torch.full((n, bs), -1, dtype=torch.int32)
    pos = torch.arange(ctx, dtype=torch.int32).reshape(maxb, bs)
    for i in range(b):
        kv_pos[table[i].long()] = pos
    q_pos = (ctx - t + torch.arange(t, dtype=torch.int32))[None].repeat(b, 1)
    args = [x.cuda().contiguous() for x in (q, pk, pv, table, q_pos, kv_pos)]
    es = q.element_size()
    nbytes = (2 * q.numel() * es + 2 * b * ctx * kv * d * es
              + b * ctx * 4 + table.numel() * 4 + q_pos.numel() * 4)
    flops = 4 * b * h * t * ctx * d
    return args, nbytes, flops


def quant_case(b, t, ctx, dtype, seed):
    """:func:`paged_case` over an int8 pool: the same tables, the K/V
    quantized on the card (one scale per stored vector), q in ``dtype``.
    Bytes: the int8 K/V and fp32 scales of ``ctx`` slots per row, plus
    kv_pos, the table, q_pos, q and out."""
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, pk, pv, table, q_pos, kv_pos), _, flops = paged_case(
        b, t, ctx, torch.float32, seed)
    (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
    q = q.to(dtype)
    kv, d = pk.shape[2], pk.shape[3]
    nbytes = (2 * q.numel() * q.element_size() + 2 * b * ctx * kv * d
              + 2 * b * ctx * kv * 4 + b * ctx * 4 + table.numel() * 4
              + q_pos.numel() * 4)
    return [q, pk, pv, ks, vs, table, q_pos, kv_pos], nbytes, flops


def bound(nbytes, flops, flop_s):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak for the operand type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sdpa_ms(q, k, v, pos, q_pos, flush) -> float:
    """``F.scaled_dot_product_attention`` over an already gathered
    per-sequence view ``k``/``v [B, S, KV, D]`` with the same mask: a
    yardstick, never called by the port.  Only the call is timed."""
    import torch
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.to(q.dtype).repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.to(q.dtype).repeat_interleave(g, dim=2).transpose(1, 2)
    mask = ((pos[:, None, :] >= 0)
            & (pos[:, None, :] <= q_pos[:, :, None]))[:, None]
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), flush=flush)


def attention_rows(flush):
    """B1 and B4 at draft-step (T 1) and verify (T 11) shapes, ctx 256
    and 2048, fp32 and bf16 q, then fp32 at ctx 64 (about what the
    serves' rows hold), then T 22 at ctx 256 (G * T 66: the wrapper cuts
    T into two launches).  Each call is launched twice and must give the
    same bits (the splits merge in a fixed order).  Returns each kernel's
    contract row: the draft-step shape of the serves (fp32, T 1, ctx 256)
    with the largest error over all its rows."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as pq
    from repro_torch.models.cache import (gather_paged_kv,
                                          gather_paged_kv_quant,
                                          gather_paged_pos)

    # |kernel - plain| <= atol + rtol * |plain|, elementwise: fp32 at the
    # reference's own kernel tolerance; in bf16 both sides accumulate in
    # fp32 and round once, so they may differ by one bf16 ulp (rtol) or
    # a few ulps near 0 (atol)
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
    peak = {torch.float32: FP32_FLOP_S, torch.bfloat16: BF16_FLOP_S}
    kernels = (
        # Both compute in q's type: int8 K/V are exact in bf16, so B4's
        # operations with bf16 q count at the bf16 peak, as B1's do.  The
        # SDPA yardstick of B4 reads the view dequantized beforehand (not
        # timed).
        ("paged_ragged_verify_attention", paged_case,
         pa.paged_ragged_verify_attention_cuda,
         pa.paged_ragged_verify_attention_plain,
         lambda a: gather_paged_kv(a[1], a[2], a[3])),
        ("paged_ragged_verify_attention_quant", quant_case,
         pq.paged_ragged_verify_attention_quant_cuda,
         pq.paged_ragged_verify_attention_quant_plain,
         lambda a: gather_paged_kv_quant(*a[1:6])),
    )
    shapes = [(dtype, ctx, t) for dtype in (torch.float32, torch.bfloat16)
              for ctx in (256, 2048) for t in (1, 11)]
    shapes += [(torch.float32, 64, 1), (torch.float32, 64, 11)]
    passes = [shapes]
    if hasattr(pa, "query_groups"):
        # G * T 66, past one launch's 64 rows (SL 21): two launches a call;
        # after both kernels' other rows, so that an A/B parent without
        # them meets the same allocations up to there
        passes.append([(torch.float32, 256, 22), (torch.bfloat16, 256, 22)])
    contract, rows, worst = {}, collections.defaultdict(list), {}
    for (name, case, kernel, plain, gather), shapes in (
            (kn, sh) for sh in passes for kn in kernels):
        for dtype, ctx, t in shapes:
            args, nbytes, flops = case(4, t, ctx, dtype, seed=t + ctx)
            got = kernel(*args)
            want = plain(*args)
            again = kernel(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {dtype} ctx={ctx} t={t}: "
                                     "two launches differ")
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            atol, rtol = tol[dtype]
            if not bool((diff <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"{name} {dtype} ctx={ctx} t={t}: "
                                     f"max abs err {err}")
            worst[name] = max(worst.get(name, 0.0), err)
            bound_ms, bound_by = bound(nbytes, flops, peak[dtype])
            k, v = gather(args)
            pos = gather_paged_pos(args[-1], args[-3])
            row = {
                "phase": "kernel", "name": name,
                "dtype": str(dtype).replace("torch.", ""), "B": 4,
                "T": t, "H": 9, "KV": 3, "D": 64, "BS": 16, "ctx": ctx,
                "GT": 3 * t,
                "max_abs_err": err, "atol": atol, "rtol": rtol,
                **kernel_ms(lambda: kernel(*args), flush),
                "plain_ms": time_ms(lambda: plain(*args), flush=flush),
                "library_ms": sdpa_ms(args[0], k, v, pos, args[-2],
                                      flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "host_us": host_us(lambda: kernel(*args)),
            }
            emit(row)
            rows[name].append(row)
    for name, _, _, _, _ in kernels:
        first = next(r for r in rows[name] if r["dtype"] == "float32"
                     and r["T"] == 1 and r["ctx"] == 256)
        contract[name] = dict(first, max_abs_err=worst[name])
    return contract


def kld_row(flush):
    """B2 at the round's shape: t_logits[:, :K] of [B, K+1, V], B*K = 40."""
    import torch
    from repro_torch.kernels import kld_accept as kl
    b, k, v = 4, 10, 49280
    g = torch.Generator(device="cpu").manual_seed(5)
    tl = (torch.randn(b, k + 1, v, generator=g) * 3).cuda()
    dl = (torch.randn(b, k, v, generator=g) * 3).cuda()
    tok = torch.randint(0, 49152, (b, k), generator=g, dtype=torch.int32).cuda()
    got = kl.fused_kld_accept_cuda(tl[:, :k], dl, tok)
    want = kl.kld_accept_plain(tl[:, :k], dl, tok)
    again = kl.fused_kld_accept_cuda(tl[:, :k], dl, tok)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("fused kld: two launches differ")
    b2_err = max((x - y).abs().max().item() for x, y in zip(got, want))
    # KL and H (nats) absolute; p(tok) and q(tok) average 1/V here, far
    # below any useful absolute tolerance, so they are held relative
    b2_tol = {"kl_h_atol": 1e-4, "p_q_rtol": 1e-4, "p_q_atol": 1e-9}
    for name, x, y in zip(("kl", "h"), got[:2], want[:2]):
        if not bool(((x - y).abs() <= b2_tol["kl_h_atol"]).all()):
            raise AssertionError(f"fused kld {name}: max abs err "
                                 f"{(x - y).abs().max().item()}")
    b2_rel = 0.0
    for name, x, y in zip(("p_tok", "q_tok"), got[2:], want[2:]):
        d = (x - y).abs()
        if not bool((d <= b2_tol["p_q_atol"]
                     + b2_tol["p_q_rtol"] * y.abs()).all()):
            raise AssertionError(f"fused kld {name}: max rel err "
                                 f"{(d / y.abs()).max().item()}")
        b2_rel = max(b2_rel, (d / y.abs().clamp(min=1e-30)).max().item())
    nbytes = 2 * b * k * v * 4 + b * k * 4 + 4 * b * k * 4
    flops = 12 * b * k * v
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_S)
    row = {"phase": "kernel", "name": "fused_kld_accept", "dtype": "float32",
           "rows": b * k, "V": v, "max_abs_err": b2_err,
           "p_q_max_rel_err": b2_rel, **b2_tol,
           **kernel_ms(lambda: kl.fused_kld_accept_cuda(tl[:, :k], dl, tok),
                       flush),
           "plain_ms": time_ms(lambda: kl.kld_accept_plain(tl[:, :k], dl, tok),
                               flush=flush),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    return row


def ngram_rows(flush):
    """B3 at the drafter's shape (B 4, n 3, k 10) over history buffers
    of L 256 (the serves' max_seq_len), 4096 and 65536 (the cluster's
    staged capacity), tokens from a 4-symbol alphabet so that matches
    exist; per row ctx is n (too short to match), L/3, L-1 and L.  Then
    L 4096 with its rows at a 4-byte offset from 16 bytes (the vector-load
    path), and the drafter's entry (pending token at the committed length,
    stale text past it) at L 256.  Integer-exact against the plain
    version.  Bound: the bytes of the tokens the function needs (each
    matchable row's first ctx entries), ctx, the proposals and the counts;
    no single PyTorch call computes this function.  Returns the L 256
    row."""
    import torch
    from repro_torch.kernels import ngram_match as ng
    b, n, k = 4, 3, 10
    cases = [(256, 0, False), (4096, 0, False), (65536, 0, False),
             (4096, 1, False)]
    if hasattr(ng, "ngram_propose_history_cuda"):
        cases.append((256, 0, True))
    rows = []
    for l, off, history in cases:
        g = torch.Generator(device="cpu").manual_seed(l + off)
        host = torch.randint(0, 4, (b, l), generator=g, dtype=torch.int32)
        flat = torch.zeros(off + b * l, dtype=torch.int32, device="cuda")
        buf = flat[off:].view(b, l)
        buf.copy_(host.cuda())
        ctx_host = [n, l // 3, l - 1, l]
        ctx = torch.tensor(ctx_host, dtype=torch.int32).cuda()
        args = (buf, ctx)
        kernel, plain = ng.ngram_suffix_propose_cuda, ng.ngram_propose_plain
        if history:
            # committed lengths ctx - 1 (the last one L: the write dropped)
            length = torch.tensor([n - 1, l // 3 - 1, l - 2, l],
                                  dtype=torch.int32).cuda()
            pending = torch.randint(0, 4, (b,), generator=g,
                                    dtype=torch.int32).cuda()
            args = (buf, length, pending)
            kernel = ng.ngram_propose_history_cuda
            plain = ng.ngram_propose_history_plain
        got = kernel(*args, n=n, k=k)
        want = plain(*args, n=n, k=k)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"ngram match L={l} offset={off} "
                                 f"history={history}: kernel {got} != "
                                 f"plain {want}")
        counts = want[1].tolist()
        if counts[0] != 0 or max(counts) <= 0:
            raise AssertionError(f"ngram match L={l}: counts {counts}")
        needed = sum(min(c, l) for c in ctx_host if c >= n + 1)
        # the tokens, ctx (length and pending), the proposals, the counts
        nbytes = 4 * needed + 4 * b * (2 if history else 1) + 4 * b * k + 4 * b
        bound_ms, bound_by = bound(nbytes, n * needed, FP32_FLOP_S)
        row = {"phase": "kernel", "name": "ngram_suffix_propose",
               "entry": "history" if history else "tokens",
               "dtype": "int32", "B": b, "L": l, "n": n, "k": k,
               "row_offset_bytes": 4 * off, "ctx": ctx_host, "counts": counts,
               "max_abs_err": max((x - y).abs().max().item()
                                  for x, y in zip(got, want)),
               **kernel_ms(lambda: kernel(*args, n=n, k=k), flush),
               "plain_ms": time_ms(lambda: plain(*args, n=n, k=k),
                                   flush=flush),
               "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows.append(row)
    return rows[0]


def floor_row(flush):
    """The launch floor: an empty kernel (one warp), timed as the kernels
    are.  No kernel here can take less."""
    import ctypes
    import torch
    from repro_torch.kernels.build import SOURCES, load_library
    if "launch_floor" not in SOURCES:
        return
    fn = load_library("launch_floor").launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")
    emit({"phase": "kernel", "name": "launch_floor", "what": "empty kernel, "
          "one warp, event-bracketed", **kernel_ms(launch, flush)})


def ring_case(b, t, w, dtype, seed, wrap=False, fill=None):
    """A dense-ring attention call: every row's ring full (positions 0 ..
    W-1, queries at the last ``t``), or with ``wrap`` rows that have run
    past W (slot j holds the latest position p = j mod W), or with
    ``fill`` (one count a row) rows holding positions 0 .. fill-1 in slots
    0 .. fill-1, the rest empty (-1), queries at the last ``t``.  Bytes:
    the K/V of the slots that hold a position, all W positions of
    kv_pos, q_pos, q and out; operations over the slots that hold one."""
    import torch
    h, kv, d = 9, 3, 64
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g).to(dtype)
    kb = torch.randn(b, w, kv, d, generator=g).to(dtype)
    vb = torch.randn(b, w, kv, d, generator=g).to(dtype)
    end = torch.full((b,), w)
    if wrap:
        end = torch.randint(w + t, 3 * w, (b,), generator=g)
    if fill is not None:
        end = torch.tensor(fill)
    j = torch.arange(w)[None]
    kv_pos = (j + w * torch.div(end[:, None] - 1 - j, w,
                                rounding_mode="floor")).int()
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
    q_pos = (end[:, None] - t + torch.arange(t)[None]).int()
    args = [x.cuda().contiguous() for x in (q, kb, vb, q_pos, kv_pos)]
    held = int(end.clamp(max=w).sum())
    es = q.element_size()
    nbytes = (2 * q.numel() * es + 2 * held * kv * d * es + b * w * 4
              + q_pos.numel() * 4)
    flops = 4 * h * t * held * d
    return args, nbytes, flops


def ring_rows(flush):
    """B5 at B1's shapes: draft step (T 1) and verify (T 11) over full
    rings of W 256 (the serves' max_seq_len) and 2048, fp32 and bf16 q
    and rings, B1's tolerances; then partial rings as a serve's rows hold
    them (W 256 with 40-64 positions a row, W 2048 with 300), whose bound
    counts the K/V of the slots that hold a position plus W x 4 bytes of
    kv_pos a row; then a windowed ring that has wrapped (window 64, W 80,
    positions up to 3W) for its error alone.  Each call is launched twice
    and must give the same bits.  The library yardstick is SDPA over the
    ring with the same mask.  Returns the fp32 T 1 W 256 full row with the
    largest error over all rows."""
    import torch
    from repro_torch.kernels import ragged_attention as ra
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
    peak = {torch.float32: FP32_FLOP_S, torch.bfloat16: BF16_FLOP_S}
    name = "ragged_verify_attention"

    def check(args, dtype, window, what):
        got = ra.ragged_verify_attention_cuda(*args, window=window)
        want = ra.ragged_verify_attention_plain(*args, window=window)
        again = ra.ragged_verify_attention_cuda(*args, window=window)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {what}: two launches differ")
        diff = (got.float() - want.float()).abs()
        atol, rtol = tol[dtype]
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"{name} {what}: max abs err "
                                 f"{diff.max().item()}")
        return diff.max().item()

    rows, worst = [], 0.0
    # positions a row: None = a full ring
    fills = [(256, None), (2048, None), (256, [40, 48, 56, 64]),
             (2048, [300] * 4)]
    for dtype in (torch.float32, torch.bfloat16):
        for w, fill in fills:
            for t in (1, 11):
                args, nbytes, flops = ring_case(4, t, w, dtype, seed=t + w,
                                                fill=fill)
                err = check(args, dtype, None,
                            f"{dtype} W={w} t={t} fill={fill}")
                worst = max(worst, err)
                bound_ms, bound_by = bound(nbytes, flops, peak[dtype])
                atol, rtol = tol[dtype]
                row = {
                    "phase": "kernel", "name": name,
                    "dtype": str(dtype).replace("torch.", ""), "B": 4, "T": t,
                    "H": 9, "KV": 3, "D": 64, "W": w,
                    "positions": fill or [w] * 4,
                    "bound_counts": ("all W slots" if fill is None else
                                     "K/V of the slots holding a position "
                                     "+ W x 4 B of kv_pos a row"),
                    "max_abs_err": err, "atol": atol, "rtol": rtol,
                    **kernel_ms(lambda: ra.ragged_verify_attention_cuda(
                        *args), flush),
                    "plain_ms": time_ms(lambda: ra.ragged_verify_attention_plain(
                        *args), flush=flush),
                    "library_ms": sdpa_ms(args[0], args[1], args[2], args[4],
                                          args[3], flush),
                    "bound_ms": bound_ms, "bound_by": bound_by}
                emit(row)
                rows.append(row)
    args, _, _ = ring_case(4, 11, 80, torch.float32, seed=80, wrap=True)
    err = check(args, torch.float32, 64, "windowed wrapped ring")
    worst = max(worst, err)
    emit({"phase": "kernel", "name": name, "dtype": "float32", "B": 4,
          "T": 11, "W": 80, "window": 64, "wrapped": True,
          "max_abs_err": err})
    first = next(r for r in rows if r["dtype"] == "float32"
                 and r["T"] == 1 and r["W"] == 256
                 and r["positions"] == [256] * 4)
    return dict(first, max_abs_err=worst)


def kernel_phase(flush):
    """Every kernel's rows; first about 0.1 s of L2 flushes, so the
    card's clocks have left idle before the first timed call."""
    import torch
    for _ in range(1000):
        flush.zero_()
    torch.cuda.synchronize()
    contract = attention_rows(flush)
    contract["fused_kld_accept"] = kld_row(flush)
    contract["ngram_suffix_propose"] = ngram_rows(flush)
    contract["ragged_verify_attention"] = ring_rows(flush)
    floor_row(flush)
    return contract


def _counter_modules():
    from repro_torch.kernels import (kld_accept, ngram_match, paged_attention,
                                     paged_attention_quant, ragged_attention)
    return (paged_attention, kld_accept, paged_attention_quant, ngram_match,
            ragged_attention)


def reset_launches() -> None:
    for mod in _counter_modules():
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def read_launches():
    return {k: v for mod in _counter_modules() for k, v in mod.LAUNCHES.items()}


class Serve(NamedTuple):
    """One full-width serve.  ``nblocks`` None serves from the dense ring
    (``paged_kv=False``), else from a pool of that many blocks of 16.
    ``twin``: the serve whose greedy streams this one must equal.
    ``path``: the kernels that must launch during it.  ``self_layers``:
    the self drafter's leading layers.  ``deadlines``: odd requests
    carry a deadline no round can meet (0.05 s), even ones a loose one
    (60 s); the SLO gate must flag some, and the streams are printed
    beside ``serve``'s, not required to equal them (deferral changes
    which slot a request runs in)."""
    name: str
    drafter: str
    kv_quant: str
    nblocks: Optional[int]
    pipelined: bool
    damp: float
    path: Tuple[str, ...]
    twin: Optional[str] = None
    policy: str = "dsde"
    self_layers: int = 1
    deadlines: bool = False


# 32 blocks of 16 are half the dense equivalent of batch 4 x 256 tokens;
# the n-gram drafter holds no draft KV, so its 16 are doubled to 32.
# "serve-ngram-undamped" shows why the n-gram serve's target is damped:
# the seeded random target's greedy streams repeat no n-gram, so prompt
# lookup never proposes (its count is printed, not required).
SERVES = (
    Serve("serve", "model", "none", 32, False, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept")),
    Serve("serve-int8", "model", "int8", 32, False, 1.0,
          ("paged_ragged_verify_attention_quant", "fused_kld_accept")),
    Serve("serve-ngram-undamped", "ngram", "int8", 16, False, 1.0,
          ("ngram_suffix_propose", "paged_ragged_verify_attention_quant")),
    Serve("serve-ngram-int8", "ngram", "int8", 16, False, NGRAM_DAMP,
          ("ngram_suffix_propose", "paged_ragged_verify_attention_quant")),
    Serve("serve-dense", "model", "none", None, False, 1.0,
          ("ragged_verify_attention", "fused_kld_accept")),
    Serve("serve-dense-pipe", "model", "none", None, True, 1.0,
          ("ragged_verify_attention", "fused_kld_accept"), twin="serve-dense"),
    Serve("serve-pipe", "model", "none", 32, True, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept"), twin="serve"),
    Serve("serve-adaedl", "model", "none", 32, False, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept"),
          policy="adaedl"),
    Serve("serve-goodput", "model", "none", 32, False, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept"),
          policy="goodput"),
    Serve("serve-slo", "model", "none", 32, False, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept"), twin="serve",
          policy="slo"),
    Serve("serve-self", "self", "none", None, False, 1.0,
          ("ragged_verify_attention", "fused_kld_accept"), self_layers=4),
    Serve("serve-slo-deadlines", "model", "none", 32, False, 1.0,
          ("paged_ragged_verify_attention", "fused_kld_accept"),
          policy="slo", deadlines=True),
)
# profiled after every untraced serve (each trace costs host time)
PROFILED = ("serve", "serve-int8", "serve-ngram-int8", "serve-dense",
            "serve-dense-pipe")


def damped(params, alpha):
    """``params`` with the residual branches' output projections
    (``attn.wo``, ``mlp.w_down``) scaled by ``alpha``: every layer still
    runs at full width, but the token embedding stays large in the
    residual stream, so greedy streams run in repeats of a token, which
    the n-gram drafter's lookup finds."""
    if alpha == 1.0:
        return params
    layers = dict(params["layers"])
    layers["attn"] = dict(layers["attn"], wo=layers["attn"]["wo"] * alpha)
    layers["mlp"] = dict(layers["mlp"], w_down=layers["mlp"]["w_down"] * alpha)
    return dict(params, layers=layers)


def serve_prompts(vocab, drafter):
    """8 requests, 32 new tokens each.  The n-gram serve's prompts repeat
    a seeded 8-token phrase 3 times before a random tail."""
    import numpy as np
    rng = np.random.RandomState(0)
    if drafter != "ngram":
        return [rng.randint(0, vocab, size=rng.randint(6, 21)).tolist()
                for _ in range(8)]
    return [rng.randint(0, vocab, size=8).tolist() * 3
            + rng.randint(0, vocab, size=rng.randint(2, 9)).tolist()
            for _ in range(8)]


def count_syncs(eng):
    """Run ``eng.dispatch`` under ``torch.cuda.set_sync_debug_mode("warn")``
    and count the synchronising calls it makes, by the innermost line of
    this checkout on the call's stack."""
    import torch
    counts = collections.Counter()
    dispatch = eng.dispatch

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(ROOT)) and f.name != "show"]
        if ours:
            filename, lineno = ours[-1].filename, ours[-1].lineno
        counts[f"{filename.replace(str(ROOT) + '/', '')}:{lineno}"] += 1

    def watched():
        # the mode is switched outside the counted region: its first
        # switch warns by itself, before any operation runs
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng.dispatch = watched
    return counts


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    cfg = get_config("smollm-135m")
    pt = init_params(cfg, seed=0, device="cuda")
    noise = init_params(cfg, seed=1, device="cuda")
    pd = map_params(lambda a, n: a + 0.03 * n, pt, noise)
    # every untraced measurement comes before the first profiled run, so
    # that none follows a torch.profiler session
    forward_phase(cfg, pt)
    total = {k: 0 for k in read_launches()}
    profiled, streams = [], {}
    for sv in SERVES:
        model = sv.drafter == "model"
        serving = ServingConfig(max_batch_size=4, max_seq_len=256,
                                pipelined=sv.pipelined,
                                paged_kv=sv.nblocks is not None,
                                kv_block_size=16, num_kv_blocks=sv.nblocks,
                                kv_quant=sv.kv_quant)

        def engine(target=damped(pt, sv.damp), model=model, sv=sv,
                   serving=serving):
            return ServingEngine(target, cfg, pd if model else None,
                                 cfg if model else None,
                                 SpecDecodeConfig(
                                     policy=sv.policy, drafter=sv.drafter,
                                     self_draft_layers=sv.self_layers),
                                 serving, seed=0, device="cuda")

        reqs = [Request(i, prompt=p, max_new_tokens=32,
                        slo_deadline_s=((0.05 if i % 2 else 60.0)
                                        if sv.deadlines else None))
                for i, p in enumerate(serve_prompts(cfg.vocab_size,
                                                    sv.drafter))]
        # one-time set-up (library handles, allocator pools) outside the
        # measured run
        engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
        eng = engine()
        syncs = count_syncs(eng)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        m = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_launches()
        if min(launches[k] for k in sv.path) <= 0:
            raise AssertionError(f"{sv.name}: a kernel of the path never ran: "
                                 f"{launches}")
        if m["requests_finished"] != 8 or any(len(r.output) != 32 for r in reqs):
            raise AssertionError(f"{sv.name} did not finish every request: {m}")
        if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
            raise AssertionError(f"{sv.name}: a token outside the vocabulary")
        proposing = sum(1 for r in eng.round_log if r["proposed"] > 0)
        if sv.name == "serve-ngram-int8" and proposing == 0:
            raise AssertionError(f"{sv.name}: no round proposed a token")
        if sum(syncs.values()):
            raise AssertionError(f"{sv.name}: dispatch synchronised: "
                                 f"{dict(syncs)}")
        if sv.deadlines and m["slo_predicted_violations"] <= 0:
            raise AssertionError(f"{sv.name}: the SLO gate flagged nothing")
        streams[sv.name] = [r.output for r in reqs]
        row = {"phase": sv.name, "arch": cfg.name, "layers": cfg.num_layers,
               "policy": sv.policy, "self_draft_layers": (
                   sv.self_layers if sv.drafter == "self" else None),
               "drafter": sv.drafter, "kv_quant": sv.kv_quant,
               "paged_kv": sv.nblocks is not None, "pipelined": sv.pipelined,
               "residual_scale": sv.damp,
               "requests": len(reqs), "rounds": m["rounds"],
               "tokens": m["tokens_emitted"], "preemptions": m["preemptions"],
               "proposed": sum(r["proposed"] for r in eng.round_log),
               "proposing_rounds": proposing,
               "mean_acceptance": m["mean_acceptance"],
               "block_efficiency": m["block_efficiency"], "wall_s": wall,
               "tokens_per_s": m["tokens_emitted"] / wall,
               "host_blocked_s": m["host_blocked_s"],
               "dispatch_syncs": sum(syncs.values()),
               "dispatch_sync_sources": dict(syncs),
               "draft_steps": m["draft_steps"],
               "kv_pool_blocks": m["kv_pool_blocks"],
               "kv_block_bytes": m["kv_block_bytes"],
               "kv_pool_bytes": m["kv_pool_bytes"], "launches": launches,
               "slo_predicted_violations": m["slo_predicted_violations"],
               "slo_deferrals": m["slo_deferrals"],
               "slo_attained_frac": m["slo_attained_frac"],
               "tf32": False}
        if sv.twin is not None:
            row["equal_to_" + sv.twin] = streams[sv.name] == streams[sv.twin]
        if sv.deadlines:                 # printed only
            row["equal_to_serve"] = streams[sv.name] == streams["serve"]
        emit(row)
        if sv.twin is not None and streams[sv.name] != streams[sv.twin]:
            raise AssertionError(f"{sv.name}: greedy streams differ from "
                                 f"{sv.twin}'s")
        if sv.name != "serve-ngram-undamped":
            for k in total:
                total[k] += launches[k]
        if sv.name in PROFILED:
            profiled.append((sv.name, engine, reqs))
    # dense and paged may sum attention in other orders, so random-weight
    # argmax streams may part at a near tie: printed, not required
    emit({"phase": "dense-vs-paged",
          "what": "full-width greedy streams, serve-dense vs serve",
          "equal": streams["serve-dense"] == streams["serve"],
          "requests_equal": sum(a == b for a, b in zip(streams["serve-dense"],
                                                       streams["serve"]))})
    for args in profiled:
        profile_phase(*args)
    check_phase(cfg)
    return total


def forward_phase(cfg, params) -> None:
    """Host cost of one full-width decode step (B 4, T 1, 128 committed
    tokens per row) on the fp32 and int8 pools and on the dense ring, and
    of its per-layer KV write alone: the serve is host-bound, so these
    set its pace.  Wall time per call with a synchronise after the timed
    loop."""
    import torch
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import forward

    b, ctx, bs = 4, 128, 16
    row = {"phase": "forward", "B": b, "T": 1, "ctx": ctx}
    for mode in ("none", "int8", "ring"):
        length = torch.full((b,), ctx, dtype=torch.int32, device="cuda")
        if mode == "ring":
            cache = cache_lib.cache_struct(cfg, b, 256, device="cuda")
            cache["kv_pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32,
                                                    device="cuda")
            slots = cache_lib.ring_slots(length[:, None], 256)
        else:
            cache = cache_lib.paged_cache_struct(
                cfg, b, 256, b * ctx // bs + 8, bs, device="cuda",
                kv_quant=mode)
            cache["block_table"][:, :ctx // bs] = torch.arange(
                b * ctx // bs, dtype=torch.int32, device="cuda").reshape(b, -1)
            cache["kv_pos"][:b * ctx // bs] = torch.arange(
                ctx, dtype=torch.int32, device="cuda").reshape(-1, bs).repeat(b, 1)
            slots = cache_lib.write_slots(length[:, None],
                                          cache["block_table"], bs,
                                          cache["kv_pos"].shape[0])
        cache["length"] = length
        tok = torch.ones((b, 1), dtype=torch.int32, device="cuda")
        kv = torch.randn(2, b, 1, cfg.num_kv_heads, cfg.resolved_head_dim,
                         device="cuda")
        if mode == "int8":
            layer = [cache[n][0] for n in ("k", "v", "k_scale", "v_scale")]
            write = lambda: cache_lib.write_kv_paged_quant(*layer, kv[0], kv[1],
                                                           slots)
        elif mode == "ring":
            layer = [cache[n][0] for n in ("k", "v")]
            write = lambda: cache_lib.write_kv(*layer, kv[0], kv[1], slots)
        else:
            layer = [cache[n][0] for n in ("k", "v")]
            write = lambda: cache_lib.write_kv_paged(*layer, kv[0], kv[1], slots)
        for fn, n, key in ((lambda: forward(params, cfg, tok, cache=cache,
                                            mode="decode"), 20, "forward_ms"),
                           (write, 200, "kv_write_ms")):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            row[f"{key}_{mode}"] = 1e3 * (time.monotonic() - t0) / n
    emit(row)


class Check(NamedTuple):
    """One reduced-width card == CPU check: drafter, pool storage, dense
    ring?, pipelined, attention window, static SL (None: the policy's
    own), policy, and the scale of the draft's tied embedding."""
    drafter: str
    kv_quant: str
    dense: bool
    pipelined: bool
    window: Optional[int]
    sl: Optional[int]
    policy: str = "dsde"
    sharpen: float = 1.0


CHECKS = (
    Check("model", "none", False, False, None, None),
    Check("model", "int8", False, False, None, None),
    Check("ngram", "int8", False, False, None, None),
    Check("model", "none", True, False, None, None),
    Check("model", "none", True, True, None, None),
    Check("ngram", "none", True, False, None, None),
    Check("model", "none", True, False, 24, None),
    Check("model", "none", False, False, None, 16),
    Check("model", "int8", False, False, None, 16),
    Check("model", "none", False, False, None, None, "adaedl", 8.0),
    Check("model", "none", False, False, None, None, "goodput"),
    Check("model", "none", False, False, None, None, "slo"),
    Check("ngram", "int8", False, False, None, None, "goodput"),
    Check("self", "none", False, False, None, None),
    Check("self", "none", True, False, None, None),
    Check("self", "none", True, True, None, None),
)
# the adaedl check's stop bound: with the draft's embedding x 8 its
# bounds spread over 0.005-0.045 at this width, so drafts stop partway
ADAEDL_CHECK_THRESHOLD = 0.01


def check_phase(cfg) -> None:
    """The serves' paths at the reduced width: card (kernels) vs CPU
    (plain versions), equal greedy streams, on the pool and on the dense
    ring (synchronous, pipelined, and windowed: window 24 makes a ring of
    40 slots that every request runs past).  The n-gram engine looks up
    1-grams here: with random weights the streams never repeat a trigram
    at this width, and the check needs proposals to be made.  The last two
    run the static policy at SL 16 (sl_max 16) on the fp32 and int8
    pools: verify passes of T 17, G * T 68 query rows a KV head (G 4),
    past one launch of B1 and B4, which their wrappers cut in two (with
    random weights the dsde policy would keep SL near sl_min).  Then the
    adaedl (its draft sharpened so drafts stop partway), goodput and slo
    policies on the fp32 pool, goodput with the n-gram drafter on the
    int8 pool, and the self drafter (one leading layer) on the fp32 pool
    and on the dense ring, synchronous and pipelined."""
    import dataclasses
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    small = cfg.reduced()
    p_small = init_params(small, seed=2, device="cpu")
    d_small = map_params(lambda a, n: a + 0.03 * n, p_small,
                         init_params(small, seed=3, device="cpu"))
    for drafter, kv_quant, dense, pipelined, window, sl, policy, sharpen \
            in CHECKS:
        model = drafter == "model"
        arch = dataclasses.replace(small, attention_window=window)
        spec = SpecDecodeConfig(policy=policy, drafter=drafter,
                                ngram_n=1 if drafter == "ngram" else 3,
                                adaedl_threshold=ADAEDL_CHECK_THRESHOLD)
        draft = (d_small if sharpen == 1.0 else
                 dict(d_small, embed=d_small["embed"] * sharpen))
        if sl is not None:
            spec = dataclasses.replace(spec, policy="static", sl_max=sl,
                                       static_sl=sl)
        outs, proposed, length, max_k, partial = {}, {}, 0, 0, 0
        for device in ("cuda", "cpu"):
            rs = [Request(i, prompt=list(range(3 + i, 12 + 2 * i)) * 2,
                          max_new_tokens=24) for i in range(4)]
            eng = ServingEngine(
                p_small, arch, draft if model else None,
                arch if model else None, spec,
                ServingConfig(max_batch_size=2, max_seq_len=128,
                              pipelined=pipelined, paged_kv=not dense,
                              kv_block_size=16, num_kv_blocks=8,
                              kv_quant=kv_quant),
                device=device)
            eng.run(rs)
            outs[device] = [r.output for r in rs]
            proposed[device] = sum(r["proposed"] for r in eng.round_log)
            length = min(r.cache_len for r in rs)
            max_k = max(r["k"] for r in eng.round_log)
            # rounds where some row's draft stopped short of the bucket
            partial = sum(1 for r in eng.round_log
                          if r["k"] and r["proposed"] % r["k"])
        same = outs["cuda"] == outs["cpu"] and proposed["cuda"] == proposed["cpu"]
        if proposed["cuda"] <= 0:
            raise AssertionError(f"check ({drafter}, {kv_quant}, {policy}): "
                                 "no proposals")
        if policy == "adaedl" and partial <= 0:
            raise AssertionError("adaedl check: no draft stopped partway")
        ring = (window + 16) if window else None
        if ring and length <= ring:
            raise AssertionError(f"windowed check: rows of {length} tokens "
                                 f"never wrap a {ring}-slot ring")
        rows_per_kv = (small.num_heads // small.num_kv_heads) * (max_k + 1)
        if sl is not None and rows_per_kv <= 64:
            raise AssertionError(f"SL {sl} check: verify passes of "
                                 f"{rows_per_kv} query rows a KV head fit "
                                 "one launch")
        emit({"phase": "check", "what": "reduced-width greedy streams, card vs CPU",
              "drafter": drafter, "policy": policy, "draft_sharpen": sharpen,
              "kv_quant": kv_quant,
              "layout": "dense" if dense else "paged", "pipelined": pipelined,
              "window": window, "ring_slots": ring, "static_sl": sl,
              "max_k": max_k, "verify_rows_per_kv_head": rows_per_kv,
              "min_tokens": length, "requests": 4,
              "proposed": proposed["cuda"], "partial_rounds": partial,
              "equal": same})
        if not same:
            raise AssertionError(f"card and CPU streams differ ({drafter}, "
                                 f"{kv_quant}, {policy}, dense={dense}, "
                                 "pipelined="
                                 f"{pipelined}, window={window}, sl={sl}): "
                                 f"{outs}")


# the device kernels of the port's CUDA sources, by name; the attention
# kernels' names carry their addressing policy (pv::TableAddr for B1 and
# B4, pv::RingAddr for B5) as the first template argument
PORT_KERNELS = ("pv::verify_kernel", "pv::merge_kernel", "kld_accept_kernel",
                "ngram_match_kernel")


def profile_phase(serve, engine, reqs) -> None:
    """The first four requests of ``serve`` again, for their prefill and
    first six rounds, under ``torch.profiler``: device kernel time
    against the run's wall (the device's busy share), the kernels that
    take it, and on the host the operator and CUDA runtime calls that
    take the most time (a synchronising call shows as
    ``cudaStreamSynchronize`` / ``cudaMemcpyAsync``).  A separate run, so
    the serve's tokens/s above carries no tracing cost; kept short
    because the trace is processed on the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import Request

    again = [Request(r.request_id, prompt=r.prompt, max_new_tokens=32)
             for r in reqs[:4]]
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.run(again, max_rounds=6)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    emit({"phase": "profile", "serve": serve, "requests": len(again),
          "rounds": eng.rounds, "wall_s": wall,
          "device_kernel_s": device_us / 1e6,
          "device_busy_share": device_us / 1e6 / wall,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top],
          "port_kernels": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in kernels
                           if any(n in e.key for n in PORT_KERNELS)],
          "top_host": [{"name": e.key[:60], "calls": e.count,
                        "self_cpu_ms": e.self_cpu_time_total / 1e3}
                       for e in host]})


# the sources whose kernels' registers, shared memory and spills the
# build phase reports (B1, B4, B5, B2, B3)
PTXAS_SOURCES = ("paged_attention", "paged_attention_quant", "ragged_attention",
                 "kld_accept", "ngram_match")

# one A/B run: this file's kernel phase (one harness for both trees) on
# the kernels of the tree whose ``src`` is argv[2]
_AB_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.path.insert(0, sys.argv[2])
import repro_torch
assert repro_torch.__file__.startswith(sys.argv[2]), repro_torch.__file__
from repro_torch.kernels.build import build_all
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build_all()
chip_smoke.kernel_phase(torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                    device="cuda"))
"""


# the sources whose ptxas reports the A/B compares (B3: this change's)
AB_PTXAS_SOURCES = ("ngram_match",)


def ab_phase(parent: Path) -> None:
    """This file's kernel phase on ``parent``'s kernels and on this
    tree's in turns (parent, change, change, parent), each in a process
    of its own that builds and imports its tree's ``repro_torch``; then
    ptxas's report of each tree's ``AB_PTXAS_SOURCES``, compiled with this
    tree's flags."""
    import tempfile
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc, parse_ptxas
    trees = (("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent))
    for i, (tag, tree) in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", _AB_CHILD, str(ROOT),
                               str(tree / "src")], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"A/B run {i} ({tag}) failed:\n"
                               + proc.stdout[-4000:] + proc.stderr[-4000:])
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit(dict(json.loads(line), ab_run=i, tree=tag))
    for tag, tree in (("parent", parent), ("change", ROOT)):
        for source in AB_PTXAS_SOURCES:
            with tempfile.TemporaryDirectory() as tmp:
                src = tree / "src" / "repro_torch" / "csrc" / f"{source}.cu"
                log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o",
                                      str(Path(tmp) / "lib.so"), str(src)],
                                     capture_output=True, text=True,
                                     timeout=600, check=True)
            emit({"phase": "ptxas", "tree": tag, "source": source,
                  "kernels": parse_ptxas(log.stdout + log.stderr)})


def main() -> int:
    t_start = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all, ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    t0 = time.monotonic()
    per_source = build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "per_source_s": per_source})
    for source in PTXAS_SOURCES:
        emit({"phase": "ptxas", "source": source,
              "kernels": ptxas_report(source)})
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        ab_phase(Path(sys.argv[2]).resolve())
        return 0

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    contract = kernel_phase(flush)
    del flush
    launches = serve_phase()

    sources = {
        "paged_ragged_verify_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/ragged_attention.py:189"),
        "fused_kld_accept": ("src/repro_torch/csrc/kld_accept.cu",
                             "src/repro/kernels/kld_accept.py:99"),
        "ngram_suffix_propose": ("src/repro_torch/csrc/ngram_match.cu",
                                 "src/repro/kernels/ngram_match.py:66"),
        "paged_ragged_verify_attention_quant": (
            "src/repro_torch/csrc/paged_attention_quant.cu",
            "src/repro/kernels/ragged_attention.py:309"),
        "ragged_verify_attention": (
            "src/repro_torch/csrc/ragged_attention.cu",
            "src/repro/kernels/ragged_attention.py:88"),
    }
    emit({"phase": "total", "seconds": time.monotonic() - t_start})
    kernels = []
    for kernel, (src, replaces) in sources.items():
        row = contract[kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
