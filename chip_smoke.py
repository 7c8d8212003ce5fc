#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA
card.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — card name, ``nvidia-smi`` name and power limit, versions;
             TF32 is switched off for matmuls and convolutions.
2. build   — every CUDA source under ``src/repro_torch/csrc`` compiled
             (one ``nvcc`` each, in parallel) into ``build/kernels/``.
3. kernels — each kernel against its plain PyTorch version on the card
             at the serving path's shapes, with its tolerance, its time,
             the plain version's time, a library call's time where one
             computes the same function, and the least time the card
             could take (bytes over 3.35 TB/s or operations over the
             peak for their operand type, 989 TFLOP/s for bf16 and
             67 TFLOP/s for fp32, whichever is larger).
4. serve   — ``ServingEngine(...).run`` at smollm-135m full width (30
             layers, d 576, 9/3 heads, vocab 49152 padded to 49280) with
             seeded random weights, the model drafter (target + 0.03 x
             noise) and the dsde policy on the block-paged fp32 pool;
             the kernels' launch counters must rise during the serve.
             Then the same engine at the reduced width on the card and on
             the CPU (plain versions) must emit the same greedy streams.

It ends with the kernels line, the ``nvidia-smi`` line and the result
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without CUDA, or without the port beside it, it prints no
result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOP_S = 989e12         # H100 SXM bf16 tensor cores, dense


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 30, flush=None) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each bracketed
    by CUDA events; ``flush`` (a large buffer) is rewritten before each
    launch so the kernel meets a cold L2, as between layers."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


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


def bound(nbytes, flops, flop_s):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak for the operand type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sdpa_ms(args, flush) -> float:
    """``F.scaled_dot_product_attention`` over the gathered per-sequence
    view with the same mask: a yardstick, never called by the port."""
    import torch
    from repro_torch.models.cache import gather_paged_kv, gather_paged_pos
    q, pk, pv, table, q_pos, kv_pos = args
    k, v = gather_paged_kv(pk, pv, table)
    pos = gather_paged_pos(kv_pos, table)
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2)
    mask = ((pos[:, None, :] >= 0)
            & (pos[:, None, :] <= q_pos[:, :, None]))[:, None]
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), flush=flush)


def kernel_phase(flush):
    import torch
    from repro_torch.kernels import kld_accept as kl
    from repro_torch.kernels import paged_attention as pa

    rows, b1_err = [], 0.0
    # |kernel - plain| <= atol + rtol * |plain|, elementwise: fp32 at the
    # reference's own kernel tolerance; in bf16 both sides accumulate in
    # fp32 and round once, so they may differ by one bf16 ulp (rtol) or
    # a few ulps near 0 (atol)
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
    peak = {torch.float32: FP32_FLOP_S, torch.bfloat16: BF16_FLOP_S}
    for dtype in (torch.float32, torch.bfloat16):
        for ctx in (256, 2048):
            for t in (1, 11):
                args, nbytes, flops = paged_case(4, t, ctx, dtype, seed=t + ctx)
                got = pa.paged_ragged_verify_attention_cuda(*args)
                want = pa.paged_ragged_verify_attention_plain(*args)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                atol, rtol = tol[dtype]
                if not bool((diff <= atol + rtol * want.float().abs()).all()):
                    raise AssertionError(f"paged attention {dtype} ctx={ctx} "
                                         f"t={t}: max abs err {err}")
                b1_err = max(b1_err, err)
                bound_ms, bound_by = bound(nbytes, flops, peak[dtype])
                row = {
                    "phase": "kernel", "name": "paged_ragged_verify_attention",
                    "dtype": str(dtype).replace("torch.", ""), "B": 4, "T": t,
                    "H": 9, "KV": 3, "D": 64, "BS": 16, "ctx": ctx,
                    "max_abs_err": err, "atol": atol, "rtol": rtol,
                    "ms": time_ms(lambda: pa.paged_ragged_verify_attention_cuda(*args),
                                  flush=flush),
                    "plain_ms": time_ms(lambda: pa.paged_ragged_verify_attention_plain(*args),
                                        flush=flush),
                    "library_ms": sdpa_ms(args, flush),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                emit(row)
                rows.append(row)

    # B2 at the round's shape: t_logits[:, :K] of [B, K+1, V], B*K = 40
    b, k, v = 4, 10, 49280
    g = torch.Generator(device="cpu").manual_seed(5)
    tl = (torch.randn(b, k + 1, v, generator=g) * 3).cuda()
    dl = (torch.randn(b, k, v, generator=g) * 3).cuda()
    tok = torch.randint(0, 49152, (b, k), generator=g, dtype=torch.int32).cuda()
    got = kl.fused_kld_accept_cuda(tl[:, :k], dl, tok)
    want = kl.kld_accept_plain(tl[:, :k], dl, tok)
    torch.cuda.synchronize()
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
    b2 = {"phase": "kernel", "name": "fused_kld_accept", "dtype": "float32",
          "rows": b * k, "V": v, "max_abs_err": b2_err,
          "p_q_max_rel_err": b2_rel, **b2_tol,
          "ms": time_ms(lambda: kl.fused_kld_accept_cuda(tl[:, :k], dl, tok),
                        flush=flush),
          "plain_ms": time_ms(lambda: kl.kld_accept_plain(tl[:, :k], dl, tok),
                              flush=flush),
          "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(b2)
    # the contract row for B1: the draft-step shape of the serve phase
    # (T = 1, max_seq_len 256 -> 16 logical blocks), float32
    b1 = next(r for r in rows if r["dtype"] == "float32" and r["T"] == 1
              and r["ctx"] == 256)
    return dict(b1, max_abs_err=b1_err), b2


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.kernels import kld_accept as kl
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    cfg = get_config("smollm-135m")
    pt = init_params(cfg, seed=0, device="cuda")
    noise = init_params(cfg, seed=1, device="cuda")
    pd = map_params(lambda a, n: a + 0.03 * n, pt, noise)
    serving = ServingConfig(max_batch_size=4, max_seq_len=256,
                            kv_block_size=16,
                            num_kv_blocks=4 * (256 // 16) // 2)  # 50% of dense
    rng = np.random.RandomState(0)
    reqs = [Request(i, prompt=rng.randint(0, cfg.vocab_size,
                                          size=rng.randint(6, 21)).tolist(),
                    max_new_tokens=32) for i in range(8)]
    def engine():
        return ServingEngine(pt, cfg, pd, cfg, SpecDecodeConfig(policy="dsde"),
                             serving, seed=0, device="cuda")

    # one-time set-up (library handles, allocator pools) outside the
    # measured run
    engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
    eng = engine()
    pa.LAUNCHES["paged_ragged_verify_attention"] = 0
    kl.LAUNCHES["fused_kld_accept"] = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    m = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"paged_ragged_verify_attention":
                pa.LAUNCHES["paged_ragged_verify_attention"],
                "fused_kld_accept": kl.LAUNCHES["fused_kld_accept"]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the serving path: {launches}")
    if m["requests_finished"] != 8 or any(len(r.output) != 32 for r in reqs):
        raise AssertionError(f"serve did not finish every request: {m}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("a token outside the vocabulary was emitted")
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "requests": len(reqs), "rounds": m["rounds"],
          "tokens": m["tokens_emitted"], "preemptions": m["preemptions"],
          "mean_acceptance": m["mean_acceptance"],
          "block_efficiency": m["block_efficiency"], "wall_s": wall,
          "tokens_per_s": m["tokens_emitted"] / wall,
          "draft_steps": m["draft_steps"], "launches": launches,
          "tf32": False})
    profile_phase(engine, reqs)

    # the same path at the reduced width: card (kernels) vs CPU (plain)
    small = cfg.reduced()
    p_small = init_params(small, seed=2, device="cpu")
    d_small = map_params(lambda a, n: a + 0.03 * n, p_small,
                         init_params(small, seed=3, device="cpu"))
    outs = {}
    for device in ("cuda", "cpu"):
        rs = [Request(i, prompt=list(range(3 + i, 12 + 2 * i)),
                      max_new_tokens=24) for i in range(4)]
        ServingEngine(p_small, small, d_small, small,
                      SpecDecodeConfig(policy="dsde"),
                      ServingConfig(max_batch_size=2, max_seq_len=128,
                                    kv_block_size=16, num_kv_blocks=8),
                      device=device).run(rs)
        outs[device] = [r.output for r in rs]
    same = outs["cuda"] == outs["cpu"]
    emit({"phase": "check", "what": "reduced-width greedy streams, card vs CPU",
          "requests": 4, "equal": same})
    if not same:
        raise AssertionError(f"card and CPU streams differ: {outs}")
    return launches


def profile_phase(engine, reqs) -> None:
    """The first four requests again, for their prefill and first six
    rounds, under ``torch.profiler``: device kernel time against the
    run's wall (the device's busy share) and the kernels that take it.
    A separate run, so the serve's tokens/s above carries no tracing
    cost; kept short because the trace is processed on the host."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "requests": len(again), "rounds": eng.rounds,
          "wall_s": wall, "device_kernel_s": device_us / 1e6,
          "device_busy_share": device_us / 1e6 / wall,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all

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

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    b1, b2 = kernel_phase(flush)
    del flush
    launches = serve_phase()

    sources = {
        "paged_ragged_verify_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/ragged_attention.py:189"),
        "fused_kld_accept": ("src/repro_torch/csrc/kld_accept.cu",
                             "src/repro/kernels/kld_accept.py:99"),
    }
    kernels = []
    for row in (b1, b2):
        src, replaces = sources[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[row["name"]],
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
