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
             peak for the way they run, whichever is larger: the
             attention kernels' bf16 q at 989 TFLOP/s, fp32 q as 3xTF32
             at 495/3 TFLOP/s, or 495/2 against int8 K/V; B2 and B3 at
             67 TFLOP/s, fp32 outside the tensor cores); then an empty
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
             twin's greedy streams.  Then (in the side processes, below)
             some serves again under ``torch.profiler`` for a few rounds
             (device busy share, top kernels, the port's own kernels
             and host calls), and the paths at the reduced width on the
             card and on the CPU (plain versions) must emit the same
             greedy streams (the fp32 and int8 pools also at SL 16,
             verify passes past one launch of B1 and B4; adaedl,
             goodput and slo on the fp32 pool, goodput x n-gram on the
             int8 pool, the self drafter on the pool and the ring).
4a. loadgen — (in the default run the ``examples`` side process's first
             work, below) the full-width trace replay (``LOADGEN_TRACE``):
             smollm-135m at 30 layers behind ``examples.stream_serving``'s
             engine (the fp32 pool in blocks of 16, pipelined, dsde,
             batch 4, 256 tokens), a seeded bursty trace of 16 requests
             at 4 requests/s (``repro_torch.serving.loadgen``) replayed
             open loop through the ``ServingFrontend``'s driver thread:
             the report's TTFT and TPOT p50 / p99, queue depth,
             throughput, goodput and SLO attainment; then
             ``replay_at_zero`` of the same trace, whose streams must
             equal ``run()``'s; B1 and B2 must launch in both replays and
             ``dispatch`` make no synchronising call.
4b. mesh   — the serving engine on a (data, model) mesh (ROADMAP A10;
             it runs after the frontdoor phase, 5): smollm-135m at full
             width, each serve's 8 requests and prompts those of its
             unmeshed twin in the serve phase (``MESH_TWINS``);
             ``mesh-1x1-nccl``: a real NCCL communicator of one rank in
             this process, its all-reduce and all-gather enqueued with 0
             synchronising calls, then the fp32 pool and the dense ring
             served (a group of one rank launches no collective), and
             the frontdoor phase's fp32 warm serve at its depth (prefix
             caching: equal streams, hits and COW copies, B1 launched
             by the tail prefills), dispatch making 0 synchronising
             calls;
             ``mesh-1x3-shared`` and ``mesh-2x2-shared``: 3 and 4 ranks
             (``--mesh-rank``, processes of this script started after the
             build; both worlds and the launcher at once) sharing card 0
             over gloo, the first
             ``MESH_SHARED_LAYERS`` layers against unmeshed twins of that
             depth, on the fp32 pool, the ring (synchronous and
             pipelined) and n-gram x int8; each rank's streams must equal
             its twin's (a parted stream prints its position and the
             unmeshed target's top-2 logit margin there), each row prints
             tok/s, rounds, collectives a round and every rank's dispatch
             syncs; the ranks' kernel launches join the kernels line;
             the 2 x 2 world also serves the front door
             (``MESH_FRONTDOOR``: the fp32 and damped n-gram x int8
             warm serves, equal hits and COW copies too; the front-end's
             driver thread with staggered arrivals, pipelined, every
             token once and in order; one non-streaming and one
             streaming HTTP completion on rank 0 over loopback; rank 0
             leads, the others follow it), each against a twin of its
             depth; ``mesh-launcher``: ``torchrun --nproc-per-node 1 -m
             repro_torch.launch.serve --mesh 1x1`` with ``--demo``,
             ``--http-smoke`` and ``--demo --paged --prefix-share 0.5``
             (``MESH_LAUNCHERS``) must exit 0 and print its result.
4c. mesh-families — every non-dense family on the mesh (its world and
             launcher run beside the mesh phase's, their twins served
             before either starts; ``--only mesh-families`` runs it
             alone):
             granite-moe-3b-a800m on the ring (each data rank gathers
             the call's rows to route them), mamba2-130m on the ring,
             recurrentgemma-2b on the pool (a local-attention layer and
             two RG-LRU layers; its draft's D-320 attention too),
             qwen2-vl-2b on the pool and seamless-m4t-medium on the ring
             (its empty encoder context), at full width and the depths
             of ``MESH_FAMILY_LAYERS``, each first on one card (the
             twins), then on 2 x 2 ranks sharing card 0 over gloo
             (``--mesh-family-rank``) beside the launcher's ``--demo
             --mesh 1x1`` of mamba2-130m under torchrun; each rank's
             streams must equal its twin's with 0 synchronising calls
             in dispatch, each row prints tok/s meshed and twin,
             collectives a round and the ranks' launches, which join
             the kernels line.  ``--only mesh-witness`` (a measurement,
             not in the default run): the damped n-gram x int8 serve at
             all 30 layers on one card and on 1 x 3 ranks sharing the
             card, every K/V quantization recorded; prints where one
             card's int8 streams part from the fp32 greedy rollout,
             where the meshed streams part from one card's, and up to
             that round the first fp32 gap, the first int8 value apart
             (its quanta, its distance from the rounding boundary) and
             the cascade after them.
5. frontdoor — the serving front door at smollm-135m full width, 10 of
             its 30 layers (``FRONTDOOR_LAYERS``):
             prefix caching (``WARM_SERVES``: a 512-token head seeded by
             one request, then a partial hit with a 100-token tail, the
             head alone, a full block-aligned repeat that forks a block
             copy-on-write, and a cold outlier) with the model drafter on
             the fp32 and int8 pools and the n-gram drafter on the int8
             pool, each run warm and cold: equal streams, hits and one
             COW copy or more, B1 or B4 launched by the tail prefills
             (their widths and query-group launches printed), 0
             synchronising calls in ``dispatch``, warm beside cold TTFT;
             card == CPU warm streams at the reduced width
             (``WARM_CHECKS``, one under forced preemption); the
             ``ServingFrontend`` on the dense ring and on the fp32 pool
             with caching (replay at arrival 0, and the threaded driver
             with staggered arrivals, synchronous and pipelined, each
             equal to ``run()``, each token once and in order); one
             streaming and one non-streaming HTTP completion over a
             loopback socket, equal to ``run()``; and the launcher
             ``repro_torch.launch.serve`` (``--http-smoke``, ``--demo
             --paged --prefix-share 0.5``) in subprocesses, which must
             exit 0.
6. families — the dense remainder and the MoE family
             (``FAMILY_SERVES``): granite-moe-3b-a800m (32 layers, d
             1536, 24/8 heads, 40 experts top-8, expert d_ff 512) at
             full width on the fp32 pool, the dense ring, the pipelined
             pool (streams equal to the synchronous pool's) and with the
             damped n-gram drafter on the int8 pool, and granite-8b (36
             layers, d 4096, 32/8 heads, D 128, untied head) on the fp32
             pool, each target's ``draft()`` as the model drafter, the
             weights drawn on a card generator (seconds, where a CPU
             generator would take a minute for 8.25e9 normals); each
             target's decode step and verify pass timed against its
             weight bytes (the attention launches of one pass counted:
             two a layer for granite-8b's T 11 verify); the MoE serve
             profiled; then ``FAMILY_CHECKS`` at reduced width, card ==
             CPU streams on the pool and the ring: qk norm, qkv bias,
             untied head, KV- and query-head padding, MoE batches that
             overflow an expert (granite-moe, mixtral with its window;
             some of the card's MoE calls must drop pairs), and D 128 at
             static SL 10 (44 query rows a KV head: two launches).  The
             kernel phase adds B1, B4 and B5 at granite-8b's heads (H 32
             / KV 8 / D 128).
7. recurrent — the ssm and hybrid families (``RECURRENT_SERVES``):
             mamba2-130m (24 layers, d 768, 24 SSD heads x 64, state 128,
             chunk 256, vocab 50280 padded to 50304) at full width on the
             dense ring with its ``draft()`` as the model drafter,
             synchronous and pipelined (equal streams), and with the
             damped n-gram drafter; recurrentgemma-2b (26 layers: 8 local
             attention, 18 RG-LRU; d 2560, H 10 / KV 1 / D 256, window
             2048, vocab 256000 padded to 256128) with its ``draft()`` (D
             320) on the fp32 pool and the dense ring, weights drawn on a
             card generator; each serve's kernels must launch and
             ``dispatch`` must not synchronise; recurrentgemma-2b again
             on the ring with rows of 2030-2040 + 48 tokens, which the
             window 2048 masks and the 2064-slot ring wraps under; one
             decode step, one verify pass and one commit re-advance of
             each target timed against the weight bytes (the
             re-advance's share of verify + re-advance printed), and
             each serve's commits timed inside its rounds (their device
             ms and share of the serve's wall); the dsde serves
             profiled; then ``RECURRENT_CHECKS``: card ==
             CPU greedy streams at reduced width (ssm on the ring, sync
             and pipelined; a 5-layer hybrid on the pool, on a ring of 80
             slots that wraps, and on a pool that forces preemption).
             The kernel phase adds B1 and B5 at the hybrid's heads (D 256
             and 320, ctx / W 256 and 2064; one launch a call up to 128
             query rows a KV head) and B2 at V 256128.
8. multimodal — the vlm and audio families (``MULTIMODAL_SERVES``):
             qwen2-vl-2b (28 layers, d 1536, H 12 / KV 2 / D 128, qkv
             bias, M-RoPE, vocab 151936 padded to 152064) at full width
             on the fp32 pool, the int8 pool, the dense ring and the
             pipelined pool (streams equal to the pool's), its draft
             over one KV head (``serve_draft``: the reference's own
             draft, H 3 over KV 2, cannot group its heads);
             seamless-m4t-medium (12 encoder + 12 decoder layers, d
             1024, 16 MHA heads of D 64, vocab 256206 padded to 256256)
             on the ring with its ``draft()``, served as the reference's
             engine serves it, with an empty encoder context; each
             target's decode step and verify pass timed against the
             weight bytes it reads; vlm-serve and audio-serve profiled;
             the vision stub at full width (a 16 x 16 patch grid and 32
             text tokens, B 4, M-RoPE positions, prefilled into the pool,
             then T 1 and T 11 decode steps through B1); the
             encoder-conditioned round (B 4 x 128 frames encoded into the
             target ring of ``init_round_state(enc_len=128)``, a 16-token
             prompt, 8 ``spec_decode_round`` calls driven directly; the
             encode, a decode step and a verify pass timed against the
             weights each reads); then ``MULTIMODAL_CHECKS``, card == CPU
             at reduced width (streams on the pool, int8 pool, ring,
             pipelined pool and the audio ring; the image path's and the
             encoder-conditioned round's logits within 1e-4 and tokens
             equal).  The kernel phase adds B1, B4 and B5 at the vlm's
             heads (H 12 / KV 2 / D 128, and the draft's H 3 / KV 1), B5
             at the audio decoder's (H 16 / KV 16 / D 64, and H 4 / KV
             4), and B2 at V 152064 and 256256.
9. train   — training on the card (``repro_torch.training``), then a
             trained pair served through the DSDE round: the entry point
             ``repro_torch.launch.train --demo`` for 60 steps (its loss
             must fall and its checkpoint restore); smollm-135m at full
             width, B 8 x S 512 with remat, 20 steps through
             ``train_loop`` (ms a step past the first 3, tokens/s, peak
             memory, the 6N FLOP share of 67 TFLOP/s; the loss must
             fall); ``train_step`` on the card against the CPU at the
             reduced width (loss 1e-4, params 1e-4, the first grad norm
             2e-3); then the reference benchmark's draft/target pair
             (``repro_torch.workloads``, the copy of
             ``benchmarks/common.build_pair("llama")``'s recipe: four
             Markov corpora, target 1600 steps, draft 1000) trained on
             the card from seeded inits (by the ``train`` side process,
             below, into ``workloads``' cache, where the examples find
             it), each final loss within 5% of the reference's, and
             served on code and on dialogue prompts with
             ``workloads.serve``'s settings (``PAIR_SERVES``: the model
             drafter under static SL 4 and dsde on the fp32 pool, dsde
             on the dense ring, the undamped n-gram drafter on the int8
             pool): the path's kernels must launch, dispatch must not
             synchronise, the model drafter must accept well on code and
             better than on dialogue, and the CPU (plain kernels) must
             emit the card's streams for the pool dsde and n-gram serves.
             Then the other families (``FAMILY_TRAINS``): qwen2-vl-2b,
             seamless-m4t-medium (with 128 encoder frames a row) and
             mamba2-130m at full width, recurrentgemma-2b reduced, 10
             steps of B 4 x S 512 each (the loss must fall), and each
             one's first step card == CPU at the reduced width; the
             blockwise attention (``flash_attend``) against ``attend`` at
             smollm's heads, T 2048 and 4096 (forward + backward ms, peak
             memory, differences); smollm-135m at B 2 x S 2048 for 5
             steps through it.
11. examples — the paper pipeline's entry points
             (``repro_torch.examples``, ``EXAMPLES``), each ``main`` on the
             card as a user runs it: ``quickstart``, ``serve_dynamic_sl
             --smoke`` with ``--drafter ngram --kv-quant int8`` and with
             ``--prefix-share 0.5``, then on the trained llama pair (the
             train phase's, through ``workloads``' cache)
             ``serve_dynamic_sl`` (six policies, slo == dsde, sync ==
             pipelined), ``stream_serving`` (streamed tokens == each
             output, the open-loop replay, replay at arrival 0 ==
             ``run()``), ``train_draft_model`` (40 / 120 / 250 steps) and
             ``low_acceptance_regime`` (static-opt, dsde and adaedl on
             both pairs; the gemma draft trained on the card, its loss
             within 5% of the reference's).  Each run prints what the
             example printed, then its serves' rounds, acceptance and
             latency units, its dispatch syncs (must be 0) and launches;
             B1-B5 must each launch in the phase.  In the default run it
             is the ``examples`` side process, below.

10. dryrun — the dry run (``repro_torch.launch.dryrun``, ROADMAP A11):
             smollm-135m x decode_32k, granite-8b x train_4k and
             qwen3-32b x decode_32k on the 16 x 16 fake mesh, each
             record's per-device FLOPs, bytes, collectives, memory and
             roofline (predictions on the H100 SXM's data-sheet
             figures); then the one-card check (``ONE_CARD_STEPS``):
             each step predicted on a 1 x 1 mesh and run for real at
             full width in bf16 (smollm-135m and granite-8b decode B 4
             on a ring of 2048, verify T 11, prefill B 4 x 512;
             smollm-135m train B 4 x 512): FLOPs outside the kernels
             (``FlopCounterMode``), kernel calls and argument bytes must
             equal the prediction's and the peak be within 15% of
             ``max_memory_allocated``; each prints its median ms and
             roofline share.

The default run gives what times nothing the script reports as the
card's rate to three processes of this script (``--side DUTY DIR``, 2
CPU threads each, DIR also their temporary directory) that start after
the kernel phase and run beside the others: ``train``, the train
phase's corpus and pair training, then every profile; ``checks``, the
reduced-width card == CPU checks of the serve, frontdoor, families,
recurrent and multimodal phases; ``examples``, the examples phase
(11), whose trained-pair runs wait for the ``train`` process's pair.
The main process loads the corpus from DIR and the pair from the run's
fresh ``workloads`` cache (``REPRO_TORCH_BENCH_CACHE`` under
``build/``) when its train phase needs them (``side-file``: the seconds
it waited), stops the side processes while the shared-card mesh worlds
run (``side-pause``; never inside the pair's training, a profiled run
or ``stream_serving``'s timed arrivals), and relays their rows at the
end (``"process": "side-train"`` / ``"side-checks"`` /
``"side-examples"``), after each one's ``side-wait``; the examples'
launches join the kernels line.  Every phase row carries ``t``, the
seconds since its process started.

It ends with the script's seconds so far, the kernels line, the
``nvidia-smi`` line and the result line ``{"ok": true, "device":
{...}}``.  Any failure raises and exits
non-zero; without CUDA, or without the port beside it, it prints no
result.

    python3 chip_smoke.py --only multimodal,flash

runs only the named phases (``ONLY``) after the build, with no result
line.

    python3 chip_smoke.py --serve-ab PARENT

runs smollm-135m's ``serve`` at 32 tokens a request (the earlier depth
of the full serves, ``SERVE_AB_NEW``) on PARENT's package and this tree's in
turns, parent, change, change, parent, each in its own process, three
timed runs each: tokens/s and ``host_blocked_s`` (rows ``serve-ab``).
It prints no result line.

    python3 chip_smoke.py --ab PARENT

runs a kernel A/B instead: the device and build phases, then this
file's kernel phase on the kernels of PARENT (another checkout, e.g.
unpacked with ``git archive``) and on this tree's in turns, parent,
change, change, parent, each in its own process on this card (rows
tagged ``ab_run`` and ``tree``; one timing harness for both trees; rows
of features the parent lacks are left out of its runs), and ptxas's
report of both trees' ``AB_PTXAS_SOURCES``.  It prints no result line.
"""
import collections
import contextlib
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
TF32_FLOP_S = 495e12         # H100 SXM tf32 tensor cores, dense
BF16_FLOP_S = 989e12         # H100 SXM bf16 tensor cores, dense
# the n-gram serve's target: residual output projections scaled by this
NGRAM_DAMP = 2e-4


# every phase row carries ``t``: the seconds since its process started
T_START = time.monotonic()


def emit(obj) -> None:
    if "phase" in obj and "t" not in obj:
        obj = {**obj, "t": round(time.monotonic() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def timed_phase(name: str, fn, *args):
    """``fn(*args)``, then a row of the seconds it took (where the
    script's time goes)."""
    t0 = time.monotonic()
    out = fn(*args)
    emit({"phase": name + "-seconds", "seconds": time.monotonic() - t0})
    return out


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


def attention_flop_s(dtype, int8_kv: bool = False) -> float:
    """The peak an attention kernel's operations count at (B1, B4, B5
    compute on the tensor cores, csrc/paged_verify.cuh): bf16 q at the
    bf16 rate; fp32 q as 3xTF32, three TF32 products for one fp32
    product, or two where the other operand is int8 K/V (exact in TF32,
    one term), so the TF32 rate over 3 or 2.  Both are above the
    67 TFLOP/s of fp32 outside the tensor cores."""
    import torch
    if dtype == torch.bfloat16:
        return BF16_FLOP_S
    return TF32_FLOP_S / (2 if int8_kv else 3)


def attended(kv_pos, q_pos, window=None) -> int:
    """(query, slot) pairs a causal attention call computes: for each
    row's query, the slots holding a position at or before it (and, with
    a window, within it) (``kv_pos [B, S]`` per row, -1 empty; ``q_pos
    [B, T]``)."""
    ok = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        ok = ok & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return int(ok.sum())


def paged_case(b, t, ctx, dtype, seed, heads=(9, 3, 64)):
    """A full-context paged attention call: every row holds ``ctx``
    committed positions in scattered blocks, queries at the last ``t``;
    ``heads`` = (query heads, KV heads, head dim).  Operations: each
    query against the positions at or before it (:func:`attended`)."""
    import torch
    (h, kv, d), bs = heads, 16
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
    row_pos = torch.arange(ctx, dtype=torch.int32)[None].repeat(b, 1)
    flops = 4 * h * d * attended(row_pos, q_pos)
    return args, nbytes, flops


def quant_case(b, t, ctx, dtype, seed, heads=(9, 3, 64)):
    """:func:`paged_case` over an int8 pool: the same tables, the K/V
    quantized on the card (one scale per stored vector), q in ``dtype``.
    Bytes: the int8 K/V and fp32 scales of ``ctx`` slots per row, plus
    kv_pos, the table, q_pos, q and out."""
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, pk, pv, table, q_pos, kv_pos), _, flops = paged_case(
        b, t, ctx, torch.float32, seed, heads)
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


def sdpa_ms(q, k, v, pos, q_pos, flush, window=None) -> float:
    """``F.scaled_dot_product_attention`` over an already gathered
    per-sequence view ``k``/``v [B, S, KV, D]`` with the same mask: a
    yardstick, never called by the port.  Only the call is timed."""
    import torch
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.to(q.dtype).repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.to(q.dtype).repeat_interleave(g, dim=2).transpose(1, 2)
    mask = ((pos[:, None, :] >= 0)
            & (pos[:, None, :] <= q_pos[:, :, None]))
    if window is not None:
        mask = mask & (q_pos[:, :, None] - pos[:, None, :] < window)
    mask = mask[:, None]
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), flush=flush)


def attention_rows(flush):
    """B1 and B4 at draft-step (T 1) and verify (T 11) shapes, ctx 256
    and 2048, fp32 and bf16 q, then fp32 at ctx 64 (about what the
    serves' rows hold), then T 22 at ctx 256 (G * T 66: the wrapper cuts
    T into two launches), then a prefix-cache tail prefill's shapes, T 64
    and 128 at ctx 512, fp32 and bf16 (4 and 7 launches a call; each row
    says how many).  Each call is launched twice and must give the
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
    kernels = (
        # Both compute in q's type: int8 K/V are exact in bf16, so B4's
        # operations with bf16 q count at the bf16 peak, as B1's do, and
        # with fp32 q at two TF32 terms (:func:`attention_flop_s`).  The
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
        # a prefix-cache tail prefill: T 64 and 128 query positions after
        # the shared prefix, ctx 512 (4 and 7 launches a call at G 3)
        passes.append([(dtype, 512, t) for dtype in (torch.float32,
                                                      torch.bfloat16)
                       for t in (64, 128)])
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
            bound_ms, bound_by = bound(
                nbytes, flops, attention_flop_s(dtype, case is quant_case))
            k, v = gather(args)
            pos = gather_paged_pos(args[-1], args[-3])
            row = {
                "phase": "kernel", "name": name,
                "dtype": str(dtype).replace("torch.", ""), "B": 4,
                "T": t, "H": 9, "KV": 3, "D": 64, "BS": 16, "ctx": ctx,
                "GT": 3 * t,
                "launches_per_call": (len(pa.query_groups(9, 3, t, 64))
                                      if hasattr(pa, "query_groups") else 1),
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


def kld_row(flush, v=49280):
    """B2 at the round's shape: t_logits[:, :K] of [B, K+1, V], B*K = 40;
    V 49280 (smollm-135m's padded vocabulary), or ``v``
    (recurrentgemma-2b's 256128), each launched twice for the same
    bits."""
    import torch
    from repro_torch.kernels import kld_accept as kl
    b, k = 4, 10
    g = torch.Generator(device="cpu").manual_seed(5)
    tl = (torch.randn(b, k + 1, v, generator=g) * 3).cuda()
    dl = (torch.randn(b, k, v, generator=g) * 3).cuda()
    tok = torch.randint(0, v - 128, (b, k), generator=g,
                        dtype=torch.int32).cuda()
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


def ring_case(b, t, w, dtype, seed, wrap=False, fill=None, heads=(9, 3, 64)):
    """A dense-ring attention call: every row's ring full (positions 0 ..
    W-1, queries at the last ``t``), or with ``wrap`` rows that have run
    past W (slot j holds the latest position p = j mod W), or with
    ``fill`` (one count a row) rows holding positions 0 .. fill-1 in slots
    0 .. fill-1, the rest empty (-1), queries at the last ``t``.  Bytes:
    the K/V of the slots that hold a position, all W positions of
    kv_pos, q_pos, q and out; operations: each query against the slots
    holding a position at or before it (:func:`attended`)."""
    import torch
    h, kv, d = heads
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
    flops = 4 * h * d * attended(kv_pos, q_pos)
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
                bound_ms, bound_by = bound(nbytes, flops,
                                           attention_flop_s(dtype))
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


# granite-8b's attention: 32 query heads over 8 KV heads at head dim 128
D128_HEADS = (32, 8, 128)


def d128_rows(flush, heads=D128_HEADS, names=None, ctxs=(256, 2048),
              tag="d128"):
    """B1, B4 and B5 (or those of ``names``) at ``heads`` (H, KV, D),
    ctx / W in ``ctxs``; by default at granite-8b's head shape (H 32, KV
    8, D 128):
    draft step (T 1) and verify (T 11: G * T 44 query rows a KV head, past
    one launch's 32 at D 128, so the wrapper makes two launches a call),
    over ctx / W 256 and 2048 (full contexts and rings), fp32 and bf16;
    B1's tolerances, each call launched twice for the same bits.  The
    library yardstick is SDPA over the gathered view (B4: dequantized,
    untimed).  Returns each kernel's largest error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as pq
    from repro_torch.kernels import ragged_attention as ra
    from repro_torch.models.cache import (gather_paged_kv,
                                          gather_paged_kv_quant,
                                          gather_paged_pos)
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
    h, kv, d = heads
    # (name, case, kernel, plain, SDPA inputs: k, v, kv_pos view, q_pos)
    kernels = (
        ("paged_ragged_verify_attention", paged_case,
         pa.paged_ragged_verify_attention_cuda,
         pa.paged_ragged_verify_attention_plain,
         lambda a: (*gather_paged_kv(a[1], a[2], a[3]),
                    gather_paged_pos(a[-1], a[-3]), a[-2])),
        ("paged_ragged_verify_attention_quant", quant_case,
         pq.paged_ragged_verify_attention_quant_cuda,
         pq.paged_ragged_verify_attention_quant_plain,
         lambda a: (*gather_paged_kv_quant(*a[1:6]),
                    gather_paged_pos(a[-1], a[-3]), a[-2])),
        ("ragged_verify_attention", ring_case,
         ra.ragged_verify_attention_cuda, ra.ragged_verify_attention_plain,
         lambda a: (a[1], a[2], a[4], a[3])),
    )
    worst = {}
    for name, case, kernel, plain, view in kernels:
        if names is not None and name not in names:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            for ctx in ctxs:
                for t in (1, 11):
                    args, nbytes, flops = case(4, t, ctx, dtype, seed=t + ctx,
                                               heads=heads)
                    got = kernel(*args)
                    want = plain(*args)
                    again = kernel(*args)
                    torch.cuda.synchronize()
                    what = f"{name} {heads} {dtype} ctx={ctx} t={t}"
                    if not torch.equal(got, again):
                        raise AssertionError(f"{what}: two launches differ")
                    diff = (got.float() - want.float()).abs()
                    err = diff.max().item()
                    atol, rtol = tol[dtype]
                    if not bool((diff <= atol + rtol * want.float().abs()).all()):
                        raise AssertionError(f"{what}: max abs err {err}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    bound_ms, bound_by = bound(
                        nbytes, flops,
                        attention_flop_s(dtype, case is quant_case))
                    k, v, pos, q_pos = view(args)
                    emit({"phase": "kernel", "name": name, "shape": tag,
                          "dtype": str(dtype).replace("torch.", ""), "B": 4,
                          "T": t, "H": h, "KV": kv, "D": d,
                          ("W" if name == "ragged_verify_attention"
                           else "ctx"): ctx,
                          "GT": h // kv * t,
                          "launches_per_call": len(pa.query_groups(h, kv, t, d)),
                          "max_abs_err": err, "atol": atol, "rtol": rtol,
                          **kernel_ms(lambda: kernel(*args), flush),
                          "plain_ms": time_ms(lambda: plain(*args),
                                              flush=flush),
                          "library_ms": sdpa_ms(args[0], k, v, pos, q_pos,
                                                flush),
                          "bound_ms": bound_ms, "bound_by": bound_by})
    return worst


# recurrentgemma-2b's local attention (H 10 / KV 1 / D 256) and its
# draft's (H 2 / KV 1 / D 320)
WIDE_HEADS = ((10, 1, 256), (2, 1, 320))
# the hybrid's attention window and its full-width ring (window + 16)
HYBRID_WINDOW, HYBRID_RING = 2048, 2064


def wide_rows(flush):
    """B1 and B5 at the hybrid family's heads (``WIDE_HEADS``, the wide
    heads' tensor-core kernel): draft step (T 1) and verify (T 11: G * T
    110 query rows a KV head at G 10, one launch a call), ctx / W
    256 (full) and 2064 (B1: a full context, B5: a ring that has wrapped,
    both under the window 2048 the serves attend with), fp32 and bf16;
    B1's tolerances, each call launched twice for the same bits.  Bound:
    bytes, and the operations of the (query, slot) pairs inside the
    window at the card's peak for the operand type
    (:func:`attention_flop_s`, as every attention row).  SDPA over the
    same view and mask is the library yardstick.  Returns each kernel's
    largest error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_attention as ra
    from repro_torch.models.cache import gather_paged_kv, gather_paged_pos
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
    kernels = (
        ("paged_ragged_verify_attention", "ctx",
         lambda t, n, dt, sd, hd: paged_case(4, t, n, dt, sd, heads=hd),
         pa.paged_ragged_verify_attention_cuda,
         pa.paged_ragged_verify_attention_plain,
         lambda a: (*gather_paged_kv(a[1], a[2], a[3]),
                    gather_paged_pos(a[-1], a[-3]), a[-2])),
        ("ragged_verify_attention", "W",
         lambda t, n, dt, sd, hd: ring_case(4, t, n, dt, sd, heads=hd,
                                            wrap=n == HYBRID_RING),
         ra.ragged_verify_attention_cuda, ra.ragged_verify_attention_plain,
         lambda a: (a[1], a[2], a[4], a[3])),
    )
    worst = {}
    for name, size_key, case, kernel, plain, view in kernels:
        for h, kv, d in WIDE_HEADS:
            for dtype in (torch.float32, torch.bfloat16):
                for n in (256, HYBRID_RING):
                    for t in (1, 11):
                        args, nbytes, _ = case(t, n, dtype, t + n + d,
                                               (h, kv, d))
                        window = HYBRID_WINDOW if n == HYBRID_RING else None
                        got = kernel(*args, window=window)
                        want = plain(*args, window=window)
                        again = kernel(*args, window=window)
                        torch.cuda.synchronize()
                        what = f"{name} D{d} {dtype} {size_key}={n} t={t}"
                        if not torch.equal(got, again):
                            raise AssertionError(f"{what}: two launches "
                                                 "differ")
                        diff = (got.float() - want.float()).abs()
                        err = diff.max().item()
                        atol, rtol = tol[dtype]
                        if not bool((diff <= atol + rtol
                                     * want.float().abs()).all()):
                            raise AssertionError(f"{what}: max abs err {err}")
                        worst[name] = max(worst.get(name, 0.0), err)
                        k, v, pos, q_pos = view(args)
                        flops = 4 * h * d * attended(pos, q_pos, window)
                        bound_ms, bound_by = bound(nbytes, flops,
                                                   attention_flop_s(dtype))
                        emit({"phase": "kernel", "name": name,
                              "dtype": str(dtype).replace("torch.", ""),
                              "B": 4, "T": t, "H": h, "KV": kv, "D": d,
                              size_key: n, "window": window,
                              "wrapped": size_key == "W" and n == HYBRID_RING,
                              "GT": h // kv * t,
                              "launches_per_call": len(pa.query_groups(
                                  h, kv, t, d)),
                              "max_abs_err": err, "atol": atol, "rtol": rtol,
                              **kernel_ms(lambda: kernel(*args, window=window),
                                          flush),
                              "plain_ms": time_ms(
                                  lambda: plain(*args, window=window),
                                  flush=flush),
                              "library_ms": sdpa_ms(args[0], k, v, pos, q_pos,
                                                    flush, window),
                              "bound_ms": bound_ms, "bound_by": bound_by})
    return worst


# the multimodal families' attention shapes: (tag, (H, KV, D), kernels).
# qwen2-vl-2b's target (G 6 at D 128: a T 11 verify is three launches of
# <= 5 positions) on the pool, the int8 pool and the ring, and its served
# draft (H 3 / KV 1, :func:`serve_draft`) on the pool; seamless-m4t-medium's
# decoder self-attention (MHA, G 1 at D 64) and its draft's on the ring
MULTIMODAL_HEADS = (
    ("vlm", (12, 2, 128), ("paged_ragged_verify_attention",
                           "paged_ragged_verify_attention_quant",
                           "ragged_verify_attention")),
    ("vlm-draft", (3, 1, 128), ("paged_ragged_verify_attention",)),
    ("audio", (16, 16, 64), ("ragged_verify_attention",)),
    ("audio-draft", (4, 4, 64), ("ragged_verify_attention",)),
)
# qwen2-vl-2b's and seamless-m4t-medium's padded vocabularies
MULTIMODAL_VOCABS = (152064, 256256)


def multimodal_rows(flush):
    """B1, B4 and B5 at the multimodal families' heads
    (``MULTIMODAL_HEADS``, ctx / W 256: the serves' rows), fp32 and bf16,
    T 1 and 11, each against its plain version, launched twice for the
    same bits, timed against its bound and SDPA over the gathered view;
    then B2 at their vocabularies.  Returns each kernel's largest
    error."""
    worst = {}
    for tag, heads, names in MULTIMODAL_HEADS:
        for name, err in d128_rows(flush, heads, names, (256,), tag).items():
            worst[name] = max(worst.get(name, 0.0), err)
    for v in MULTIMODAL_VOCABS:
        worst["fused_kld_accept"] = max(worst.get("fused_kld_accept", 0.0),
                                        kld_row(flush, v=v)["max_abs_err"])
    return worst


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
    for name, err in d128_rows(flush).items():
        contract[name]["max_abs_err"] = max(contract[name]["max_abs_err"], err)
    for name, err in wide_rows(flush).items():
        contract[name]["max_abs_err"] = max(contract[name]["max_abs_err"], err)
    wide_kld = kld_row(flush, v=256128)
    contract["fused_kld_accept"]["max_abs_err"] = max(
        contract["fused_kld_accept"]["max_abs_err"], wide_kld["max_abs_err"])
    for name, err in multimodal_rows(flush).items():
        contract[name]["max_abs_err"] = max(contract[name]["max_abs_err"], err)
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
    """``params`` with the residual branches' output projections scaled
    by ``alpha`` (``attn.wo``, ``mlp.w_down``, the experts'
    ``moe.w_down``; an ssm layer's ``mixer.out_proj``; a hybrid layer's
    ``temporal.wo`` or ``temporal.w_out``, in its groups and its tail):
    every layer still runs at full width, but the token embedding stays
    large in the residual stream, so greedy streams run in repeats of a
    token, which the n-gram drafter's lookup finds."""
    if alpha == 1.0:
        return params
    outputs = {"attn": ("wo",), "mlp": ("w_down",), "moe": ("w_down",),
               "mixer": ("out_proj",), "temporal": ("wo", "w_out")}

    def scale(layer):
        return {sub: ({k: (v * alpha if k in outputs.get(sub, ()) else v)
                       for k, v in leaf.items()} if isinstance(leaf, dict)
                      else leaf)
                for sub, leaf in layer.items()}
    layers = params["layers"]
    if "tail" in layers:              # hybrid: (rec x bpa, attn) groups
        groups = layers.get("groups")
        layers = {"groups": (None if groups is None else
                             {k: scale(v) for k, v in groups.items()}),
                  "tail": tuple(scale(t) for t in layers["tail"])}
    else:
        layers = scale(layers)
    return dict(params, layers=layers)


# new tokens a request of every full-width serve (formerly 32; cut to 16
# to keep the script inside its time limit as it grew)
SERVE_NEW = 16


def serve_prompts(vocab, drafter):
    """8 requests (of ``SERVE_NEW`` new tokens each).  The n-gram
    serve's prompts repeat a seeded 8-token phrase 3 times before a
    random tail."""
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


def serve_weights(plan=None, layers=None):
    """smollm-135m at full width (``layers``: its first that many layers
    only): the target (seed 0) and the draft (target + 0.03 x a seed-1
    draw), drawn on the CPU generator, so that a mesh rank's shards
    (``plan``) are the whole draw's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params, map_params
    cfg = get_config("smollm-135m")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    pt = init_params(cfg, seed=0, device="cuda", plan=plan)
    noise = init_params(cfg, seed=1, device="cuda", plan=plan)
    return cfg, pt, map_params(lambda a, n: a + 0.03 * n, pt, noise)


def serve_engine(cfg, pt, pd, sv, mesh=None):
    """The engine of one ``Serve`` (batch 4, 256 tokens), on ``mesh``
    (a ``DeviceMesh`` or ``core.tp.MeshPlan``) or one card."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    model = sv.drafter == "model"
    serving = ServingConfig(max_batch_size=4, max_seq_len=256,
                            pipelined=sv.pipelined,
                            paged_kv=sv.nblocks is not None,
                            kv_block_size=16, num_kv_blocks=sv.nblocks,
                            kv_quant=sv.kv_quant)
    return ServingEngine(damped(pt, sv.damp), cfg, pd if model else None,
                         cfg if model else None,
                         SpecDecodeConfig(policy=sv.policy,
                                          drafter=sv.drafter,
                                          self_draft_layers=sv.self_layers),
                         serving, seed=0, device="cuda", mesh=mesh)


def serve_requests(cfg, sv, new=SERVE_NEW):
    from repro_torch.serving.request import Request
    return [Request(i, prompt=p, max_new_tokens=new,
                    slo_deadline_s=((0.05 if i % 2 else 60.0)
                                    if getattr(sv, "deadlines", False)
                                    else None))
            for i, p in enumerate(serve_prompts(cfg.vocab_size, sv.drafter))]


# greedy streams of the serve phase's serves, by name (the mesh phase's
# twins)
SERVE_STREAMS = {}


def serve_phase(profile=True):
    """The full-width serves of ``SERVES`` and (``profile``; the default
    run leaves them to the side processes) the ``PROFILED`` ones again
    under the profiler; returns the serves' launches."""
    import torch
    from repro_torch.serving.request import Request

    cfg, pt, pd = serve_weights()
    # every untraced measurement comes before the first profiled run, so
    # that none follows a torch.profiler session
    timed_phase("forward", forward_phase, cfg, pt)
    total = {k: 0 for k in read_launches()}
    profiled, streams = [], SERVE_STREAMS
    for sv in SERVES:
        def engine(sv=sv):
            return serve_engine(cfg, pt, pd, sv)

        reqs = serve_requests(cfg, sv)
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
        if m["requests_finished"] != 8 or any(len(r.output) != SERVE_NEW
                                              for r in reqs):
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
        if profile and sv.name in PROFILED:
            profiled.append((sv.name, engine, reqs))
    # dense and paged may sum attention in other orders, so random-weight
    # argmax streams may part at a near tie: printed, not required
    emit({"phase": "dense-vs-paged",
          "what": "full-width greedy streams, serve-dense vs serve",
          "equal": streams["serve-dense"] == streams["serve"],
          "requests_equal": sum(a == b for a, b in zip(streams["serve-dense"],
                                                       streams["serve"]))})
    for args in profiled:
        timed_phase("profile", profile_phase, *args)
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


# -- frontdoor phase -----------------------------------------------------
# The prefix cache's full-width serves: batch 1 seeds a 512-token head
# (32 blocks of 16); batch 2 holds a partial hit (a 100-token tail: T 128
# tail prefills, 7 launches a layer at G 3), the head alone (a full
# block-aligned repeat: a COW fork) and a cold outlier.  Each runs with
# prefix caching and without (the twin whose streams it must equal).
class WarmServe(NamedTuple):
    name: str
    drafter: str
    kv_quant: str
    damp: float
    path: Tuple[str, ...]


WARM_SERVES = (
    WarmServe("warm", "model", "none", 1.0,
              ("paged_ragged_verify_attention", "fused_kld_accept")),
    WarmServe("warm-int8", "model", "int8", 1.0,
              ("paged_ragged_verify_attention_quant", "fused_kld_accept")),
    WarmServe("warm-ngram-int8", "ngram", "int8", NGRAM_DAMP,
              ("ngram_suffix_propose", "paged_ragged_verify_attention_quant")),
)
WARM_HEAD = 512
WARM_NEW = 16


def warm_batches(vocab, head_len=WARM_HEAD, tails=(8, 100, 40)):
    import numpy as np
    rng = np.random.RandomState(5)
    head = rng.randint(0, vocab, size=head_len).tolist()
    return ([head + rng.randint(0, vocab, size=tails[0]).tolist()],
            [head + rng.randint(0, vocab, size=tails[1]).tolist(), list(head),
             rng.randint(0, vocab, size=tails[2]).tolist()])


def tail_prefill_counter():
    """Counts what the warm tail prefills launch: wraps
    ``prefill_paged_tail`` (the target's and a mirroring drafter's) and
    records each call's tail width and the attention kernels' query-group
    launches inside it.  Returns (the list of (width, launches), stop)."""
    from repro_torch.core import prefill as prefill_lib
    calls, orig = [], prefill_lib.prefill_paged_tail

    def counted(*args):
        seen, stop = count_query_launches()
        try:
            return orig(*args)
        finally:
            stop()
            calls.append((args[6].shape[1], sum(seen)))
    prefill_lib.prefill_paged_tail = counted

    def stop():
        prefill_lib.prefill_paged_tail = orig
    return calls, stop


def warm_by_name(name):
    return next(sv for sv in WARM_SERVES if sv.name == name)


def warm_run(cfg, pt, pd, sv, caching=True, mesh=None, new=WARM_NEW):
    """One run of the ``WarmServe`` ``sv`` (its two waves on one engine:
    batch 4, 1024 tokens, 128 blocks of 16), with prefix caching or
    without, on ``mesh`` (a ``DeviceMesh`` or ``core.tp.MeshPlan``) or
    one card: streams, wall, rounds, the prefix cache's totals, the tail
    prefills' widths and attention launches, collectives, dispatch syncs
    and kernel launches."""
    import torch
    from repro_torch.core import tp
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request, RequestState

    model = sv.drafter == "model"
    eng = ServingEngine(
        damped(pt, sv.damp), cfg, pd if model else None,
        cfg if model else None, SpecDecodeConfig(drafter=sv.drafter),
        ServingConfig(max_batch_size=4, max_seq_len=1024, paged_kv=True,
                      kv_block_size=16, num_kv_blocks=128,
                      kv_quant=sv.kv_quant, prefix_caching=caching),
        seed=0, device="cuda", mesh=mesh)
    syncs = count_syncs(eng)
    calls, stop = tail_prefill_counter()
    reset_launches()
    tp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = []
    try:
        for j, batch in enumerate(warm_batches(cfg.vocab_size)):
            rs = [Request(j * 100 + i, prompt=list(p), max_new_tokens=new)
                  for i, p in enumerate(batch)]
            m = eng.run(rs)
            reqs += rs
    finally:
        stop()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"streams": [r.output for r in reqs], "wall_s": wall,
            "rounds": m["rounds"], "tokens": m["tokens_emitted"],
            "finished": sum(r.state is RequestState.FINISHED for r in reqs),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefix_cache_hit_blocks": m["prefix_cache_hit_blocks"],
            "prefix_cache_hit_rate": m["prefix_cache_hit_rate"],
            "cow_copies": m["cow_copies"],
            "prefix_hit_rate_by_request": [r.prefix_hit_rate()
                                           for r in reqs],
            "tail_prefills": [{"T": w, "attention_launches": n}
                              for w, n in calls],
            "ttft_batch2_s": [r.ttft() for r in reqs[1:]],
            "collectives": dict(tp.COUNTS), "launches": read_launches(),
            "dispatch_syncs": sum(syncs.values()),
            "dispatch_sync_sources": dict(syncs)}


def check_warm(name, res, caching=True) -> None:
    """A warm run's own bars: every request finished; warm: hits, a COW
    copy, tail prefills that launched attention (a T-128 one among them
    at ``WARM_NEW``'s tails); cold: no tail prefill."""
    calls = res["tail_prefills"]
    if any(len(o) != len(res["streams"][0]) for o in res["streams"]) \
            or res["finished"] != len(res["streams"]):
        raise AssertionError(f"{name}: a request did not finish")
    if not caching:
        if calls:
            raise AssertionError(f"{name}: a cold run took the tail path")
        return
    if not (res["prefix_cache_hit_rate"] > 0 and res["cow_copies"] >= 1):
        raise AssertionError(f"{name}: no sharing: {res}")
    if not calls or min(c["attention_launches"] for c in calls) <= 0:
        raise AssertionError(f"{name}: the tail prefill launched no "
                             f"attention: {calls}")
    if max(c["T"] for c in calls) != 128:
        raise AssertionError(f"{name}: no T-128 tail: {calls}")


# the frontdoor phase's warm runs, by serve name (the mesh's twins)
WARM_RESULTS = {}


def warm_serves(cfg, pt, pd, smi):
    """``WARM_SERVES`` at full width, each warm and cold; returns the
    launches of the warm runs."""
    total = {k: 0 for k in read_launches()}
    for sv in WARM_SERVES:
        runs = {}
        for caching in (False, True):
            res = runs[caching] = warm_run(cfg, pt, pd, sv, caching)
            emit({"phase": "frontdoor-" + sv.name + ("" if caching
                                                      else "-cold"),
                  "arch": cfg.name, "layers": cfg.num_layers,
                  "drafter": sv.drafter, "kv_quant": sv.kv_quant,
                  "prefix_caching": caching, "head_tokens": WARM_HEAD,
                  **{k: res[k] for k in (
                      "prompt_lens", "rounds", "tokens",
                      "prefix_cache_hit_blocks", "prefix_cache_hit_rate",
                      "cow_copies", "prefix_hit_rate_by_request",
                      "tail_prefills", "ttft_batch2_s", "wall_s",
                      "dispatch_syncs", "dispatch_sync_sources",
                      "launches")},
                  "nvidia_smi": smi})
            if res["dispatch_syncs"]:
                raise AssertionError(f"{sv.name}: dispatch synchronised: "
                                     f"{res['dispatch_sync_sources']}")
            if min(res["launches"][k] for k in sv.path) <= 0:
                raise AssertionError(f"{sv.name}: a kernel of the path never "
                                     f"ran: {res['launches']}")
            check_warm(sv.name, res, caching)
        for k in total:
            total[k] += runs[True]["launches"][k]
        WARM_RESULTS[(sv.name, cfg.num_layers)] = runs[True]
        equal = runs[True]["streams"] == runs[False]["streams"]
        emit({"phase": "frontdoor-ttft", "serve": sv.name,
              "what": "batch 2 (partial hit, aligned repeat, outlier): "
                      "TTFT s, warm beside cold (not judged)",
              "warm": runs[True]["ttft_batch2_s"],
              "cold": runs[False]["ttft_batch2_s"], "equal": equal})
        if not equal:
            raise AssertionError(f"{sv.name}: warm streams differ from cold: "
                                 f"{runs}")
    return total


# card == CPU warm streams at the reduced width: (drafter, pool, policy,
# block size, pool blocks, max new tokens, shared head, tails); the
# first forces preemption (16 blocks of 8)
WARM_CHECKS = (
    ("model", "none", "dsde", 8, 16, 40, 24, (6, 3, 1)),
    ("model", "int8", "static", 16, None, 10, 40, (6, 5, 0, 9)),
    ("ngram", "int8", "dsde", 16, None, 10, 40, (6, 5, 0, 9)),
)


def warm_check_phase(cfg) -> None:
    """The prefix cache at the reduced width, card (kernels) vs CPU
    (plain versions): equal warm greedy streams, equal sharing."""
    import numpy as np
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    small = cfg.reduced()
    p_small = init_params(small, seed=2, device="cpu")
    d_small = map_params(lambda a, n: a + 0.03 * n, p_small,
                         init_params(small, seed=3, device="cpu"))
    for drafter, kv_quant, policy, bs, nblocks, new, head_len, tails \
            in WARM_CHECKS:
        rng = np.random.RandomState(11)
        head = rng.randint(0, small.vocab_size, size=head_len).tolist()
        prompts = [head[:32] if t == 0 else head + rng.randint(
            0, small.vocab_size, size=t).tolist() for t in tails]
        if nblocks is None:           # seed, then hit (incl. aligned repeat)
            batches = (prompts[:1], prompts[1:])
        else:
            batches = (prompts,)
        model = drafter == "model"
        got = {}
        for device in ("cuda", "cpu"):
            eng = ServingEngine(
                p_small, small, d_small if model else None,
                small if model else None,
                SpecDecodeConfig(policy=policy, drafter=drafter),
                ServingConfig(max_batch_size=2, max_seq_len=128,
                              paged_kv=True, kv_block_size=bs,
                              num_kv_blocks=nblocks, kv_quant=kv_quant,
                              prefix_caching=True), device=device)
            outs = []
            for j, batch in enumerate(batches):
                rs = [Request(j * 100 + i, prompt=list(p), max_new_tokens=new)
                      for i, p in enumerate(batch)]
                m = eng.run(rs)
                outs += [r.output for r in rs]
            got[device] = (outs, m["prefix_cache_hit_blocks"], m["cow_copies"],
                           m["preemptions"])
        same = got["cuda"] == got["cpu"]
        emit({"phase": "frontdoor-check",
              "what": "reduced-width warm greedy streams, card vs CPU",
              "drafter": drafter, "kv_quant": kv_quant, "policy": policy,
              "block_size": bs, "pool_blocks": nblocks,
              "hit_blocks": got["cuda"][1], "cow_copies": got["cuda"][2],
              "preemptions": got["cuda"][3], "equal": same})
        if not same or got["cuda"][1] <= 0:
            raise AssertionError(f"warm check ({drafter}, {kv_quant}): "
                                 f"{got}")
        if nblocks is not None and got["cuda"][3] <= 0:
            raise AssertionError("warm check: no preemption")


def frontdoor_engine(cfg, pt, pd, paged=True, pipelined=True, mesh=None):
    """The front-end's and the HTTP server's engine: the model drafter,
    batch 4, 256 tokens, on the dense ring or on 32 blocks of 16 with
    prefix caching; on ``mesh`` or one card."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(
        pt, cfg, pd, cfg, SpecDecodeConfig(),
        ServingConfig(max_batch_size=4, max_seq_len=256, pipelined=pipelined,
                      paged_kv=paged, kv_block_size=16,
                      num_kv_blocks=32 if paged else None,
                      prefix_caching=paged), seed=0, device="cuda", mesh=mesh)


def frontdoor_prompts(vocab):
    """The front-end's 6 prompts: a 64-token head and tails of 5-30."""
    import numpy as np
    rng = np.random.RandomState(7)
    head = rng.randint(0, vocab, size=64).tolist()
    return [head + rng.randint(0, vocab, size=n).tolist()
            for n in (9, 20, 5, 14, 30, 11)]


def http_prompt(vocab):
    import numpy as np
    return np.random.RandomState(9).randint(0, vocab, size=40).tolist()


def frontend_runs(cfg, pt, pd, smi):
    """The front-end at full width on the dense ring and on the fp32 pool
    with prefix caching: replay at arrival 0 (``run_until_drained``) ==
    ``run()``; the threaded driver with staggered arrivals, synchronous
    and pipelined, gives the same streams; every token arrives once, in
    order (each handle's events rebuild ``request.output``).  Returns
    the launches of the replays and the threaded runs."""
    import torch
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import Request

    prompts = frontdoor_prompts(cfg.vocab_size)
    total = {k: 0 for k in read_launches()}
    for layout in ("dense", "pool-cached"):
        paged = layout != "dense"

        def engine(pipelined):
            return frontdoor_engine(cfg, pt, pd, paged, pipelined)

        def reqs():
            return [Request(i, prompt=list(p), max_new_tokens=12)
                    for i, p in enumerate(prompts)]

        want = reqs()
        engine(False).run(want)
        want = [r.output for r in want]
        row = {"phase": "frontdoor-frontend", "layout": layout,
               "arch": cfg.name, "requests": len(prompts), "nvidia_smi": smi}
        for mode in ("replay", "threaded-sync", "threaded-pipelined"):
            eng = engine(mode == "threaded-pipelined")
            reset_launches()
            t0 = time.monotonic()
            fe = ServingFrontend(eng)
            if mode == "replay":
                syncs = count_syncs(eng)
                handles = [fe.submit_request(r) for r in reqs()]
                fe.run_until_drained()
                row["replay_dispatch_syncs"] = sum(syncs.values())
            else:
                fe.start()
                handles = []
                for r in reqs():
                    handles.append(fe.submit_request(r))
                    time.sleep(0.05)           # staggered arrivals
                if not fe.wait_idle(timeout=300):
                    raise AssertionError(f"{layout} {mode}: not idle")
                fe.stop()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            results = [h.result(timeout=5) for h in handles]
            streams = [toks for toks, _ in results]
            once = all(toks == h.request.output
                       for (toks, _), h in zip(results, handles))
            launches = read_launches()
            m = fe.summary()
            row[mode] = {"equal_to_run": streams == want,
                         "tokens_once_in_order": once,
                         "finish_reasons": sorted({r for _, r in results}),
                         "wall_s": wall, "ttft_mean_s": m["ttft_mean_s"],
                         "prefix_cache_hit_blocks":
                             m["prefix_cache_hit_blocks"],
                         "launches": launches}
            if streams != want or not once:
                raise AssertionError(f"front-end {layout} {mode}: streams "
                                     f"differ from run(): {streams} {want}")
            for k in total:
                total[k] += launches[k]
        emit(row)
        if row["replay_dispatch_syncs"]:
            raise AssertionError(f"front-end {layout}: dispatch synchronised")
    return total


def http_runs(cfg, pt, pd, smi) -> None:
    """HTTP over a real loopback socket at full width (the fp32 pool with
    prefix caching, pipelined): one non-streaming and one streaming
    completion, each equal to ``run()``'s stream for the prompt."""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import Request
    from repro_torch.serving.server import (smoke_check,
                                            start_http_server_thread)

    prompt = http_prompt(cfg.vocab_size)
    want = Request(0, prompt=list(prompt), max_new_tokens=16)
    frontdoor_engine(cfg, pt, pd).run([want])
    fe = ServingFrontend(frontdoor_engine(cfg, pt, pd)).start()
    port, stop = start_http_server_thread(fe, model_name=cfg.name)
    try:
        t0 = time.monotonic()
        res = smoke_check("127.0.0.1", port, prompt, max_tokens=16)
        wall = time.monotonic() - t0
    finally:
        stop()
        fe.stop()
    ok = res["non_streaming_tokens"] == res["streamed_tokens"] == want.output
    emit({"phase": "frontdoor-http", "arch": cfg.name, "port": port,
          "events": res["events"], "finish_reason": res["finish_reason"],
          "equal_to_run": ok, "wall_s": wall, "nvidia_smi": smi})
    if not ok:
        raise AssertionError(f"HTTP streams differ from run(): {res} "
                             f"{want.output}")


def start_frontdoor_launchers():
    """The serve launcher's ``--http-smoke`` and ``--demo --paged
    --prefix-share 0.5`` as subprocesses on the card (reduced width),
    both at once (each mostly its own start-up), started when the
    frontdoor phase starts.  Returns (their directory, the runs, the
    start time)."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix="frontdoor-", dir=ROOT / "build"))
    runs = []
    t0 = time.monotonic()
    for i, args in enumerate((["--http-smoke"],
                              ["--demo", "--paged", "--prefix-share", "0.5"])):
        with open(tmp / f"{i}.out", "w") as out, \
                open(tmp / f"{i}.err", "w") as err:
            runs.append((args, i, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 "smollm-135m", *args], cwd=ROOT, env=env, stdout=out,
                stderr=err)))
    return tmp, runs, t0


def finish_frontdoor_launchers(launchers) -> None:
    """Each launcher of :func:`start_frontdoor_launchers` must exit 0."""
    tmp, runs, t0 = launchers
    for args, i, proc in runs:
        proc.wait(timeout=300)
        emit({"phase": "frontdoor-launcher", "args": args,
              "returncode": proc.returncode,
              "seconds": time.monotonic() - t0,
              "stdout_tail": (tmp / f"{i}.out").read_text()[-600:]})
        if proc.returncode != 0:
            raise AssertionError(f"launcher {args} failed:\n"
                                 + (tmp / f"{i}.err").read_text()[-3000:])


# the front door's depth: smollm-135m's first 10 of 30 layers at full
# width (30 until the phase took 140.4 s of an 886.6 s run on an H100
# 80GB HBM3, 700.00 W with a slow host)
FRONTDOOR_LAYERS = 10


def frontdoor_phase(smi):
    """The serving front door (prefix caching, the front-end, HTTP, the
    serve launcher) at smollm-135m full width and ``FRONTDOOR_LAYERS``
    deep, the launcher's runs beside the others; returns the launches of
    its measured runs."""
    t0 = time.monotonic()
    launchers = start_frontdoor_launchers()
    try:
        cfg, pt, pd = serve_weights(layers=FRONTDOOR_LAYERS)
        total = warm_serves(cfg, pt, pd, smi)
        for kernel, n in frontend_runs(cfg, pt, pd, smi).items():
            total[kernel] += n
        http_runs(cfg, pt, pd, smi)
    except BaseException:
        for _, _, proc in launchers[1]:
            proc.kill()
            proc.wait()
        raise
    finish_frontdoor_launchers(launchers)
    emit({"phase": "frontdoor-total", "seconds": time.monotonic() - t0})
    return total


# -- families phase ------------------------------------------------------

class FamilyServe(NamedTuple):
    """One full-width serve of the dense remainder or the MoE family:
    ``arch``'s target with seeded random weights drawn on the card, the
    model drafter on the target's own ``draft()`` (dense for an MoE
    target) or the n-gram drafter, the serve settings of ``SERVES``.
    ``nblocks`` None serves from the dense ring; ``twin``: the serve whose
    greedy streams this one's are printed beside (not required equal:
    the pipelined schedule runs other rows beside a request in some
    rounds, a request that finished stays a round longer and the next
    one starts a round later, and an MoE block's capacity couples the
    rows of a call, so the reference's own pipelined streams part from
    its synchronous ones; ``FAMILY_CHECKS`` holds the card's pipelined
    MoE streams to the CPU's), or must equal them with ``equal``;
    ``path``: the kernels that must launch during it.  The recurrent
    phase's serves (``RECURRENT_SERVES``) are of this kind too; one of
    them sets ``prompts`` (the prompt lengths, random tokens; None: the
    8 of :func:`serve_prompts`), ``max_len`` and ``new`` (tokens a
    request) for rows that outgrow the hybrid's window."""
    name: str
    arch: str
    drafter: str
    kv_quant: str
    nblocks: Optional[int]
    pipelined: bool
    damp: float
    path: Tuple[str, ...]
    twin: Optional[str] = None
    equal: bool = False
    prompts: Optional[Tuple[int, ...]] = None
    max_len: int = 256
    new: int = SERVE_NEW


B1_B2 = ("paged_ragged_verify_attention", "fused_kld_accept")
FAMILY_SERVES = (
    FamilyServe("moe-serve", "granite-moe-3b-a800m", "model", "none", 32,
                False, 1.0, B1_B2),
    FamilyServe("moe-serve-dense", "granite-moe-3b-a800m", "model", "none",
                None, False, 1.0,
                ("ragged_verify_attention", "fused_kld_accept")),
    FamilyServe("moe-serve-pipe", "granite-moe-3b-a800m", "model", "none", 32,
                True, 1.0, B1_B2, twin="moe-serve"),
    FamilyServe("moe-serve-ngram-int8", "granite-moe-3b-a800m", "ngram",
                "int8", 16, False, NGRAM_DAMP,
                ("ngram_suffix_propose", "paged_ragged_verify_attention_quant")),
    FamilyServe("granite8b-serve", "granite-8b", "model", "none", 32, False,
                1.0, B1_B2),
)


def serve_draft(cfg):
    """The model drafter's config for ``cfg``'s full-width serve: its
    ``draft()``, unless that draft's query heads do not group over its KV
    heads (qwen2-vl-2b's: H 3 over KV 2, on which the reference's own
    forward raises too), then the same draft over one KV head."""
    import dataclasses
    d = cfg.draft()
    if d.num_heads % d.num_kv_heads:
        d = dataclasses.replace(d, num_kv_heads=1)
    return d


def decoder_params(cfg) -> int:
    """The parameters a decode or verify pass reads: all of ``cfg``'s but
    an encoder-decoder's encoder (``enc_layers``, ``enc_norm``)."""
    import math
    from repro_torch.models.weights import param_leaves, param_shapes
    return sum(math.prod(leaf[0]) for path, leaf in
               param_leaves(param_shapes(cfg))
               if path[0] not in ("enc_layers", "enc_norm"))


def count_query_launches():
    """Counts the attention kernels' launches over query groups (B1, B4
    and B5 cut T into groups of at most 32 query rows a KV head at D
    128): returns (the list that each call appends its launches to, a
    function that stops counting)."""
    from repro_torch.kernels import paged_attention as pa
    seen, orig = [], pa.launch_query_groups

    def counted(q, q_pos, groups, plans, launch):
        seen.append(len(groups))
        return orig(q, q_pos, groups, plans, launch)
    mods = _counter_modules()
    for mod in mods:
        if hasattr(mod, "launch_query_groups"):
            mod.launch_query_groups = counted

    def stop():
        for mod in mods:
            if hasattr(mod, "launch_query_groups"):
                mod.launch_query_groups = orig
    return seen, stop


def family_forward(cfg, params, smi) -> dict:
    """One decode step (T 1) and one verify pass (T 11) of a full-width
    target, B 4, 128 committed positions a row (on the fp32 pool; an ssm
    target on its dense ring of state), and for a recurrent target one
    commit re-advance (the masked second pass over the 11 verified
    tokens, 3 accepted a row), work the attention families' round does
    not have: wall ms a call over 10 calls with a synchronise after
    them, and the attention kernels' launches in one call (T 11 is cut
    into query groups: two at D 128 G 4, one at D 256 G 10).  Bound:
    the target's weight bytes over 3.35 TB/s, which every pass reads.
    Returns the row."""
    import torch
    from repro_torch.kernels.paged_attention import query_groups
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import (commit, forward,
                                                has_recurrent_state)
    from repro_torch.models.weights import count_params

    b, ctx, bs = 4, 128, 16
    if cache_lib.supports_paged(cfg):
        cache = cache_lib.paged_cache_struct(cfg, b, 256, b * 256 // bs, bs,
                                             device="cuda")
        cache["block_table"][:, :] = torch.arange(
            b * 256 // bs, dtype=torch.int32, device="cuda").reshape(b, -1)
        cache["kv_pos"][:b * 256 // bs] = torch.arange(
            256, dtype=torch.int32, device="cuda").reshape(-1, bs).repeat(b, 1)
    else:
        cache = cache_lib.cache_struct(cfg, b, 256, device="cuda")
    cache["length"] = torch.full((b,), ctx, dtype=torch.int32, device="cuda")
    weight_ms = 1e3 * decoder_params(cfg) * 4 / HBM_BYTES_S
    row = {"phase": "family-forward", "arch": cfg.name, "B": b, "ctx": ctx,
           "params": count_params(cfg), "params_read": decoder_params(cfg),
           "weight_bound_ms": weight_ms, "nvidia_smi": smi}
    tok = torch.ones((b, 11), dtype=torch.int32, device="cuda")
    calls = {
        "T1": lambda: forward(params, cfg, tok[:, :1], cache=cache,
                              mode="decode"),
        "T11": lambda: forward(params, cfg, tok, cache=cache, mode="decode"),
    }
    if has_recurrent_state(cfg):
        _, verified = forward(params, cfg, tok, cache=cache, mode="decode")
        n3 = torch.full((b,), 3, dtype=torch.int32, device="cuda")
        calls["commit"] = lambda: commit(params, cfg, tok, cache, verified, n3)
    for key, call in calls.items():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        seen, stop = count_query_launches()
        try:
            call()
        finally:
            stop()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0) / 10
        row[key] = {"ms": ms, "attention_calls": len(seen),
                    "attention_launches": sum(seen),
                    "weight_bound_share": weight_ms / ms}
    if "commit" in row:
        row["readvance_share_of_verify_plus_readvance"] = (
            row["commit"]["ms"] / (row["T11"]["ms"] + row["commit"]["ms"]))
    emit(row)
    want = (0 if cfg.attention_free else
            cache_lib.paged_kv_layers(cfg) * len(query_groups(
                cfg.num_heads, cfg.num_kv_heads, 11, cfg.resolved_head_dim)))
    if row["T11"]["attention_launches"] != want:
        raise AssertionError(f"{cfg.name}: verify attention launches "
                             f"{row['T11']}, want {want}")
    return row


def time_commits():
    """Brackets each target commit of the serve's rounds
    (``spec_decode.commit``: a recurrent target's masked re-advance) with
    CUDA events; returns a function that restores it and, once the run
    has synchronised, gives the device ms the stream spent from each
    commit's first operation to its last, summed, and the commits."""
    import torch
    from repro_torch.core import spec_decode as sd
    pairs, orig = [], sd.commit

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args)
        end.record()
        pairs.append((start, end))
        return out
    sd.commit = timed

    def stop():
        sd.commit = orig
        return sum(a.elapsed_time(b) for a, b in pairs), len(pairs)
    return stop


def family_engine(cfg, dcfg, pt, pd, sv):
    """The engine builder of the family serve ``sv``: ``cfg``'s target
    ``pt`` (damped by ``sv.damp``) and, for the model drafter, the draft
    ``dcfg`` / ``pd``."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    model = sv.drafter == "model"
    serving = ServingConfig(max_batch_size=4, max_seq_len=sv.max_len,
                            pipelined=sv.pipelined,
                            paged_kv=sv.nblocks is not None,
                            kv_block_size=16, num_kv_blocks=sv.nblocks,
                            kv_quant=sv.kv_quant)
    target = damped(pt, sv.damp)

    def engine():
        return ServingEngine(target, cfg, pd if model else None,
                             dcfg if model else None,
                             SpecDecodeConfig(drafter=sv.drafter),
                             serving, seed=0, device="cuda")
    return engine


def family_requests(cfg, sv):
    """The family serve ``sv``'s requests (``sv.prompts``: their lengths,
    random tokens; None: the 8 of :func:`serve_prompts`)."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.RandomState(0)
    prompts = (serve_prompts(cfg.vocab_size, sv.drafter)
               if sv.prompts is None else
               [rng.randint(0, cfg.vocab_size, size=n).tolist()
                for n in sv.prompts])
    return [Request(i, prompt=p, max_new_tokens=sv.new)
            for i, p in enumerate(prompts)]


FAMILY_PROFILED = ("moe-serve",)


def family_serves(smi, serves=FAMILY_SERVES, profiled_names=FAMILY_PROFILED):
    """The full-width ``serves``, each target built once and freed before
    the next; then the ``profiled_names`` serves again under the
    profiler.  A recurrent target's commits are timed inside the serve
    (:func:`time_commits`).  Returns the launches summed over the
    serves."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import has_recurrent_state
    from repro_torch.models.weights import init_params
    from repro_torch.serving.request import Request

    total = {k: 0 for k in read_launches()}
    streams = {}
    for arch in dict.fromkeys(sv.arch for sv in serves):
        cfg = get_config(arch)
        dcfg = serve_draft(cfg)
        t0 = time.monotonic()
        pt = init_params(cfg, seed=0, device="cuda", rng_device="cuda")
        pd = init_params(dcfg, seed=1, device="cuda", rng_device="cuda")
        torch.cuda.synchronize()
        emit({"phase": "family-init", "arch": arch,
              "seconds": time.monotonic() - t0,
              "memory_gib": torch.cuda.memory_allocated() / 2 ** 30})
        family_forward(cfg, pt, smi)
        profiled = []
        for sv in (sv for sv in serves if sv.arch == arch):
            model = sv.drafter == "model"
            engine = family_engine(cfg, dcfg, pt, pd, sv)
            reqs = family_requests(cfg, sv)
            engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
            eng = engine()
            syncs = count_syncs(eng)
            reset_launches()
            torch.cuda.synchronize()
            stop_commits = (time_commits() if has_recurrent_state(cfg)
                            else None)
            t1 = time.monotonic()
            try:
                m = eng.run(reqs)
            finally:
                torch.cuda.synchronize()
                wall = time.monotonic() - t1
                commits = stop_commits() if stop_commits else None
            launches = read_launches()
            streams[sv.name] = [r.output for r in reqs]
            proposing = sum(1 for r in eng.round_log if r["proposed"] > 0)
            round_ms = 1e3 * wall / max(m["rounds"], 1)
            row = {"phase": sv.name, "arch": cfg.name, "family": cfg.family,
                   "layers": cfg.num_layers, "drafter": sv.drafter,
                   "draft_arch": dcfg.name if model else None,
                   "draft_heads": ((dcfg.num_heads, dcfg.num_kv_heads)
                                   if model else None),
                   "kv_quant": sv.kv_quant,
                   "paged_kv": sv.nblocks is not None,
                   "pipelined": sv.pipelined, "residual_scale": sv.damp,
                   "requests": len(reqs), "rounds": m["rounds"],
                   "tokens": m["tokens_emitted"],
                   "preemptions": m["preemptions"],
                   "proposed": sum(r["proposed"] for r in eng.round_log),
                   "proposing_rounds": proposing,
                   "mean_acceptance": m["mean_acceptance"],
                   "wall_s": wall, "tokens_per_s": m["tokens_emitted"] / wall,
                   "mean_round_ms": round_ms,
                   "host_blocked_s": m["host_blocked_s"],
                   "dispatch_syncs": sum(syncs.values()),
                   "dispatch_sync_sources": dict(syncs),
                   "draft_steps": m["draft_steps"],
                   "kv_pool_bytes": m["kv_pool_bytes"],
                   "max_tokens_a_row": max(len(r.prompt) + len(r.output)
                                           for r in reqs),
                   "launches": launches, "nvidia_smi": smi}
            if cfg.family == "hybrid" and sv.nblocks is None:
                row["ring_slots"] = cache_lib.cache_window(
                    eng.state.target_cache)
            if commits is not None:
                # the target's re-advance in this serve's own rounds
                row["readvance_device_ms"], row["commits"] = commits
                row["readvance_share_of_wall"] = (
                    commits[0] / (1e3 * wall))
            if sv.twin is not None:     # printed; required with ``equal``
                row["equal_to_" + sv.twin] = streams[sv.name] == streams[sv.twin]
                row["requests_equal_to_" + sv.twin] = sum(
                    a == b for a, b in zip(streams[sv.name], streams[sv.twin]))
            emit(row)
            if sv.equal and streams[sv.name] != streams[sv.twin]:
                raise AssertionError(f"{sv.name}: greedy streams differ from "
                                     f"{sv.twin}'s")
            if min(launches[k] for k in sv.path) <= 0:
                raise AssertionError(f"{sv.name}: a kernel of the path never "
                                     f"ran: {launches}")
            if m["requests_finished"] != len(reqs) or any(
                    len(r.output) != sv.new for r in reqs):
                raise AssertionError(f"{sv.name} did not finish: {m}")
            if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
                raise AssertionError(f"{sv.name}: a token outside the "
                                     "vocabulary")
            if sum(syncs.values()):
                raise AssertionError(f"{sv.name}: dispatch synchronised: "
                                     f"{dict(syncs)}")
            if sv.drafter == "ngram" and proposing == 0:
                raise AssertionError(f"{sv.name}: no round proposed a token")
            if sv.prompts is not None and not (
                    row["ring_slots"] == HYBRID_RING
                    < row["max_tokens_a_row"]):
                raise AssertionError(f"{sv.name}: rows of "
                                     f"{row['max_tokens_a_row']} tokens on "
                                     f"a {row['ring_slots']}-slot ring, want "
                                     f"more than {HYBRID_RING} slots' worth")
            for k in total:
                total[k] += launches[k]
            if sv.name in profiled_names:
                profiled.append((sv.name, engine, reqs))
            del engine, eng
        for args in profiled:
            timed_phase("profile", profile_phase, *args)
        del pt, pd, profiled
        gc.collect()
        torch.cuda.empty_cache()
    return total


class FamilyCheck(NamedTuple):
    """One reduced-width card == CPU check of the dense options and the
    MoE family: ``arch``'s ``reduced()`` with ``replace`` applied, its
    ``draft()`` as the model drafter, dsde (or the static policy at SL
    ``sl``), synchronous or ``pipelined``."""
    name: str
    arch: str
    replace: Tuple[Tuple[str, object], ...] = ()
    sl: Optional[int] = None
    pipelined: bool = False


def granite_routing():
    """granite-moe-3b-a800m's routing (40 experts, top 8) with reduced
    experts (d_ff 256): the reduced config keeps 4 experts, top 2."""
    from repro_torch.core.config import MoEConfig
    return MoEConfig(num_experts=40, top_k=8, expert_d_ff=256)


FAMILY_CHECKS = (
    FamilyCheck("qk_norm", "qwen3-32b"),
    FamilyCheck("qkv_bias", "qwen2.5-32b"),
    FamilyCheck("untied-head", "granite-8b"),
    FamilyCheck("kv-head-pad", "qwen3-32b", (("kv_head_pad", 4),)),
    FamilyCheck("q-head-pad", "smollm-135m", (("q_head_pad", 8),)),
    FamilyCheck("moe-overflow", "granite-moe-3b-a800m"),
    FamilyCheck("moe-overflow-window", "mixtral-8x22b"),
    # the pipelined schedule with granite's routing, where its streams
    # part from the synchronous ones (in the reference too)
    FamilyCheck("moe-pipelined", "granite-moe-3b-a800m",
                (("moe", "granite_routing"),), pipelined=True),
    # D 128, G 4, static SL 10: verify passes of G * T 44 query rows a KV
    # head, two launches of B1 / B5 each
    FamilyCheck("d128", "granite-8b", (("head_dim", 128),), sl=10),
)


def family_check_phase() -> None:
    """``FAMILY_CHECKS`` on the card (kernels) and on the CPU (plain
    versions): equal greedy streams on the fp32 pool and on the dense
    ring.  The draws of the zero-initialised qkv biases and qk-norm
    scales are made random, so the options change the function.  The
    MoE checks must drop (token, slot) pairs on the card: prompts of 30
    tokens and batch 2 give prefill groups of 64 tokens, capacity 48."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models import transformer
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    drops = []
    orig = transformer.moe_apply

    def counted(p, cfg, x):
        y, aux = orig(p, cfg, x)
        if x.is_cuda:
            drops.append(aux["dropped_fraction"])
        return y, aux
    transformer.moe_apply = counted
    try:
        for chk in FAMILY_CHECKS:
            base = get_config(chk.arch).reduced()
            replace = {k: (granite_routing() if v == "granite_routing" else v)
                       for k, v in chk.replace}
            cfg = dataclasses.replace(base, **replace)
            # the head pads are the target's layout: its draft is the
            # unpadded config's
            dcfg = base.draft()
            pt = init_params(cfg, seed=2, device="cpu")
            gen = torch.Generator().manual_seed(4)
            attn = pt["layers"]["attn"]
            for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
                if name in attn:
                    attn[name] = 0.3 * torch.randn(attn[name].shape,
                                                   generator=gen)
            pd = init_params(dcfg, seed=3, device="cpu")
            spec = SpecDecodeConfig()
            if chk.sl is not None:
                spec = SpecDecodeConfig(policy="static", sl_max=chk.sl,
                                        static_sl=chk.sl)
            for dense in (False, True):
                outs, max_k = {}, 0
                drops.clear()
                for device in ("cuda", "cpu"):
                    rs = [Request(i, prompt=list(range(3 + i, 33 + i)),
                                  max_new_tokens=24) for i in range(4)]
                    eng = ServingEngine(
                        pt, cfg, pd, dcfg, spec,
                        ServingConfig(max_batch_size=2, max_seq_len=128,
                                      paged_kv=not dense, kv_block_size=16,
                                      num_kv_blocks=16,
                                      pipelined=chk.pipelined),
                        device=device)
                    eng.run(rs)
                    outs[device] = [r.output for r in rs]
                    max_k = max(r["k"] for r in eng.round_log)
                h = cfg.q_head_pad or cfg.num_heads
                kv = cfg.kv_head_pad or cfg.num_kv_heads
                rows = h // kv * (max_k + 1)
                dropping = sum(bool(d > 0) for d in drops)
                emit({"phase": "family-check",
                      "what": "reduced-width greedy streams, card vs CPU",
                      "check": chk.name, "arch": cfg.name,
                      "replace": dict(chk.replace), "pipelined": chk.pipelined,
                      "layout": "dense" if dense else "paged",
                      "H": h, "KV": kv,
                      "D": cfg.resolved_head_dim, "max_k": max_k,
                      "verify_rows_per_kv_head": rows,
                      "moe_calls": len(drops), "moe_calls_dropping": dropping,
                      "equal": outs["cuda"] == outs["cpu"]})
                if outs["cuda"] != outs["cpu"]:
                    raise AssertionError(f"family check {chk.name} "
                                         f"dense={dense}: card and CPU "
                                         f"streams differ: {outs}")
                if cfg.family == "moe" and dropping == 0:
                    raise AssertionError(f"family check {chk.name}: no MoE "
                                         "call dropped a pair")
                if chk.sl is not None and rows <= 32:
                    raise AssertionError(f"family check {chk.name}: verify "
                                         f"rows {rows} fit one D-128 launch")
    finally:
        transformer.moe_apply = orig


def families_phase(smi, side=False):
    """The full-width serves of the dense remainder and the MoE family,
    and (unless ``side``: the side processes take them) the MoE serve's
    profile; their reduced-width checks run in a side process (or
    ``--only checks``).  Returns the serves' launches."""
    t0 = time.monotonic()
    launches = family_serves(smi, FAMILY_SERVES,
                             () if side else FAMILY_PROFILED)
    emit({"phase": "families-total", "seconds": time.monotonic() - t0})
    return launches


# -- recurrent phase -----------------------------------------------------

RECURRENT_SERVES = (
    FamilyServe("ssm-serve", "mamba2-130m", "model", "none", None, False,
                1.0, ("fused_kld_accept",)),
    FamilyServe("ssm-serve-pipe", "mamba2-130m", "model", "none", None, True,
                1.0, ("fused_kld_accept",), twin="ssm-serve", equal=True),
    FamilyServe("ssm-serve-ngram", "mamba2-130m", "ngram", "none", None,
                False, NGRAM_DAMP, ("ngram_suffix_propose",)),
    FamilyServe("hybrid-serve", "recurrentgemma-2b", "model", "none", 32,
                False, 1.0, B1_B2),
    FamilyServe("hybrid-serve-dense", "recurrentgemma-2b", "model", "none",
                None, False, 1.0,
                ("ragged_verify_attention", "fused_kld_accept")),
    # rows of 2030-2040 + 48 tokens on the 2064-slot ring: the window-2048
    # mask bites and the ring wraps
    FamilyServe("hybrid-serve-window", "recurrentgemma-2b", "model", "none",
                None, False, 1.0,
                ("ragged_verify_attention", "fused_kld_accept"),
                prompts=(2030, 2036, 2040), max_len=2112, new=48),
)
RECURRENT_PROFILED = ("ssm-serve", "hybrid-serve")


class RecurrentCheck(NamedTuple):
    """One reduced-width card == CPU check of a recurrent family:
    ``arch``'s ``reduced()`` at ``layers`` (None: its own 2), its
    ``draft()`` as the model drafter, dsde, on the pool (``nblocks``
    blocks of ``bs``) or the ring (``nblocks`` None)."""
    name: str
    arch: str
    layers: Optional[int]
    nblocks: Optional[int]
    pipelined: bool = False
    bs: int = 16
    max_len: int = 128
    new: int = 24
    prompt: int = 30


RECURRENT_CHECKS = (
    RecurrentCheck("ssm-ring", "mamba2-130m", None, None),
    RecurrentCheck("ssm-ring-pipe", "mamba2-130m", None, None, True),
    # 5 layers: one (rec, rec, attn) group and a tail of two (the reduced
    # 2-layer stack has no attention layer)
    RecurrentCheck("hybrid5-pool", "recurrentgemma-2b", 5, 16),
    # window 64: a ring of 80 slots that rows of 30-40 + 56 tokens wrap
    RecurrentCheck("hybrid5-ring-wraps", "recurrentgemma-2b", 5, None,
                   new=56),
    # 8 blocks of 8 for two rows of 9-12 + 24 tokens (5 blocks each once
    # grown): forced preemption
    RecurrentCheck("hybrid5-pool-preempt", "recurrentgemma-2b", 5, 8, bs=8,
                   max_len=64, prompt=9),
)


def recurrent_check_phase() -> None:
    """``RECURRENT_CHECKS`` on the card (kernels) and on the CPU (plain
    versions): equal greedy streams; prompts of ``prompt`` + 2i tokens
    (request i)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    for chk in RECURRENT_CHECKS:
        cfg = get_config(chk.arch).reduced()
        if chk.layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=chk.layers)
        pt = init_params(cfg, seed=2, device="cpu")
        pd = init_params(cfg.draft(), seed=3, device="cpu")
        outs, info = {}, {}
        for device in ("cuda", "cpu"):
            rs = [Request(i, prompt=list(range(3 + i, 3 + chk.prompt + 2 * i)),
                          max_new_tokens=chk.new) for i in range(4)]
            eng = ServingEngine(
                pt, cfg, pd, cfg.draft(), SpecDecodeConfig(),
                ServingConfig(max_batch_size=2, max_seq_len=chk.max_len,
                              paged_kv=chk.nblocks is not None,
                              kv_block_size=chk.bs,
                              num_kv_blocks=chk.nblocks,
                              pipelined=chk.pipelined),
                device=device)
            m = eng.run(rs)
            outs[device] = [r.output for r in rs]
            info[device] = (m["preemptions"],
                            max(len(r.prompt) + len(r.output) for r in rs))
        ring = (None if chk.nblocks is not None or cfg.family != "hybrid"
                else min(chk.max_len, cfg.rglru.local_attention_window + 16))
        emit({"phase": "recurrent-check",
              "what": "reduced-width greedy streams, card vs CPU",
              "check": chk.name, "arch": cfg.name, "layers": cfg.num_layers,
              "layout": "paged" if chk.nblocks is not None else "dense",
              "pipelined": chk.pipelined, "ring_slots": ring,
              "preemptions": info["cuda"][0], "max_tokens": info["cuda"][1],
              "equal": outs["cuda"] == outs["cpu"]})
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"recurrent check {chk.name}: card and CPU "
                                 f"streams differ: {outs}")
        if chk.name.endswith("preempt") and info["cuda"][0] < 1:
            raise AssertionError(f"recurrent check {chk.name}: no preemption")
        if ring is not None and info["cuda"][1] <= ring:
            raise AssertionError(f"recurrent check {chk.name}: rows of "
                                 f"{info['cuda'][1]} tokens never wrap a "
                                 f"{ring}-slot ring")


def recurrent_phase(smi, side=False):
    """The full-width serves of the recurrent families and, unless
    ``side`` (the side processes take them), their profiles and
    reduced-width checks; returns the serves' launches."""
    t0 = time.monotonic()
    launches = family_serves(smi, RECURRENT_SERVES,
                             () if side else RECURRENT_PROFILED)
    if not side:
        timed_phase("recurrent-check", recurrent_check_phase)
    emit({"phase": "recurrent-total", "seconds": time.monotonic() - t0})
    return launches


# -- multimodal phase ----------------------------------------------------

MULTIMODAL_SERVES = (
    FamilyServe("vlm-serve", "qwen2-vl-2b", "model", "none", 32, False, 1.0,
                B1_B2),
    FamilyServe("vlm-serve-int8", "qwen2-vl-2b", "model", "int8", 32, False,
                1.0, ("paged_ragged_verify_attention_quant",
                      "fused_kld_accept")),
    FamilyServe("vlm-serve-dense", "qwen2-vl-2b", "model", "none", None,
                False, 1.0, ("ragged_verify_attention", "fused_kld_accept")),
    FamilyServe("vlm-serve-pipe", "qwen2-vl-2b", "model", "none", 32, True,
                1.0, B1_B2, twin="vlm-serve", equal=True),
    # the reference's engine serves audio on the ring with an empty
    # encoder context (one cross slot, never valid)
    FamilyServe("audio-serve", "seamless-m4t-medium", "model", "none", None,
                False, 1.0, ("ragged_verify_attention", "fused_kld_accept")),
)
MULTIMODAL_PROFILED = ("vlm-serve", "audio-serve")
# the vision stub's image (a GRID x GRID patch grid) and text prompt
GRID, IMAGE_TEXT = 16, 32
# the encoder-conditioned round: frames, decoder prompt, rounds
ENC_FRAMES, ENC_PROMPT, ENC_ROUNDS = 128, 16, 8


def vision_inputs(cfg, params, b, grid, text, device, seed=0):
    """(embeds [B, grid^2 + text, d], rope_positions [B, T, 3]) of the
    vision stub: seeded patch embeddings, then the embeddings of a text
    prompt; M-RoPE positions in Qwen2-VL's layout, patches at (0, h, w),
    text from the largest + 1, equal in all three streams."""
    import torch
    g = torch.Generator().manual_seed(seed)
    patches = torch.randn(b, grid * grid, cfg.d_model, generator=g) * 0.02
    text_ids = torch.randint(0, cfg.vocab_size, (b, text), generator=g)
    emb = torch.cat([patches.to(device),
                     params["embed"][text_ids.to(device)]], 1)
    hh, ww = torch.meshgrid(torch.arange(grid), torch.arange(grid),
                            indexing="ij")
    img = torch.stack([torch.zeros(grid * grid, dtype=torch.long),
                       hh.reshape(-1), ww.reshape(-1)], -1)
    txt = (img.max() + 1 + torch.arange(text))[:, None].expand(text, 3)
    pos = torch.cat([img, txt])[None].expand(b, -1, -1)
    return emb, pos.to(torch.int32).to(device).contiguous()


def vlm_image(cfg, params, device, b=4, grid=GRID, text=IMAGE_TEXT):
    """Prefill the vision stub's image + text into a fresh fp32 pool
    through ``forward(embeds=, rope_positions=)``, then a T 1 and a T 11
    decode step off the pool (B1 on the card).  Returns (prefill logits
    at each row's last position, T 1 logits, T 11 logits, the cache's
    length)."""
    import torch
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import forward
    bs, max_len = 16, 512
    maxb = max_len // bs
    cache = cache_lib.paged_cache_struct(cfg, b, max_len, b * maxb, bs,
                                         device=device)
    cache["block_table"][:] = torch.arange(
        b * maxb, dtype=torch.int32, device=device).reshape(b, maxb)
    emb, pos = vision_inputs(cfg, params, b, grid, text, device)
    t = emb.shape[1]
    logits, cache = forward(params, cfg, None, cache=cache, mode="prefill",
                            embeds=emb, rope_positions=pos)
    cache["length"] = torch.full((b,), t, dtype=torch.int32, device=device)
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
    d1, _ = forward(params, cfg, nxt[:, None], cache=cache, mode="decode")
    toks = torch.arange(11, dtype=torch.int32, device=device)[None] + nxt[:, None]
    d11, _ = forward(params, cfg, toks % cfg.vocab_size, cache=cache,
                     mode="decode")
    return logits[:, -1], d1, d11, t


def encdec_state(cfg, pt, pd, dcfg, device, b=4, frames=ENC_FRAMES,
                 prompt=ENC_PROMPT, rounds=ENC_ROUNDS, seed=0):
    """An encoder-conditioned round state: ``init_round_state(enc_len=
    frames)``, seeded frames through ``encode`` and ``build_cross_cache``
    into the target's ring (the draft keeps its one empty cross slot), a
    seeded ``prompt``-token decoder prompt prefilled into both rings.
    Returns (state, drafter, spec, frame embeds, prefill logits)."""
    import torch
    from repro_torch.core.config import SpecDecodeConfig
    from repro_torch.core.drafters import build_drafter
    from repro_torch.core.spec_decode import init_round_state
    from repro_torch.models.transformer import (build_cross_cache, encode,
                                                forward)
    g = torch.Generator().manual_seed(seed)
    emb = (torch.randn(b, frames, cfg.d_model, generator=g) * 0.3).to(device)
    toks = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g,
                         dtype=torch.int32).to(device)
    spec = SpecDecodeConfig()
    drafter = build_drafter(spec, cfg, dcfg)
    st = init_round_state(cfg, dcfg, spec, b,
                          prompt + rounds * (spec.sl_max + 1) + 16,
                          drafter=drafter, device=device, enc_len=frames)
    ck, cv = build_cross_cache(pt, cfg, encode(pt, cfg, emb))
    tc = dict(st.target_cache, cross_k=ck, cross_v=cv,
              enc_valid=torch.ones((b, frames), dtype=torch.bool,
                                   device=device))
    logits, tc = forward(pt, cfg, toks, cache=tc, mode="prefill")
    _, dc = forward(pd, dcfg, toks, cache=st.draft_cache, mode="prefill")
    for c in (tc, dc):
        c["length"] = torch.full((b,), prompt, dtype=torch.int32,
                                 device=device)
    pend = logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)
    return (st._replace(target_cache=tc, draft_cache=dc, pending=pend),
            drafter, spec, emb, logits)


def encdec_rounds(cfg, pt, pd, dcfg, device, rounds=ENC_ROUNDS):
    """``rounds`` ``spec_decode_round`` calls over :func:`encdec_state`,
    each at the bucket K of the state's largest next SL.  Returns (the
    emitted tokens of each row, the prefill logits, the round state)."""
    import torch
    from repro_torch.core.spec_decode import spec_decode_round
    st, drafter, spec, _, logits = encdec_state(cfg, pt, pd, dcfg, device)
    b = st.pending.shape[0]
    active = torch.ones((b,), dtype=torch.bool, device=device)
    rows = [[] for _ in range(b)]
    for _ in range(rounds):
        k = int(st.sl_next.max())
        st, out = spec_decode_round(pt, pd, cfg, drafter, spec, k, st, active)
        em, n = out.emitted.cpu(), out.num_emitted.cpu()
        for i in range(b):
            rows[i] += em[i, :int(n[i])].tolist()
    return rows, logits, st


def wall_ms(fn, n=10) -> float:
    """Wall ms a call of ``fn`` over ``n`` calls, after two warm calls,
    with a synchronise before and after."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t0) / n


def vlm_image_phase(smi) -> None:
    """qwen2-vl-2b at full width: the vision stub's 16 x 16 patch grid and
    a 32-token text prompt, B 4, prefilled into the fp32 pool with
    M-RoPE positions, then T 1 and T 11 decode steps through B1 (which
    must launch); every logit finite.  Timed: the prefill and each
    decode step, against the weight bytes each reads."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    cfg = get_config("qwen2-vl-2b")
    pt = init_params(cfg, seed=0, device="cuda", rng_device="cuda")
    reset_launches()
    last, d1, d11, t = vlm_image(cfg, pt, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    weight_ms = 1e3 * decoder_params(cfg) * 4 / HBM_BYTES_S
    ms = wall_ms(lambda: vlm_image(cfg, pt, "cuda"), n=3)
    row = {"phase": "vlm-image", "arch": cfg.name, "B": 4,
           "patches": GRID * GRID, "text": IMAGE_TEXT, "prefill_tokens": t,
           "mrope_sections": list(cfg.mrope_sections),
           "prefill_plus_two_decodes_ms": ms, "weight_bound_ms": weight_ms,
           "finite": all(bool(x.isfinite().all()) for x in (last, d1, d11)),
           "B1_launches": launches["paged_ragged_verify_attention"],
           "nvidia_smi": smi}
    emit(row)
    if not row["finite"] or row["B1_launches"] <= 0:
        raise AssertionError(f"vlm-image: {row}")
    del pt
    gc.collect()
    torch.cuda.empty_cache()


def audio_encdec_phase(smi):
    """seamless-m4t-medium at full width, its ``draft()`` as the model
    drafter: seeded frames (B 4 x 128) encoded into the target's cross
    cache of a round state from ``init_round_state(enc_len=128)``, a
    16-token decoder prompt prefilled, then 8 ``spec_decode_round`` calls
    driven directly (B5 and B2 must launch; every token in the
    vocabulary).  Timed: the encode, a decode step (T 1) and a verify
    pass (T 11) of the target, each against the weight bytes it reads
    (the encoder's, the decoder's).  Returns the rounds' launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import encode, forward
    from repro_torch.models.weights import count_params, init_params
    cfg = get_config("seamless-m4t-medium")
    dcfg = serve_draft(cfg)
    pt = init_params(cfg, seed=0, device="cuda", rng_device="cuda")
    pd = init_params(dcfg, seed=1, device="cuda", rng_device="cuda")
    rows, _, _ = encdec_rounds(cfg, pt, pd, dcfg, "cuda")     # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows, logits, st = encdec_rounds(cfg, pt, pd, dcfg, "cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    st0, _, _, emb, _ = encdec_state(cfg, pt, pd, dcfg, "cuda")
    tc = st0.target_cache
    tok = torch.ones((4, 11), dtype=torch.int32, device="cuda")
    dec_params = decoder_params(cfg)
    enc_params = count_params(cfg) - dec_params
    timed = {
        "encode": (lambda: encode(pt, cfg, emb), enc_params),
        "T1": (lambda: forward(pt, cfg, tok[:, :1], cache=tc, mode="decode"),
               dec_params),
        "T11": (lambda: forward(pt, cfg, tok, cache=tc, mode="decode"),
                dec_params),
    }
    row = {"phase": "audio-encdec", "arch": cfg.name, "draft": dcfg.name,
           "B": 4, "frames": ENC_FRAMES, "prompt": ENC_PROMPT,
           "rounds": ENC_ROUNDS, "rounds_wall_s": wall,
           "tokens": sum(len(r) for r in rows),
           "lengths": st.target_cache["length"].tolist(),
           "launches": launches, "nvidia_smi": smi}
    for key, (fn, n) in timed.items():
        ms = wall_ms(fn)
        bound = 1e3 * n * 4 / HBM_BYTES_S
        row[key] = {"ms": ms, "params_read": n, "weight_bound_ms": bound,
                    "weight_bound_share": bound / ms}
    emit(row)
    if not (launches["ragged_verify_attention"] > 0
            and launches["fused_kld_accept"] > 0):
        raise AssertionError(f"audio-encdec: a kernel never ran: {launches}")
    if not (bool(logits.isfinite().all()) and all(
            0 <= t < cfg.vocab_size for r in rows for t in r)
            and row["tokens"] >= 4 * ENC_ROUNDS):
        raise AssertionError(f"audio-encdec: {row}")
    del pt, pd, st, st0, tc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class MultimodalCheck(NamedTuple):
    """One reduced-width card == CPU check of a multimodal serve:
    ``arch``'s ``reduced()`` with its ``draft()`` as the model drafter,
    dsde, on the pool (``nblocks`` blocks of 16, ``kv_quant``) or the ring
    (``nblocks`` None), synchronous or ``pipelined``."""
    name: str
    arch: str
    nblocks: Optional[int]
    kv_quant: str = "none"
    pipelined: bool = False


MULTIMODAL_CHECKS = (
    MultimodalCheck("vlm-pool", "qwen2-vl-2b", 16),
    MultimodalCheck("vlm-int8", "qwen2-vl-2b", 16, "int8"),
    MultimodalCheck("vlm-ring", "qwen2-vl-2b", None),
    MultimodalCheck("vlm-pool-pipe", "qwen2-vl-2b", 16, pipelined=True),
    MultimodalCheck("audio-ring", "seamless-m4t-medium", None),
)
# card == CPU logits of the reduced image prefill and decode steps and
# of the encoder-conditioned prefill (the CPU tests' bound for the port
# against the reference), on the reduced init scaled by CONDITIONED: at
# its own scale (layer weights of std 0.71) attention saturates and the
# card's and the CPU's orders of fp32 sums part by up to 1.9e-4 in the
# image path's T 11 logits (PR 22's first card run)
MULTIMODAL_LOGIT_ATOL = 1e-4
CONDITIONED = 0.2


def multimodal_check_phase() -> None:
    """``MULTIMODAL_CHECKS`` on the card (kernels) and on the CPU (plain
    versions): equal greedy streams; then the reduced vlm-image path
    (logits within ``MULTIMODAL_LOGIT_ATOL``) and the reduced
    encoder-conditioned rounds (equal tokens, prefill logits within the
    same bound), both on the init scaled by ``CONDITIONED``."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    for chk in MULTIMODAL_CHECKS:
        cfg = get_config(chk.arch).reduced()
        pt = init_params(cfg, seed=2, device="cpu")
        pd = init_params(cfg.draft(), seed=3, device="cpu")
        outs = {}
        for device in ("cuda", "cpu"):
            rs = [Request(i, prompt=list(range(3 + i, 33 + 2 * i)),
                          max_new_tokens=24) for i in range(4)]
            eng = ServingEngine(
                pt, cfg, pd, cfg.draft(), SpecDecodeConfig(),
                ServingConfig(max_batch_size=2, max_seq_len=128,
                              paged_kv=chk.nblocks is not None,
                              kv_block_size=16, num_kv_blocks=chk.nblocks,
                              kv_quant=chk.kv_quant,
                              pipelined=chk.pipelined),
                device=device)
            eng.run(rs)
            outs[device] = [r.output for r in rs]
        emit({"phase": "multimodal-check",
              "what": "reduced-width greedy streams, card vs CPU",
              "check": chk.name, "arch": cfg.name,
              "layout": "paged" if chk.nblocks is not None else "dense",
              "kv_quant": chk.kv_quant, "pipelined": chk.pipelined,
              "equal": outs["cuda"] == outs["cpu"]})
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"multimodal check {chk.name}: card and CPU "
                                 f"streams differ: {outs}")
    cfg = get_config("qwen2-vl-2b").reduced()
    pt = map_params(lambda a: a * CONDITIONED,
                    init_params(cfg, seed=2, device="cpu"))
    got = vlm_image(cfg, map_params(lambda a: a.cuda(), pt), "cuda", grid=4,
                    text=8)
    want = vlm_image(cfg, pt, "cpu", grid=4, text=8)
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got[:3], want[:3])]
    emit({"phase": "multimodal-check", "check": "vlm-image",
          "what": "reduced-width image prefill + T 1 / T 11 logits, card vs "
                  "CPU", "max_abs_err": errs, "atol": MULTIMODAL_LOGIT_ATOL})
    if max(errs) > MULTIMODAL_LOGIT_ATOL:
        raise AssertionError(f"vlm-image check: card and CPU logits part: "
                             f"{errs}")
    cfg = get_config("seamless-m4t-medium").reduced()
    pt, pd = (map_params(lambda a: a * CONDITIONED,
                         init_params(c, seed=sd, device="cpu"))
              for c, sd in ((cfg, 2), (cfg.draft(), 3)))
    runs = {dev: encdec_rounds(cfg, map_params(lambda a: a.to(dev), pt),
                               map_params(lambda a: a.to(dev), pd),
                               cfg.draft(), dev) for dev in ("cuda", "cpu")}
    err = float((runs["cuda"][1].cpu() - runs["cpu"][1]).abs().max())
    same = runs["cuda"][0] == runs["cpu"][0]
    emit({"phase": "multimodal-check", "check": "audio-encdec",
          "what": "reduced-width encoder-conditioned rounds, card vs CPU",
          "equal": same, "tokens": sum(len(r) for r in runs["cpu"][0]),
          "prefill_max_abs_err": err, "atol": MULTIMODAL_LOGIT_ATOL})
    if not same or err > MULTIMODAL_LOGIT_ATOL:
        raise AssertionError(f"audio-encdec check: card and CPU part: {err}, "
                             f"{runs['cuda'][0]} vs {runs['cpu'][0]}")


def multimodal_phase(smi, side=False):
    """The full-width serves of the vlm and audio families, the vision
    stub's image prefill, the encoder-conditioned round, and, unless
    ``side`` (the side processes take them), the serves' profiles and the
    reduced-width checks; returns the serves' and rounds' launches."""
    t0 = time.monotonic()
    launches = family_serves(smi, MULTIMODAL_SERVES,
                             () if side else MULTIMODAL_PROFILED)
    vlm_image_phase(smi)
    for kernel, n in audio_encdec_phase(smi).items():
        launches[kernel] += n
    if not side:
        timed_phase("multimodal-check", multimodal_check_phase)
    emit({"phase": "multimodal-total", "seconds": time.monotonic() - t0})
    return launches


# -- train phase ---------------------------------------------------------
# The reference's benchmark pair (``repro_torch.workloads``, the copy of
# benchmarks/common.py): four Markov corpora over 512 tokens, from
# predictable ("code") to not ("dialogue"), a target (smollm-135m
# reduced) trained 1600 steps and a draft (d 128) trained 1000 steps on
# their mixed stream.
# name: (cache tag, steps, seed, the reference's final loss: JAX on a
# CPU, build_pair("llama")); the card's must be within PAIR_LOSS_RTOL
PAIR_MODELS = {"target": ("target", 1600, 0, 4.781),
               "draft": ("draft_llama", 1000, 5, 5.030)}
# the gemma pair's weak draft (build_pair("gemma"): d 64, 180 steps,
# seed 9, on the code + news half-stream), trained on the card by the
# examples phase: the reference's final loss, JAX on a CPU through
# benchmarks/common._train_cached("draft_gemma", ...)
GEMMA_DRAFT_REFERENCE_LOSS = 6.087
PAIR_LOSS_RTOL = 0.05
# the model drafter's acceptance on code prompts must reach this, and
# this multiple of its acceptance on dialogue prompts (reference: 0.373
# and 0.409 under static SL 4 and dsde, about 2.5-2.7x dialogue's)
PAIR_MIN_CODE_ACCEPTANCE = 0.25
PAIR_MIN_CODE_OVER_DIALOGUE = 1.5
# card == CPU train steps.  The init's layer weights have std 0.71 (the
# reference's fan-in rule on the stacked [L, ...] shape: 1/sqrt(2) at
# the reduced width), so attention runs saturated and the gradient is
# nearly discontinuous in the params: at the recipe's lr 3e-3 a few Adam
# steps amplify fp32 rounding into visibly different params, in the
# reference too (its jitted and eager steps part).  At lr 1e-5 loss and
# params agree, but later grad norms part by far more than the loss
# (the train-check rows print each step's part), and even at equal
# params, the first step, the order of the fp32 sums moves the grad norm
# by more than 1e-4.  So the first step's grad norm is held to
# CHECK_GRAD_NORM_RTOL and later ones are printed only.
CHECK_OPT = dict(learning_rate=1e-5, warmup_steps=2, total_steps=10)
CHECK_GRAD_NORM_RTOL = 2e-3


class PairServe(NamedTuple):
    """One trained-pair serve with ``common.serve``'s settings: batch 8,
    max_seq_len 512, 48 new tokens, sf_normalize, sl_max 10."""
    name: str
    policy: str
    drafter: str
    kv_quant: str
    paged: bool
    path: Tuple[str, ...]
    vs_cpu: bool = False          # also served on the CPU: equal streams


PAIR_SERVES = (
    PairServe("pair-static", "static", "model", "none", True,
              ("paged_ragged_verify_attention", "fused_kld_accept")),
    PairServe("pair-dsde", "dsde", "model", "none", True,
              ("paged_ragged_verify_attention", "fused_kld_accept"),
              vs_cpu=True),
    PairServe("pair-dense", "dsde", "model", "none", False,
              ("ragged_verify_attention", "fused_kld_accept")),
    PairServe("pair-ngram-int8", "dsde", "ngram", "int8", True,
              ("ngram_suffix_propose", "paged_ragged_verify_attention_quant"),
              vs_cpu=True),
)


def logged_losses(text: str):
    """The losses ``train_loop`` printed, in step order."""
    import re
    return [float(x) for x in re.findall(r"step +\d+ loss=(\S+)", text)]


def finite(values) -> bool:
    import math
    return all(math.isfinite(v) for v in values)


def train_demo(smi) -> None:
    """The entry point, ``python -m repro_torch.launch.train --demo``, for
    60 steps on the card; its checkpoint must restore."""
    import contextlib
    import io
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.weights import init_params, param_leaves
    from repro_torch.training.checkpoint import restore_checkpoint
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            m = launch_train.main(["--arch", "smollm-135m", "--demo",
                                   "--steps", "60", "--ckpt-dir", tmp])
        losses = logged_losses(out.getvalue())
        template = init_params(get_config("smollm-135m").reduced(), seed=0,
                               device="cuda")
        restored, _ = restore_checkpoint(m["checkpoint"], template)
        leaves = [t for _, t in param_leaves(restored)]
    emit({"phase": "train-demo", "steps": m["steps"], "logged_losses": losses,
          "final": {k: v for k, v in m.items() if k != "checkpoint"},
          "restored_leaves": len(leaves), "seconds": time.monotonic() - t0,
          "nvidia_smi": smi})
    if len(losses) < 2 or not finite(losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train-demo: the loss did not fall: {losses}")
    if len(leaves) != 11 or not all(bool(t.isfinite().all()) for t in leaves):
        raise AssertionError("train-demo: the checkpoint did not restore")


def train_full_width(stream, smi, b=8, s=512, steps=20, skip=3,
                     must_fall=True) -> None:
    """smollm-135m at full width (30 layers, d 576, vocab 49280): 20 steps
    of B 8 x S 512 with remat through ``train_loop`` (or ``steps`` of B
    ``b`` x S ``s``: at S 2048 the attention is blockwise, and the losses
    need only be finite).  A step's time is the host clock between two
    batch requests, each after a synchronise; the first ``skip`` steps
    are left out."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig, TrainConfig
    from repro_torch.models.weights import param_leaves
    from repro_torch.training.data import lm_batches
    from repro_torch.training.train import train_loop
    cfg = get_config("smollm-135m")
    marks = []

    def timed(batches):
        for batch in batches:
            torch.cuda.synchronize()
            marks.append(time.monotonic())
            yield batch

    tc = TrainConfig(global_batch_size=b, seq_len=s, remat=True,
                     optimizer=OptimizerConfig(learning_rate=3e-3,
                                               warmup_steps=10,
                                               total_steps=steps,
                                               grad_clip=5.0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, m = train_loop(cfg, tc, timed(lm_batches(stream, b, s)),
                               num_steps=steps, log_every=1, device="cuda")
    seconds = time.monotonic() - t0
    losses = logged_losses(out.getvalue())
    n_params = sum(t.numel() for _, t in param_leaves(params))
    step_s = (marks[steps] - marks[skip]) / (steps - skip)
    tokens = b * s
    emit({"phase": "train-full-width", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "padded_vocab": params["embed"].shape[0], "params": n_params,
          "batch": b, "seq_len": s, "remat": True, "steps": m["steps"],
          "ms_per_step": 1e3 * step_s, "steps_timed": steps - skip,
          "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "model_flop_share_fp32": 6 * n_params * tokens / step_s / FP32_FLOP_S,
          "losses": losses, "seconds": seconds, "tf32": False,
          "blockwise_attention": s >= 2048, "nvidia_smi": smi})
    if len(losses) != steps or not finite(losses) or (
            must_fall and losses[-1] >= losses[0]):
        raise AssertionError(f"train-full-width S {s}: the loss did not fall "
                             f"or is not finite: {losses}")
    del params
    torch.cuda.empty_cache()


def train_step_check(stream) -> None:
    """``train_step`` on the card and on the CPU at the reduced width,
    from one seeded init over the same 5 batches, with and without remat
    and with 2 microbatches: per-step loss within 1e-4 relative and the
    final params within 1e-4; the first step's grad norm (both sides at
    the same params) within ``CHECK_GRAD_NORM_RTOL``."""
    import itertools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.weights import init_params, param_leaves
    from repro_torch.training.data import lm_batches
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.train import train_step
    cfg = get_config("smollm-135m").reduced()
    opt = OptimizerConfig(**CHECK_OPT)
    batches = list(itertools.islice(lm_batches(stream, 16, 64, seed=3), 5))
    for remat, micro in ((True, 1), (False, 1), (True, 2)):
        t0 = time.monotonic()
        runs = {}
        for device in ("cuda", "cpu"):
            p = init_params(cfg, seed=0, device=device)
            st = init_adamw(p)
            metrics = []
            for toks, labs in batches:
                p, st, m = train_step(p, st, torch.from_numpy(toks).to(device),
                                      torch.from_numpy(labs).to(device),
                                      cfg=cfg, opt_cfg=opt, remat=remat,
                                      microbatches=micro)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[device] = (p, metrics)
        rel = {k: [abs(a[k] / c[k] - 1)
                   for a, c in zip(runs["cuda"][1], runs["cpu"][1])]
               for k in ("loss", "grad_norm")}
        param_err = max(float((a.cpu() - c).abs().max()) for (_, a), (_, c) in
                        zip(param_leaves(runs["cuda"][0]),
                            param_leaves(runs["cpu"][0])))
        emit({"phase": "train-check", "what": "train_step card vs CPU, "
              "reduced width, 5 steps of 16 x 64", "remat": remat,
              "microbatches": micro, "lr": opt.learning_rate,
              "losses_cuda": [m["loss"] for m in runs["cuda"][1]],
              "grad_norms_cpu": [m["grad_norm"] for m in runs["cpu"][1]],
              "rel_err_loss": rel["loss"], "rel_err_grad_norm": rel["grad_norm"],
              "max_abs_err_params": param_err,
              "seconds": time.monotonic() - t0})
        if not (max(rel["loss"]) <= 1e-4 and param_err <= 1e-4
                and rel["grad_norm"][0] <= CHECK_GRAD_NORM_RTOL):
            raise AssertionError(f"train-check (remat={remat}, microbatches="
                                 f"{micro}): card and CPU part: {rel}, "
                                 f"{param_err}")


# full-width train steps of the other families (arch, reduced, encoder
# frames a row): qwen2-vl-2b on tokens, seamless-m4t-medium with encoder
# frames, mamba2-130m; recurrentgemma-2b only reduced (at fp32 with AdamW
# its 2.7e9 parameters need about 43 GB before activations)
FAMILY_TRAINS = (("qwen2-vl-2b", False, None), ("seamless-m4t-medium", False, 128),
                 ("mamba2-130m", False, None), ("recurrentgemma-2b", True, None))
FAMILY_TRAIN_SHAPE = dict(b=4, s=512, steps=10, skip=3)


def family_batches(stream, cfg, b, s, frames, device, seed=0):
    """Seeded train batches of ``cfg``: next-token pairs cut from
    ``stream`` (the pair's mixed Markov stream over 512 tokens, which
    every vocabulary holds), and for an encoder-decoder ``frames`` seeded
    encoder frames a row (None otherwise).  Yields (tokens, labels,
    encoder_embeds)."""
    import torch
    from repro_torch.training.data import lm_batches
    g = torch.Generator().manual_seed(seed)
    for toks, labs in lm_batches(stream, b, s, seed=seed, epochs=100):
        enc = (None if frames is None else
               (torch.randn(b, frames, cfg.d_model, generator=g) * 0.3
                ).to(device))
        yield (torch.from_numpy(toks).to(device),
               torch.from_numpy(labs).to(device), enc)


def family_train(stream, arch, reduced, frames, smi, b=4, s=512, steps=10,
                 skip=3):
    """``train_step`` (remat) for ``steps`` steps of B ``b`` x S ``s`` on
    the card from the port's seeded init (drawn on the card at full
    width), the demo's lr 3e-3 and clip 5.0 after 3 warm-up steps: every
    loss finite and the mean of the last three below the first (at lr
    3e-4 a 256k vocabulary's loss moves less in 10 steps than from batch
    to batch); ms a step past the first ``skip``, tokens/s and peak
    memory."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.weights import init_params, param_leaves
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.train import train_step
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    opt = OptimizerConfig(learning_rate=3e-3, warmup_steps=3,
                          total_steps=steps, grad_clip=5.0)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda",
                         rng_device="cpu" if reduced else "cuda")
    st = init_adamw(params)
    n_params = sum(t.numel() for _, t in param_leaves(params))
    losses, marks = [], []
    t0 = time.monotonic()
    for i, (toks, labs, enc) in enumerate(family_batches(stream, cfg, b, s,
                                                         frames, "cuda")):
        if i == steps:
            break
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        params, st, m = train_step(params, st, toks, labs, cfg=cfg,
                                   opt_cfg=opt, remat=True,
                                   encoder_embeds=enc)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    marks.append(time.monotonic())
    step_s = (marks[steps] - marks[skip]) / (steps - skip)
    row = {"phase": "train-family", "arch": cfg.name, "family": cfg.family,
           "reduced": reduced, "params": n_params, "batch": b, "seq_len": s,
           "encoder_frames": frames, "remat": True, "steps": steps,
           "ms_per_step": 1e3 * step_s, "steps_timed": steps - skip,
           "tokens_per_s": b * s / step_s,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "seconds": time.monotonic() - t0, "tf32": False,
           "nvidia_smi": smi}
    emit(row)
    if not finite(losses) or sum(losses[-3:]) / 3 >= losses[0]:
        raise AssertionError(f"train-family {cfg.name}: the loss did not "
                             f"fall: {losses}")
    del params, st
    gc.collect()
    torch.cuda.empty_cache()


def family_train_check(stream, arch, frames) -> None:
    """The first ``train_step`` of ``arch``'s reduced config on the card
    and on the CPU from one seeded init scaled by ``CONDITIONED`` (B 4 x
    S 64, lr 1e-5): the loss within 1e-4 relative, the grad norm within
    ``CHECK_GRAD_NORM_RTOL`` and the new params within 1e-4.  At the
    init's own scale seamless-m4t-medium's grad norm parts by 4.2e-3
    (PR 22's third card run), its encoder's gradients carrying the
    saturated cross-attention's rounding (as between the port and the
    reference on the CPU: ``tests/test_torch_training.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig
    from repro_torch.models.weights import (init_params, map_params,
                                            param_leaves)
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.train import train_step
    cfg = get_config(arch).reduced()
    toks, labs, enc = next(family_batches(stream, cfg, 4, 64, frames and 16,
                                          "cpu"))
    runs = {}
    for device in ("cuda", "cpu"):
        p = map_params(lambda a: a * CONDITIONED,
                       init_params(cfg, seed=0, device=device))
        p, _, m = train_step(p, init_adamw(p), toks.to(device),
                             labs.to(device), cfg=cfg,
                             opt_cfg=OptimizerConfig(**CHECK_OPT), remat=True,
                             encoder_embeds=None if enc is None
                             else enc.to(device))
        runs[device] = (p, {k: float(v) for k, v in m.items()})
    rel = {k: abs(runs["cuda"][1][k] / runs["cpu"][1][k] - 1)
           for k in ("loss", "grad_norm")}
    param_err = max(float((a.cpu() - c).abs().max()) for (_, a), (_, c) in
                    zip(param_leaves(runs["cuda"][0]),
                        param_leaves(runs["cpu"][0])))
    emit({"phase": "train-family-check", "arch": cfg.name,
          "what": "first train_step card vs CPU, reduced width, 4 x 64",
          "rel_err_loss": rel["loss"], "rel_err_grad_norm": rel["grad_norm"],
          "max_abs_err_params": param_err,
          "grad_norm_rtol": CHECK_GRAD_NORM_RTOL})
    if not (rel["loss"] <= 1e-4 and rel["grad_norm"] <= CHECK_GRAD_NORM_RTOL
            and param_err <= 1e-4):
        raise AssertionError(f"train-family-check {cfg.name}: card and CPU "
                             f"part: {rel}, {param_err}")


# smollm-135m's attention heads (H 9 / KV 3 / D 64) for the flash rows
FLASH_HEADS = (9, 3, 64)


def flash_rows(smi) -> None:
    """``flash_attend`` (blockwise, tiles of 512, the custom backward)
    against the quadratic ``attend`` at smollm-135m's heads, B 2, T 2048
    and 4096, causal: forward + backward ms (wall, over 3 calls), the
    peak memory each call allocates above its inputs, and the output's
    and each gradient's largest difference (within 1e-4)."""
    import torch
    from repro_torch.models.flash import flash_attend
    from repro_torch.models.layers import attend
    h, kv, d = FLASH_HEADS
    for t in (2048, 4096):
        g = torch.Generator(device="cuda").manual_seed(t)
        q, k, v, dout = (torch.randn(2, t, n, d, generator=g, device="cuda")
                         for n in (h, kv, kv, h))
        pos = torch.arange(t, device="cuda")[None].expand(2, t)
        valid = torch.ones((2, t), dtype=torch.bool, device="cuda")
        fns = {"flash": lambda q_, k_, v_: flash_attend(q_, k_, v_),
               "attend": lambda q_, k_, v_: attend(
                   q_, k_, v_, q_pos=pos, kv_pos=pos, kv_valid=valid)}
        res, row = {}, {"phase": "flash", "B": 2, "T": t, "H": h, "KV": kv,
                        "D": d, "causal": True, "nvidia_smi": smi}
        for name, fn in fns.items():
            def call():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                out = fn(*leaves)
                return (out.detach(),) + torch.autograd.grad(out, leaves,
                                                              dout)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res[name] = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            row[name] = {"fwd_bwd_ms": wall_ms(call, n=3),
                         "peak_extra_gib": peak / 2 ** 30}
        row["max_abs_diff"] = {n: float((a - b).abs().max()) for n, a, b in
                               zip(("out", "dq", "dk", "dv"), res["flash"],
                                   res["attend"])}
        emit(row)
        if max(row["max_abs_diff"].values()) > 1e-4:
            raise AssertionError(f"flash T {t}: flash and attend part: {row}")


def family_train_phase(smi, stream=None) -> None:
    """The other families' training (``FAMILY_TRAINS``: full-width steps,
    card == CPU first steps at the reduced width) on ``stream`` (default:
    ``workloads.mixed_stream()``), then the flash rows."""
    if stream is None:
        from repro_torch import workloads
        stream = workloads.mixed_stream()
    for arch, reduced, frames in FAMILY_TRAINS:
        family_train(stream, arch, reduced, frames, smi, **FAMILY_TRAIN_SHAPE)
        family_train_check(stream, arch, frames)
    flash_rows(smi)


def train_pair(stream, smi):
    """The reference pair's recipe (``workloads.train_model``: batch 16 x
    64, lr 3e-3, warmup 30, clip 5.0) on the card from the port's seeded
    init; each final loss within 5% of the reference's, each model then
    saved to ``workloads``' cache (``REPRO_TORCH_BENCH_CACHE``, a fresh
    directory of this run's), where the examples phase's
    ``build_pair("llama")`` finds it."""
    import os
    from repro_torch import workloads
    from repro_torch.training.checkpoint import save_checkpoint
    out = {}
    cfgs = {"target": workloads.target_config(),
            "draft": workloads.draft_config()}
    for name, (tag, steps, seed, ref_loss) in PAIR_MODELS.items():
        cfg = cfgs[name]
        params, m = workloads.train_model(cfg, stream, steps, seed,
                                          device="cuda")
        emit({"phase": "train-pair", "model": name, "arch": cfg.name,
              "d_model": cfg.d_model, "layers": cfg.num_layers,
              **m, "ms_per_step": 1e3 * m["wall_s"] / m["steps"],
              "reference_loss": ref_loss,
              "loss_rel_to_reference": m["loss"] / ref_loss - 1,
              "nvidia_smi": smi})
        if not abs(m["loss"] / ref_loss - 1) <= PAIR_LOSS_RTOL:
            raise AssertionError(f"train-pair: {name} ends at {m['loss']}, "
                                 f"not within {PAIR_LOSS_RTOL:.0%} of the "
                                 f"reference's {ref_loss}")
        out[name] = (cfg, params)
    for name, (tag, steps, _, _) in PAIR_MODELS.items():
        save_checkpoint(os.path.join(workloads.CACHE_DIR, tag), steps,
                        out[name][1])
    return out


def pair_serve(ps: PairServe, pair, prompts, device):
    """(summary, requests, engine, dispatch syncs, seconds of its run) of
    one trained-pair serve on ``device``."""
    import torch
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    (cfg_t, pt), (cfg_d, pd) = pair["target"], pair["draft"]
    model = ps.drafter == "model"
    spec = SpecDecodeConfig(policy=ps.policy, drafter=ps.drafter,
                            static_sl=4, sl_max=10, use_sl_cap=True,
                            sf_normalize=True)
    eng = ServingEngine(pt, cfg_t, pd if model else None,
                        cfg_d if model else None, spec,
                        ServingConfig(max_batch_size=8, max_seq_len=512,
                                      paged_kv=ps.paged, kv_block_size=16,
                                      kv_quant=ps.kv_quant),
                        seed=0, device=device)
    syncs = count_syncs(eng) if device == "cuda" else collections.Counter()
    reqs = [Request(i, prompt=p, max_new_tokens=48)
            for i, p in enumerate(prompts)]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    m = eng.run(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    return m, reqs, eng, syncs, time.monotonic() - t0


def pair_serves(pair, smi):
    """Each ``PAIR_SERVES`` entry on code and on dialogue prompts (6 of 12
    tokens each, ``prompts(6, 12, seed=1)``) on the card; its kernels
    must launch in it, dispatch must make no synchronising call, and the
    model drafter on the pool must accept well on code.  Returns the
    launches summed over the serves, and the card's streams."""
    from repro_torch import workloads
    total = {k: 0 for k in read_launches()}
    acceptance, streams = {}, {}
    for ps in PAIR_SERVES:
        for corpus in ("code", "dialogue"):
            prompts = workloads.dataset(corpus).prompts(6, 12, seed=1)
            reset_launches()
            m, reqs, eng, syncs, wall = pair_serve(ps, pair, prompts, "cuda")
            launches = read_launches()
            for k in total:
                total[k] += launches[k]
            proposing = [r for r in eng.round_log if r["k"] > 0]
            acceptance[ps.name, corpus] = m["mean_acceptance"]
            streams[ps.name, corpus] = [r.output for r in reqs]
            emit({"phase": ps.name, "prompts": corpus, "policy": ps.policy,
                  "drafter": ps.drafter, "kv_quant": ps.kv_quant,
                  "paged_kv": ps.paged, "requests": len(reqs),
                  "rounds": m["rounds"], "tokens": m["tokens_emitted"],
                  "mean_acceptance": m["mean_acceptance"],
                  "block_efficiency": m["block_efficiency"],
                  "mean_k": (sum(r["k"] for r in proposing)
                             / max(len(proposing), 1)),
                  "mean_proposed_sl": (sum(r["proposed"] for r in proposing)
                                       / max(sum(r["b_eff"] for r in proposing),
                                             1)),
                  "draft_steps": m["draft_steps"], "wall_s": wall,
                  "tokens_per_s": m["tokens_emitted"] / wall,
                  "dispatch_syncs": sum(syncs.values()),
                  "dispatch_sync_sources": dict(syncs),
                  "launches": launches, "nvidia_smi": smi})
            if min(launches[k] for k in ps.path) <= 0:
                raise AssertionError(f"{ps.name} ({corpus}): a kernel of the "
                                     f"path never ran: {launches}")
            if sum(syncs.values()):
                raise AssertionError(f"{ps.name} ({corpus}): dispatch "
                                     f"synchronised: {dict(syncs)}")
            if m["requests_finished"] != 6 or any(len(r.output) != 48
                                                  for r in reqs):
                raise AssertionError(f"{ps.name} ({corpus}) did not finish "
                                     f"every request: {m}")
    for name in ("pair-static", "pair-dsde"):
        code, dialogue = acceptance[name, "code"], acceptance[name, "dialogue"]
        if not (code >= PAIR_MIN_CODE_ACCEPTANCE
                and code >= PAIR_MIN_CODE_OVER_DIALOGUE * dialogue):
            raise AssertionError(f"{name}: acceptance {code} on code against "
                                 f"{dialogue} on dialogue")
    return total, streams


def pair_card_equal_cpu(pair, streams) -> None:
    """The card-trained pair copied to the CPU: the engine on the plain
    kernels must emit the card's greedy streams."""
    from repro_torch import workloads
    from repro_torch.models.weights import map_params
    cpu_pair = {k: (cfg, map_params(lambda t: t.cpu(), p))
                for k, (cfg, p) in pair.items()}
    for ps in PAIR_SERVES:
        if not ps.vs_cpu:
            continue
        for corpus in ("code", "dialogue"):
            prompts = workloads.dataset(corpus).prompts(6, 12, seed=1)
            _, reqs, _, _, wall = pair_serve(ps, cpu_pair, prompts, "cpu")
            same = [r.output for r in reqs] == streams[ps.name, corpus]
            emit({"phase": "pair-check", "serve": ps.name, "prompts": corpus,
                  "what": "trained-pair greedy streams, card vs CPU",
                  "equal": same, "cpu_seconds": wall})
            if not same:
                raise AssertionError(f"{ps.name} ({corpus}): card and CPU "
                                     "streams differ")


def train_phase(smi, side=None):
    """Training on the card, then the trained pair served through the
    DSDE round (the corpus built and the pair trained here, or by the
    ``train`` side process ``side``); returns the serves' kernel
    launches."""
    t0 = time.monotonic()
    train_demo(smi)
    t1 = time.monotonic()
    if side:
        stream = side_stream(side)
    else:
        from repro_torch import workloads
        stream = workloads.mixed_stream()
    emit({"phase": "train-corpus", "tokens": int(stream.shape[0]),
          "seconds": time.monotonic() - t1})
    train_full_width(stream, smi)
    train_step_check(stream)
    family_train_phase(smi, stream)
    train_full_width(stream, smi, b=2, s=2048, steps=5, skip=2,
                     must_fall=False)
    pair = side_pair(side) if side else train_pair(stream, smi)
    launches, streams = pair_serves(pair, smi)
    pair_card_equal_cpu(pair, streams)
    emit({"phase": "train-total", "seconds": time.monotonic() - t0})
    return launches


# -- examples phase and the full-width trace replay ------------------------
# The paper pipeline's entry points (``repro_torch.examples``), each
# ``main`` run on the card as a user runs it (the default device): (module,
# flags, whether it serves the trained llama pair).  The two smoke runs
# make sure of B3 and B4 (n-gram x int8) and of B1 (prefix caching on
# the pool); the full runs serve the pair the ``train`` side process
# trained (``workloads``' cache), and ``low_acceptance_regime`` trains
# the gemma pair's draft on the card.
EXAMPLES = (
    ("quickstart", (), False),
    ("serve_dynamic_sl", ("--smoke", "--drafter", "ngram", "--kv-quant",
                          "int8"), False),
    ("serve_dynamic_sl", ("--smoke", "--prefix-share", "0.5"), False),
    ("serve_dynamic_sl", (), True),
    ("stream_serving", (), True),
    ("train_draft_model", (), True),
    ("low_acceptance_regime", (), True),
)
# the kernels the phase must launch, over all its runs
EXAMPLE_KERNELS = ("paged_ragged_verify_attention", "fused_kld_accept",
                   "ngram_suffix_propose",
                   "paged_ragged_verify_attention_quant",
                   "ragged_verify_attention")
# the summary fields each example run prints per serve
EXAMPLE_FIELDS = ("rounds", "tokens_emitted", "draft_steps",
                  "draft_steps_effective", "mean_acceptance",
                  "block_efficiency", "latency_units", "k_opt", "loss",
                  "wall_time_s", "requests_finished")


@contextlib.contextmanager
def engine_syncs():
    """Every ``ServingEngine`` made in the block counts its dispatch's
    synchronising calls (:func:`count_syncs`); the counts, summed, fill
    the yielded Counter when the block ends."""
    from repro_torch.serving.engine import ServingEngine
    counters, init = [], ServingEngine.__init__

    def counted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        counters.append(count_syncs(self))

    total = collections.Counter()
    ServingEngine.__init__ = counted
    try:
        yield total
    finally:
        ServingEngine.__init__ = init
        for c in counters:
            total.update(c)


def example_runs(out):
    """The serves of an example's result, by label: their
    ``EXAMPLE_FIELDS``."""
    runs = {}
    for label, m in out.items():
        if isinstance(m, dict) and "rounds" in m:
            runs[label] = {k: m[k] for k in EXAMPLE_FIELDS if k in m}
    return runs


def examples_phase(smi, side=False):
    """Each of ``EXAMPLES``' ``main`` on the card, its printed lines and
    its serves' rounds, acceptance and latency units, dispatch syncs
    (must be 0) and launches in rows of their own; its own assertions
    hold inside it.  A trained-pair run first waits for the ``train``
    side process's pair (``side``; run alone, ``build_pair`` trains it
    here); ``stream_serving``'s timed arrivals run under
    :func:`side_lock`.  The gemma draft's final loss must be within
    ``PAIR_LOSS_RTOL`` of the reference's, and every kernel of
    ``EXAMPLE_KERNELS`` must launch.  Returns the phase's launches."""
    import importlib
    import io
    import re
    import torch
    t_phase = time.monotonic()
    total = {k: 0 for k in read_launches()}
    for name, flags, trained in EXAMPLES:
        if trained and side:
            side_file(pair_done())
        module = importlib.import_module(f"repro_torch.examples.{name}")
        printed = io.StringIO()
        lock = (side_lock() if name == "stream_serving"
                else contextlib.nullcontext())
        reset_launches()
        with lock, engine_syncs() as syncs:
            t0 = time.monotonic()
            with contextlib.redirect_stdout(printed):
                out = module.main(list(flags))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches = read_launches()
        for k in total:
            total[k] += launches[k]
        label = " ".join((name,) + flags)
        lines = printed.getvalue().splitlines()
        emit({"phase": "example-printed", "example": label, "lines": lines})
        row = {"phase": "example", "example": label, "seconds": wall,
               "runs": example_runs(out), "dispatch_syncs": sum(syncs.values()),
               "dispatch_sync_sources": dict(syncs), "launches": launches,
               "nvidia_smi": smi}
        if name == "stream_serving":
            row["replay"] = out["replay"]["report"]
        emit(row)
        if sum(syncs.values()):
            raise AssertionError(f"example {label}: dispatch synchronised: "
                                 f"{dict(syncs)}")
        if name == "low_acceptance_regime":
            found = re.findall(r"trained draft_gemma: steps=180 loss=(\S+)",
                               printed.getvalue())
            if len(found) != 1:
                raise AssertionError("low_acceptance_regime did not train "
                                     f"the gemma draft: {lines}")
            loss, ref = float(found[0]), GEMMA_DRAFT_REFERENCE_LOSS
            emit({"phase": "example-gemma-draft", "loss": loss,
                  "reference_loss": ref, "loss_rel_to_reference": loss / ref - 1,
                  "nvidia_smi": smi})
            if not abs(loss / ref - 1) <= PAIR_LOSS_RTOL:
                raise AssertionError(f"the gemma draft ends at {loss}, not "
                                     f"within {PAIR_LOSS_RTOL:.0%} of the "
                                     f"reference's {ref}")
    emit({"phase": "examples-total", "seconds": time.monotonic() - t_phase,
          "launches": total})
    missing = [k for k in EXAMPLE_KERNELS if total[k] <= 0]
    if missing:
        raise AssertionError(f"examples: {missing} never launched: {total}")
    return total


# The full-width trace replay: smollm-135m at 30 layers
# (``serve_weights``) behind ``stream_serving``'s engine (the fp32 pool in
# blocks of 16, pipelined, dsde, batch 4, 256 tokens), a seeded bursty
# trace replayed open loop through the front-end's driver thread.  The
# random weights accept near 0: acceptance is printed, not judged.
LOADGEN_TRACE = dict(n_requests=16, rate_rps=4.0, process="bursty", seed=13,
                     max_new_cap=16)
LOADGEN_KERNELS = ("paged_ragged_verify_attention", "fused_kld_accept")
LOADGEN_REPORT = ("requests", "requests_finished", "requests_rejected",
                  "tokens_emitted", "preemptions", "wall_s", "ttft_s_p50",
                  "ttft_s_p99", "tpot_s_p50", "tpot_s_p99",
                  "queue_wait_s_p50", "queue_wait_s_p99", "queue_depth_peak",
                  "throughput_tok_s", "goodput_tok_s", "slo_attained_frac")


def loadgen_phase(smi):
    """The trace of ``LOADGEN_TRACE`` replayed open loop (its report's
    TTFT / TPOT percentiles, queue depth, throughput and goodput), then
    ``replay_at_zero`` and ``run()`` of the same trace, whose streams
    must be equal; B1 and B2 must launch in the replays and dispatch
    make no synchronising call.  The replays, whose reports read the
    clock, run under :func:`side_lock`.  Returns the replays'
    launches."""
    import torch
    from repro_torch.examples.stream_serving import make_engine
    from repro_torch.serving import loadgen
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import Request

    t_phase = time.monotonic()
    cfg, pt, pd = serve_weights()

    def engine():
        return make_engine(cfg, cfg, pt, pd, "cuda")

    trace = loadgen.make_trace(**LOADGEN_TRACE)
    # one-time set-up (library handles, allocator pools) outside the run
    engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
    total = {k: 0 for k in read_launches()}
    row = {"phase": "loadgen", "arch": cfg.name, "layers": cfg.num_layers,
           "trace": LOADGEN_TRACE, "nvidia_smi": smi}
    streams = {}
    for mode in ("open-loop", "replay-at-zero"):
        reset_launches()
        with side_lock(), engine_syncs() as syncs:
            fe = ServingFrontend(engine())
            if mode == "open-loop":
                fe.start()
                try:
                    point = loadgen.replay(fe, trace)
                finally:
                    fe.stop()
            else:
                point = loadgen.replay_at_zero(fe, trace)
            torch.cuda.synchronize()
        launches = read_launches()
        for k in total:
            total[k] += launches[k]
        m = fe.summary()
        streams[mode] = [r.output for r in sorted(fe.finished,
                                                  key=lambda r: r.request_id)]
        row[mode] = {**{k: point[k] for k in LOADGEN_REPORT},
                     "offered_rps": point["offered_rps"],
                     "rounds": m["rounds"],
                     "mean_acceptance": m["mean_acceptance"],
                     "block_efficiency": m["block_efficiency"],
                     "dispatch_syncs": sum(syncs.values()),
                     "dispatch_sync_sources": dict(syncs),
                     "launches": launches}
        if min(launches[k] for k in LOADGEN_KERNELS) <= 0:
            raise AssertionError(f"loadgen {mode}: a kernel of the path "
                                 f"never ran: {launches}")
        if sum(syncs.values()):
            raise AssertionError(f"loadgen {mode}: dispatch synchronised: "
                                 f"{dict(syncs)}")
        if point["requests_finished"] != LOADGEN_TRACE["n_requests"]:
            raise AssertionError(f"loadgen {mode}: not every request "
                                 f"finished: {point}")
    run = loadgen.trace_requests(trace)
    engine().run(run)
    streams["run"] = [r.output for r in run]
    row["replay_at_zero_equal_to_run"] = streams["replay-at-zero"] == streams["run"]
    # greedy streams do not depend on arrival times but for fp32 near
    # ties between batch compositions: printed, not required
    row["open_loop_equal_to_run"] = streams["open-loop"] == streams["run"]
    row["seconds"] = time.monotonic() - t_phase
    emit(row)
    if not row["replay_at_zero_equal_to_run"]:
        raise AssertionError("loadgen: replay at arrival 0 differs from "
                             "run()")
    if not all(0 <= t < cfg.vocab_size for s in streams["run"] for t in s):
        raise AssertionError("loadgen: a token outside the vocabulary")
    return total


# the device kernels of the port's CUDA sources, by name; the attention
# kernels' names carry their addressing policy (pv::TableAddr for B1 and
# B4, pv::RingAddr for B5) as the first template argument
PORT_KERNELS = ("pv::verify_kernel", "pv::wide_mma_kernel", "pv::merge_kernel",
                "kld_accept_kernel", "ngram_match_kernel")


# rounds a profiled run traces (formerly 6, then 3, then 2: the traces'
# processing on the host, about 1 ms a kernel launch traced, took a
# quarter to a third of the script's time, and at 2 rounds still 205 s
# of a 1173.6 s run on an H100 80GB HBM3 with a slow host), and the
# requests it admits (formerly 4: the ten profiles took 115 s of a
# 929.6 s run on an H100 80GB HBM3, 700.00 W; fewer requests, fewer
# prefills traced)
PROFILE_ROUNDS = 1
PROFILE_REQUESTS = 2


def profile_phase(serve, engine, reqs) -> None:
    """The first ``PROFILE_REQUESTS`` requests of ``serve`` again, for
    their prefill and first ``PROFILE_ROUNDS`` rounds, under ``torch.profiler``: device kernel time
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
             for r in reqs[:PROFILE_REQUESTS]]
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with side_lock():
            t0 = time.monotonic()
            eng.run(again, max_rounds=PROFILE_ROUNDS)
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


# one serve A/B run: ``SERVES[0]`` at argv[3] tokens a request on the
# package of the tree whose ``src`` is argv[2], this file's harness
_SERVE_AB_CHILD = """
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
chip_smoke.serve_ab_run(int(sys.argv[3]))
"""

# the full serves' former depth (new tokens a request), for comparing a
# change with a parent that served at it
SERVE_AB_NEW = 32


def serve_ab_run(new: int, reps: int = 3) -> None:
    """``SERVES[0]`` (smollm-135m at full width, the model drafter, the
    fp32 pool) with 8 requests of ``new`` tokens, ``reps`` times after a
    warm-up serve, untraced: tokens/s and ``host_blocked_s`` of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.models.weights import init_params, map_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    sv = SERVES[0]
    cfg = get_config("smollm-135m")
    pt = init_params(cfg, seed=0, device="cuda")
    noise = init_params(cfg, seed=1, device="cuda")
    pd = map_params(lambda a, n: a + 0.03 * n, pt, noise)
    serving = ServingConfig(max_batch_size=4, max_seq_len=256,
                            pipelined=sv.pipelined, paged_kv=True,
                            kv_block_size=16, num_kv_blocks=sv.nblocks,
                            kv_quant=sv.kv_quant)

    def engine():
        return ServingEngine(pt, cfg, pd, cfg,
                             SpecDecodeConfig(policy=sv.policy,
                                              drafter=sv.drafter),
                             serving, seed=0, device="cuda")
    engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
    for rep in range(reps):
        reqs = [Request(i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(serve_prompts(cfg.vocab_size,
                                                    sv.drafter))]
        eng = engine()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        m = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if any(len(r.output) != new for r in reqs):
            raise AssertionError(f"serve A/B: a request fell short: {m}")
        emit({"phase": "serve-ab", "serve": sv.name, "rep": rep,
              "new_tokens": new, "rounds": m["rounds"],
              "tokens": m["tokens_emitted"], "wall_s": wall,
              "tokens_per_s": m["tokens_emitted"] / wall,
              "host_blocked_s": m["host_blocked_s"]})


def serve_ab_phase(parent: Path) -> None:
    """:func:`serve_ab_run` at ``SERVE_AB_NEW`` tokens on ``parent``'s
    package and this tree's in turns (parent, change, change, parent),
    each in a process of its own on this card: the host cost of a change
    to the serve path, at the parent's depth."""
    trees = (("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent))
    for i, (tag, tree) in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", _SERVE_AB_CHILD,
                               str(ROOT), str(tree / "src"),
                               str(SERVE_AB_NEW)], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"serve A/B run {i} ({tag}) failed:\n"
                               + proc.stdout[-4000:] + proc.stderr[-4000:])
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit(dict(json.loads(line), ab_run=i, tree=tag))


# the sources whose ptxas reports the A/B compares (B1 and B5: the wide
# heads' kernel of this change)
AB_PTXAS_SOURCES = ("paged_attention", "ragged_attention")


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


# -- dryrun phase --------------------------------------------------------
# The dry run (repro_torch/launch/dryrun.py): production combinations on
# the 16 x 16 fake mesh (predictions of a cost model on the H100 SXM's
# data-sheet figures), then each one-card step predicted on a 1 x 1 mesh
# and run for real on the card: FLOPs outside the kernels, kernel calls
# and argument bytes must equal the prediction's, the peak be within 15%.
DRYRUN_COMBOS = (("smollm-135m", "decode_32k"), ("granite-8b", "train_4k"),
                 ("qwen3-32b", "decode_32k"))
# (arch, shape, batch, seq_len, opts): decode and verify on a ring of
# 2048 slots, prefill B 4 x 512, smollm's train step B 4 x 512
ONE_CARD_STEPS = (
    ("smollm-135m", "decode_32k", 4, 2048, ()),
    ("smollm-135m", "decode_32k", 4, 2048, ("verify",)),
    ("smollm-135m", "prefill_32k", 4, 512, ()),
    ("smollm-135m", "train_4k", 4, 512, ()),
    ("granite-8b", "decode_32k", 4, 2048, ()),
    ("granite-8b", "decode_32k", 4, 2048, ("verify",)),
    ("granite-8b", "prefill_32k", 4, 512, ()),
)
PEAK_TOL = 0.15


def kernel_calls():
    """The five kernels' call counters (each wrapper adds one a call)."""
    from repro_torch.kernels import (kld_accept, ngram_match, paged_attention,
                                     paged_attention_quant, ragged_attention)
    out = {}
    for mod in (kld_accept, ngram_match, paged_attention,
                paged_attention_quant, ragged_attention):
        out.update(mod.LAUNCHES)
    return out


def dryrun_phase(smi):
    """The dry run's production combinations, then the one-card check of
    each of ``ONE_CARD_STEPS`` (see above): prints the per-device
    predictions, then for each step the prediction beside the card's
    FLOPs (``FlopCounterMode``), kernel calls, argument bytes, peak
    (``max_memory_allocated`` after ``reset_peak_memory_stats``; memory
    the card held besides the arguments when the count was reset is left
    out), median ms of 10 CUDA-event-timed calls after a warm-up, and the
    roofline share max(compute_s, memory_s) / measured (``memory_s``: the
    bytes the step must move, ``launch.dryrun.roofline``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.core.config import INPUT_SHAPES
    from repro_torch.launch.dryrun import dryrun_one, one_card
    from repro_torch.launch.steps import concrete_args
    t0 = time.monotonic()
    for arch, shape in DRYRUN_COMBOS:
        t = time.monotonic()
        rec = dryrun_one(arch, shape, verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} x {shape}: {rec}")
        emit({"phase": "dryrun", "arch": arch, "shape": shape,
              "mesh": rec["mesh"], "seconds": time.monotonic() - t,
              "label": "dry run, H100 SXM data-sheet figures",
              **{k: rec[k] for k in (
                  "flops_per_device", "bytes_per_device",
                  "collective_bytes_per_device", "collectives",
                  "kernel_calls", "memory", "roofline",
                  "model_flops_per_device", "fake_device")}})
    torch.ones(64, 64, device="cuda", dtype=torch.bfloat16).matmul(
        torch.ones(64, 64, device="cuda", dtype=torch.bfloat16))
    for arch, shape, b, s, opts in ONE_CARD_STEPS:
        t = time.monotonic()
        opts = frozenset(opts)
        rec, step = one_card(arch, shape, batch=b, seq_len=s, opts=opts)
        args = concrete_args(get_config(arch), INPUT_SHAPES[shape], batch=b,
                             seq_len=s, device="cuda", opts=opts)
        seen = {}
        for x in flat_tensors(args):
            seen[x.untyped_storage().data_ptr()] = \
                x.untyped_storage().nbytes()
        arg_bytes = sum(seen.values())
        out = step(*args)                        # warm-up
        del out
        torch.cuda.synchronize()
        before = kernel_calls()
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        torch.cuda.synchronize()
        calls = {k: n - before[k] for k, n in kernel_calls().items()
                 if n != before[k]}
        del out
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - arg_bytes
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - other
        del out
        ms = statistics.median(timings(lambda: step(*args), iters=10))
        flops_outside = rec["flops"] - rec["kernel_flops"]
        roof = rec["roofline"]
        bound_ms = 1e3 * max(roof["compute_s"], roof["memory_s"])
        row = {"phase": "dryrun-one-card", "arch": arch, "shape": shape,
               "B": b, "S": s, "opts": sorted(opts),
               "predicted_flops_outside_kernels": flops_outside,
               "measured_flops": fc.get_total_flops(),
               "predicted_kernel_calls": rec["kernel_calls"],
               "measured_kernel_calls": calls,
               "predicted_argument_bytes": rec["memory"]["argument_bytes"],
               "measured_argument_bytes": arg_bytes,
               "predicted_peak_bytes": rec["memory"]["peak_bytes"],
               "measured_peak_bytes": peak,
               "predicted_bytes": rec["bytes"],
               "predicted_flops": rec["flops"],
               "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
               "eager_memory_s": roof["eager_memory_s"],
               "ms_median": ms, "roofline_share": bound_ms / ms,
               "nvidia_smi": smi, "seconds": time.monotonic() - t}
        emit(row)
        what = f"one-card {arch} {shape} {sorted(opts)}"
        if fc.get_total_flops() != flops_outside:
            raise AssertionError(f"{what}: FLOPs {fc.get_total_flops()} != "
                                 f"predicted {flops_outside}")
        if calls != {k: int(v) for k, v in rec["kernel_calls"].items()}:
            raise AssertionError(f"{what}: kernel calls {calls} != "
                                 f"{rec['kernel_calls']}")
        if arg_bytes != rec["memory"]["argument_bytes"]:
            raise AssertionError(f"{what}: argument bytes {arg_bytes} != "
                                 f"{rec['memory']['argument_bytes']}")
        if abs(rec["memory"]["peak_bytes"] - peak) > PEAK_TOL * peak:
            raise AssertionError(f"{what}: peak {peak} vs predicted "
                                 f"{rec['memory']['peak_bytes']}")
        del args
        torch.cuda.empty_cache()
    emit({"phase": "dryrun-total", "seconds": time.monotonic() - t0})


# ---------------------------------------------------------------------------
# the serving mesh (ROADMAP A10)
# ---------------------------------------------------------------------------

# the serve phase's serves that the mesh serves again: the fp32 pool, the
# dense ring (synchronous and pipelined) and the damped n-gram drafter on
# the int8 pool; each meshed serve must emit its twin's streams
MESH_TWINS = ("serve", "serve-dense", "serve-dense-pipe", "serve-ngram-int8")
MESH_NCCL_TWINS = ("serve", "serve-dense")
# ranks that share card 0 over gloo: 1 x 3 splits smollm's 9 query and 3
# KV heads (and its MLP) three ways, its vocabulary 49280 not; 2 x 2
# splits the MLP and the vocabulary, replicates the heads, and splits the
# ring's rows and the n-gram history over data
MESH_SHARED = ("1x3", "2x2")
# the shared-card meshes serve the first 3 of smollm's 30 layers, against
# unmeshed twins of the same depth: the ranks time-slice one card, and a
# gloo all-reduce there took 5.7 ms (1 x 3, 30 layers: 234 s for the four
# serves, 50-60 s for each pool or ring serve; at 6 layers the three
# worlds, side by side, took 113.9 s of an 841.1 s run on an H100 80GB
# HBM3, 700.00 W with a slow host, their 11 ranks more than its 8 CPU
# cores).  At 30 layers the damped
# n-gram x int8 serve parts from its twin on 1 x 3; ``--only
# mesh-witness`` records why (split sums move K/V a few units in the last
# place, int8 rounding makes some of them whole quanta)
MESH_SHARED_LAYERS = 3
# tokens a request of the shared-card and family worlds (and of their
# twins; the NCCL serves emit ``SERVE_NEW``, their twins the serve
# phase's): their rounds' collectives and clock broadcasts, not their
# layers, set a world's pace
MESH_NEW = 8
MESH_RANK_TIMEOUT_S = 600
# the front door on the mesh: the 2 x 2 world also serves the frontdoor
# phase's fp32 and damped n-gram x int8 warm serves (prefix caching), the
# front-end's driver thread with staggered arrivals (pipelined, on the
# cached pool) and one non-streaming and one streaming HTTP completion on
# rank 0, each against a twin of its depth on one card; mesh-1x1-nccl
# serves the fp32 warm serve at the frontdoor phase's depth
MESH_FRONTDOOR = ("warm", "warm-ngram-int8", "frontend", "http")
MESH_SHARED_SERVES = {"1x3": MESH_TWINS, "2x2": MESH_TWINS + MESH_FRONTDOOR}


class DoorServe(NamedTuple):
    """A front-end or HTTP row of the mesh: the kernels its path runs."""
    name: str
    path: Tuple[str, ...]


DOOR_SERVES = (DoorServe("frontend", ("paged_ragged_verify_attention",
                                      "fused_kld_accept")),
               DoorServe("http", ("paged_ragged_verify_attention",
                                  "fused_kld_accept")))
# the launcher under torchrun --nproc-per-node 1 on a 1 x 1 mesh: (arch,
# mode arguments)
MESH_LAUNCHERS = (("smollm-135m", ("--demo",)),
                  ("smollm-135m", ("--http-smoke",)),
                  ("smollm-135m", ("--demo", "--paged", "--prefix-share",
                                   "0.5")))


def serve_by_name(name):
    return next(sv for sv in SERVES if sv.name == name)


def mesh_serve(cfg, pt, pd, sv, mesh, warm_up=False, engine=serve_engine,
               new=SERVE_NEW):
    """One meshed serve of ``sv`` (``warm_up``: after a one-request run,
    the process's one-time set-up; ``engine``: its engine's builder;
    ``new``: tokens a request): this rank's streams, wall, rounds,
    collectives, dispatch syncs and kernel launches."""
    import torch
    from repro_torch.core import tp
    from repro_torch.serving.request import Request

    if warm_up:
        engine(cfg, pt, pd, sv, mesh).run(
            [Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
    eng = engine(cfg, pt, pd, sv, mesh)
    syncs = count_syncs(eng)
    reqs = serve_requests(cfg, sv, new)
    reset_launches()
    tp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    m = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"streams": [r.output for r in reqs], "wall_s": wall,
            "rounds": m["rounds"], "tokens": m["tokens_emitted"],
            "finished": m["requests_finished"],
            "collectives": dict(tp.COUNTS), "launches": read_launches(),
            "dispatch_syncs": sum(syncs.values()),
            "dispatch_sync_sources": dict(syncs)}


def mesh_rank_main(spec, rank, store, out, names) -> int:
    """One rank of a shared-card mesh (``--mesh-rank``): gloo over a
    FileStore, card 0, this rank's shards of the serve phase's weights,
    the serves ``names`` (comma-separated); its results to ``out``
    (JSON)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.tp import MeshPlan
    from repro_torch.launch.mesh import parse_mesh, serving_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    d, m = parse_mesh(spec)
    dist.init_process_group("gloo", store=dist.FileStore(store, d * m),
                            rank=rank, world_size=d * m)
    try:
        plan = MeshPlan.for_mesh(serving_mesh(spec, share_card=True), 4)
        cfg, pt, pd = serve_weights(plan, MESH_SHARED_LAYERS)
        res = {name: (door_serve(cfg, pt, pd, name, plan)
                      if name in MESH_FRONTDOOR else
                      mesh_serve(cfg, pt, pd, serve_by_name(name), plan,
                                 warm_up=i == 0, new=MESH_NEW))
               for i, name in enumerate(names.split(","))}
        Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def door_frontend(eng, cfg, new=MESH_NEW):
    """The front-end over a meshed ``eng``: rank 0 starts its driver
    thread and submits ``frontdoor_prompts`` 50 ms apart, every other
    rank follows.  Returns (the requests this rank served, rank 0's
    handles' streams and whether each rebuilds its request's output: each
    token once, in order)."""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import Request

    fe = ServingFrontend(eng)
    if not fe.leader:
        return sorted(fe.follow(), key=lambda r: r.request_id), {}
    fe.start()
    handles = []
    for i, p in enumerate(frontdoor_prompts(cfg.vocab_size)):
        handles.append(fe.submit_request(Request(i, prompt=list(p),
                                                 max_new_tokens=new)))
        time.sleep(0.05)
    if not fe.wait_idle(timeout=300):
        raise AssertionError("the meshed front-end did not go idle")
    fe.stop()
    results = [h.result(timeout=30) for h in handles]
    return [h.request for h in handles], {
        "streams": [toks for toks, _ in results],
        "once_in_order": all(toks == h.request.output
                             for (toks, _), h in zip(results, handles))}


def door_http(eng, cfg, new=MESH_NEW):
    """One non-streaming and one streaming completion of ``http_prompt``
    through the HTTP server on rank 0 of a meshed ``eng`` (over loopback,
    the front-end's driver thread beside it); every other rank follows.
    Returns (the requests a follower served, rank 0's two streams and
    its count of finished requests)."""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.server import (smoke_check,
                                            start_http_server_thread)

    fe = ServingFrontend(eng)
    if not fe.leader:
        return sorted(fe.follow(), key=lambda r: r.request_id), {}
    fe.start()
    port, stop = start_http_server_thread(fe, model_name=cfg.name)
    try:
        res = smoke_check("127.0.0.1", port, http_prompt(cfg.vocab_size),
                          max_tokens=new)
    finally:
        stop()
        fe.stop()
    return [], {
        "streams": [res["non_streaming_tokens"], res["streamed_tokens"]],
        "finished": fe.summary()["requests_finished"],
        "finish_reason": res["finish_reason"]}


def door_serve(cfg, pt, pd, name, mesh):
    """One of ``MESH_FRONTDOOR`` on ``mesh``: a warm serve
    (:func:`warm_run`), or the front-end's or HTTP's run, with this
    rank's streams, rounds, collectives, dispatch syncs and launches."""
    import torch
    from repro_torch.core import tp
    from repro_torch.serving.request import RequestState

    if name not in ("frontend", "http"):
        return warm_run(cfg, pt, pd, warm_by_name(name), mesh=mesh,
                        new=MESH_NEW)
    eng = frontdoor_engine(cfg, pt, pd, mesh=mesh)
    syncs = count_syncs(eng)
    reset_launches()
    tp.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs, lead = (door_frontend if name == "frontend" else door_http)(eng,
                                                                      cfg)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"streams": lead.get("streams", [r.output for r in reqs]),
            "once_in_order": lead.get("once_in_order", True),
            "wall_s": wall, "rounds": eng.rounds,
            "tokens": eng.emitted_total,
            "finished": lead.get("finished", sum(
                r.state is RequestState.FINISHED for r in reqs)),
            "prefix_cache_hit_blocks": float(
                eng.scheduler.prefix_hit_blocks_total),
            "collectives": dict(tp.COUNTS), "launches": read_launches(),
            "dispatch_syncs": sum(syncs.values()),
            "dispatch_sync_sources": dict(syncs)}


def door_twins(smi, layers=MESH_SHARED_LAYERS):
    """The one-card twins of ``MESH_FRONTDOOR`` at ``layers``: the warm
    serves' warm runs, and ``run()``'s streams of the front-end's
    requests and of the HTTP prompt (twice: the non-streaming and the
    streaming completion); rows ``mesh-twin``."""
    from repro_torch.serving.request import Request
    cfg, pt, pd = serve_weights(layers=layers)
    out = {}
    for name in MESH_FRONTDOOR:
        t0 = time.monotonic()
        if name in ("frontend", "http"):
            prompts = (frontdoor_prompts(cfg.vocab_size) if name == "frontend"
                       else [http_prompt(cfg.vocab_size)])
            eng = frontdoor_engine(cfg, pt, pd, pipelined=False)
            # the HTTP completions come one after the other
            waves = [prompts] * (2 if name == "http" else 1)
            reqs = [Request(10 * j + i, prompt=list(p),
                            max_new_tokens=MESH_NEW)
                    for j, wave in enumerate(waves)
                    for i, p in enumerate(wave)]
            for j in range(len(waves)):
                m = eng.run(reqs[j * len(prompts):(j + 1) * len(prompts)])
            out[name] = {"streams": [r.output for r in reqs],
                         "prefix_cache_hit_blocks":
                             m["prefix_cache_hit_blocks"]}
        else:
            out[name] = warm_run(cfg, pt, pd, warm_by_name(name),
                                 new=MESH_NEW)
            check_warm(f"mesh-twin {name}", out[name])
        emit({"phase": "mesh-twin", "serve": name, "layers": layers,
              "wall_s": time.monotonic() - t0, "nvidia_smi": smi})
    return out


def door_row(phase, name, ranks, twin, smi, layers):
    """The row of a meshed front-door serve (:func:`mesh_row`, with the
    prefix cache's hits and COW copies): a warm serve's every rank must
    equal its twin's hits and COW copies and pass :func:`check_warm`
    (the front-end's and HTTP's every rank the others' hits: staggered
    arrivals hit blocks that an all-at-once ``run()`` does not); rank
    0's front-end must deliver each token once, in order."""
    warm = name not in ("frontend", "http")
    sv = (warm_by_name(name) if warm
          else next(d for d in DOOR_SERVES if d.name == name))
    keys = (("prefix_cache_hit_blocks", "cow_copies") if warm
            else ("prefix_cache_hit_blocks",))
    extra = {k: [r[k] for r in ranks] for k in keys}
    extra.update({f"twin_{k}": twin[k] for k in keys})
    if warm:
        extra["tail_prefills"] = ranks[0]["tail_prefills"]
    else:
        extra["once_in_order"] = ranks[0]["once_in_order"]
    launches = mesh_row(phase, name, ranks, twin["streams"], smi, layers,
                        sv, extra)
    want = twin if warm else ranks[0]
    for i, r in enumerate(ranks):
        if any(r[k] != want[k] for k in keys):
            raise AssertionError(f"{phase} {name} rank {i}: prefix cache "
                                 f"{[r[k] for k in keys]} against "
                                 f"{[want[k] for k in keys]}")
        if warm:
            check_warm(f"{phase} {name} rank {i}", r)
    if not (warm or ranks[0]["once_in_order"]):
        raise AssertionError(f"{phase} {name}: a token not delivered once, "
                             "in order")
    return launches


def mesh_twins(names, smi, layers=None):
    """The unmeshed streams of the serves ``names``: the serve phase's
    (full depth, when it ran), else served here on one card, each timed
    after a warm-up (rows ``mesh-twin``): at ``layers`` with ``MESH_NEW``
    tokens a request, or at full depth with the serve phase's
    ``SERVE_NEW``."""
    import torch
    from repro_torch.serving.request import Request
    if layers is None and all(n in SERVE_STREAMS for n in names):
        return {n: SERVE_STREAMS[n] for n in names}
    cfg, pt, pd = serve_weights(layers=layers)
    out = {}
    for name in names:
        sv = serve_by_name(name)
        serve_engine(cfg, pt, pd, sv).run(
            [Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
        eng = serve_engine(cfg, pt, pd, sv)
        reqs = serve_requests(cfg, sv,
                              SERVE_NEW if layers is None else MESH_NEW)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        m = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        out[name] = [r.output for r in reqs]
        emit({"phase": "mesh-twin", "serve": name, "layers": cfg.num_layers,
              "rounds": m["rounds"], "tokens": m["tokens_emitted"],
              "wall_s": wall, "tokens_per_s": m["tokens_emitted"] / wall,
              "nvidia_smi": smi})
    return out


def top2_margin(sv, request, stream, layers=None):
    """The unmeshed target's top-2 logit margin (and its two tokens)
    after ``request``'s prompt and ``stream`` (fp32, one card)."""
    import torch
    from repro_torch.models.transformer import forward
    cfg, pt, _ = serve_weights(layers=layers)
    prompt = serve_prompts(cfg.vocab_size, sv.drafter)[request]
    toks = torch.tensor([prompt + list(stream)], dtype=torch.int32,
                        device="cuda")
    with torch.no_grad():
        logits, _ = forward(damped(pt, sv.damp), cfg, toks, mode="train")
    top = torch.topk(logits[0, -1, :cfg.vocab_size], 2)
    return {"tokens": top.indices.tolist(),
            "margin": float(top.values[0] - top.values[1])}


def mesh_row(phase, name, ranks, twin, smi, layers=30, sv=None, extra=None):
    """The row of one meshed serve (``ranks``: every rank's results):
    rank 0's rate, rounds and collectives a round, every rank's syncs;
    raises where a rank's streams part from the twin's (each parted
    request's first parting position, the two tokens and, for a serve of
    ``SERVES``, the unmeshed target's top-2 logit margin there printed),
    a rank's dispatch synchronised or a path kernel never ran.  ``sv``:
    the serve (default: the one of ``SERVES`` named ``name``); ``extra``:
    more fields of the row."""
    r0 = ranks[0]
    margins = sv is None
    sv = sv or serve_by_name(name)
    for i, r in enumerate(ranks):
        if r["finished"] != len(twin):
            raise AssertionError(f"{phase} {name} rank {i}: {r['finished']}"
                                 " requests finished")
        if min(r["launches"][k] for k in sv.path) <= 0:
            raise AssertionError(f"{phase} {name} rank {i}: a kernel of the "
                                 f"path never ran: {r['launches']}")
    equal = [r["streams"] == twin for r in ranks]
    rounds = max(r0["rounds"], 1)
    row = {"phase": phase, "serve": name, "twin": name, "ranks": len(ranks),
           "layers": layers,
           "equal_to_twin": all(equal), "rounds": r0["rounds"],
           "tokens": r0["tokens"], "wall_s": r0["wall_s"],
           "tokens_per_s": r0["tokens"] / r0["wall_s"],
           "collectives_per_round": (r0["collectives"]["all_reduce"]
                                     + r0["collectives"]["all_gather"])
           / rounds,
           "all_reduce_per_round": r0["collectives"]["all_reduce"] / rounds,
           "all_gather_per_round": r0["collectives"]["all_gather"] / rounds,
           "clock_broadcasts_per_round": r0["collectives"]["broadcast"]
           / rounds,
           "dispatch_syncs": [r["dispatch_syncs"] for r in ranks],
           "launches": {k: sum(r["launches"][k] for r in ranks)
                        for k in r0["launches"]},
           **(extra or {}), "nvidia_smi": smi}
    if not all(equal):
        bad = next(r["streams"] for r in ranks if r["streams"] != twin)
        row["parted"] = []
        for i, (x, y) in enumerate(zip(bad, twin)):
            if x == y:
                continue
            j = next(j for j, (a, b) in enumerate(zip(x, y)) if a != b)
            row["parted"].append({"request": i, "position": j,
                                  "mesh_token": x[j], "twin_token": y[j],
                                  **(top2_margin(sv, i, y[:j], layers)
                                     if margins else {})})
    emit(row)
    if not all(equal):
        raise AssertionError(f"{phase} {name}: streams part from the "
                             f"unmeshed serve's: {row['parted']}")
    if any(r["dispatch_syncs"] for r in ranks):
        raise AssertionError(f"{phase} {name}: dispatch synchronised: "
                             f"{[r['dispatch_sync_sources'] for r in ranks]}")
    return row["launches"]


def nccl_collectives(mesh, smi):
    """One all-reduce and one all-gather over the 1 x 1 mesh's NCCL
    *model* group, as ``core.tp`` calls them where a group holds more
    than one rank: enqueued on the stream with no synchronising call, and
    the values come back."""
    import torch
    import torch.distributed as dist
    group = mesh.get_group("model")
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    want = x.clone()
    parts = [torch.empty_like(x)]
    torch.cuda.synchronize()
    # switched outside the counted region: its first switch warns by itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dist.all_reduce(x, group=group)
            dist.all_gather(parts, x, group=group)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    messages = [str(w.message)[:200] for w in caught
                if "synchroniz" in str(w.message)]
    syncs = len(messages)
    torch.cuda.synchronize()
    equal = bool(torch.equal(x, want) and torch.equal(parts[0], want))
    emit({"phase": "mesh-1x1-nccl-collectives", "backend":
          dist.get_backend(group), "syncs": syncs, "equal": equal,
          "nvidia_smi": smi})
    if syncs or not equal:
        raise AssertionError(f"mesh-1x1-nccl collectives: {messages}, "
                             f"values equal {equal}")


def mesh_nccl(smi, twins, warm_twin):
    """``mesh-1x1-nccl``: a real NCCL communicator of one rank in this
    process, the pool and the ring, then the fp32 warm serve at
    ``FRONTDOOR_LAYERS`` (prefix caching: its tail prefills launch B1)
    against ``warm_twin``; dispatch must make no synchronising call.  A
    group of one rank makes ``core.tp``'s collectives no-ops, so the
    communicator's own all-reduce and all-gather are checked alone
    (:func:`nccl_collectives`)."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import serving_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    total = {}
    try:
        mesh = serving_mesh("1x1")
        nccl_collectives(mesh, smi)
        cfg, pt, pd = serve_weights()
        for i, name in enumerate(MESH_NCCL_TWINS):
            res = mesh_serve(cfg, pt, pd, serve_by_name(name), mesh,
                             warm_up=i == 0)
            for k, n in mesh_row("mesh-1x1-nccl", name, [res], twins[name],
                                 smi).items():
                total[k] = total.get(k, 0) + n
            if res["dispatch_syncs"]:
                raise AssertionError(f"mesh-1x1-nccl {name}: dispatch "
                                     "synchronised: "
                                     f"{res['dispatch_sync_sources']}")
        del pt, pd
        cfg, pt, pd = serve_weights(layers=FRONTDOOR_LAYERS)
        res = warm_run(cfg, pt, pd, warm_by_name("warm"), mesh=mesh)
        for k, n in door_row("mesh-1x1-nccl", "warm", [res], warm_twin, smi,
                             FRONTDOOR_LAYERS).items():
            total[k] = total.get(k, 0) + n
    finally:
        dist.destroy_process_group()
    return total


def start_mesh_ranks(spec, names, flag="--mesh-rank"):
    """``mesh-DxM-shared``'s D*M ranks on card 0 over gloo, each a process
    of this script (``flag``: ``--mesh-rank``, or ``--mesh-family-rank``
    for ``mesh-families``) serving ``names``; the kernels were built
    before any starts.  Returns (spec, processes, their log files, the
    scratch directory)."""
    import os
    import tempfile
    from repro_torch.launch.mesh import parse_mesh

    d, m = parse_mesh(spec)
    tmp = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(d * m)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, spec,
         str(r), str(tmp / "store"), str(tmp / f"rank{r}.json"),
         ",".join(names)],
        env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(d * m)]
    return spec, procs, logs, tmp


def wait_mesh_ranks(worlds, t0):
    """Wait for every world of :func:`start_mesh_ranks`; a failed rank (or
    the time limit) stops them all and raises with its log.  Returns each
    world's ranks' results, in the order of ``worlds``."""
    procs = [p for _, ps, _, _ in worlds for p in ps]
    try:
        while any(p.poll() is None for p in procs):
            for spec, ps, _, tmp in worlds:
                failed = [r for r, p in enumerate(ps)
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() - t0 > MESH_RANK_TIMEOUT_S:
                    raise RuntimeError(
                        f"mesh {spec}: rank(s) {failed or 'timed out'}:\n"
                        + "\n".join((tmp / f"rank{r}.log").read_text()
                                    [-4000:]
                                    for r in (failed or range(len(ps)))))
            time.sleep(0.5)
        for spec, ps, _, tmp in worlds:
            failed = [r for r, p in enumerate(ps) if p.returncode]
            if failed:
                raise RuntimeError(
                    f"mesh {spec}: rank(s) {failed} failed:\n" + "\n".join(
                        (tmp / f"rank{r}.log").read_text()[-4000:]
                        for r in failed))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for _, _, logs, _ in worlds:
            for f in logs:
                f.close()
    return [[json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(len(ps))]
            for _, ps, _, tmp in worlds]


def start_mesh_launcher(arch="smollm-135m", mode=("--demo",)):
    """``mesh-launcher``: ``torchrun --nproc-per-node 1 -m
    repro_torch.launch.serve --arch ARCH MODE --mesh 1x1`` on the card,
    its output to files.  Returns (the process, the output's path, the
    arch, the mode)."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix="mesh-launcher-", dir=ROOT / "build"))
    with open(tmp / "out.txt", "w") as out, open(tmp / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
             "--arch", arch, *mode, "--mesh", "1x1", "--device",
             "cuda", "--max-new", "16"],
            env=env, cwd=ROOT, stdout=out, stderr=err)
    return proc, tmp, arch, mode


def finish_mesh_launcher(launcher, smi, t0) -> None:
    """The launcher must exit 0 and print its result: the demo's summary
    (8 requests finished; with ``--prefix-share`` cache hits), the HTTP
    smoke test's JSON (equal streamed and non-streamed tokens)."""
    proc, tmp, arch, mode = launcher
    proc.wait(timeout=300)
    out, err = ((tmp / f).read_text() for f in ("out.txt", "err.txt"))
    http = "--http-smoke" in mode
    lines = [ln for ln in out.splitlines()
             if ('"mesh": "1x1"' if http else "'mesh': '1x1'") in ln]
    emit({"phase": "mesh-launcher", "arch": arch, "mode": list(mode),
          "returncode": proc.returncode,
          "seconds": time.monotonic() - t0,
          "summary": lines[-1][:600] if lines else None,
          "nvidia_smi": smi})
    ok = proc.returncode == 0 and len(lines) == 1
    if ok and http:
        res = json.loads(lines[0])
        ok = (res["streamed_tokens"] == res["non_streaming_tokens"]
              and len(res["streamed_tokens"]) == 8)
    elif ok:
        ok = "'requests_finished': 8" in lines[0]
        if "--prefix-share" in mode:
            ok = ok and "'prefix_cache_hit_blocks': 0.0" not in lines[0]
    if not ok:
        raise AssertionError(f"mesh-launcher {arch} {mode} failed: "
                             f"{out[-1500:]} {err[-3000:]}")


def run_mesh_worlds(starts, launcher_runs, smi):
    """Start the launchers' ``--mesh 1x1`` runs of ``launcher_runs``
    (each ``(arch, mode)``) and the worlds of ``starts`` (each ``(spec,
    names, flag)`` of :func:`start_mesh_ranks`) all at once, and wait
    for them (a rank waits on the host in each gloo call, so the card
    takes the worlds side by side; their rates are measured in each
    other's company).  Returns each world's ranks' results."""
    t1 = time.monotonic()
    launchers = [start_mesh_launcher(*run) for run in launcher_runs]
    try:
        ranks = wait_mesh_ranks([start_mesh_ranks(*st) for st in starts], t1)
    except BaseException:
        for proc, _, _, _ in launchers:
            proc.kill()
            proc.wait()
        raise
    emit({"phase": "mesh-shared-seconds", "seconds": time.monotonic() - t1,
          "worlds": [f"{spec} {flag}" for spec, _, flag in starts]})
    for launcher in launchers:
        finish_mesh_launcher(launcher, smi, t1)
    return ranks


def mesh_phase(smi, families=False, sides=()):
    """The serving engine on a (data, model) mesh at smollm-135m full
    width, every meshed serve's streams equal to the unmeshed serve's;
    returns the mesh ranks' kernel launches.  The NCCL serves run alone;
    then both shared-card worlds and the launcher run at once, and with
    ``families`` the ``mesh-families`` world and launcher beside them
    (its twins served first, its rows and launches added), the side
    processes ``sides`` stopped meanwhile (:func:`side_paused`)."""
    t0 = time.monotonic()
    twins = mesh_twins(MESH_NCCL_TWINS, smi)
    warm_twin = WARM_RESULTS.get(("warm", FRONTDOOR_LAYERS))
    if warm_twin is None:
        warm_twin = warm_run(*serve_weights(layers=FRONTDOOR_LAYERS),
                             warm_by_name("warm"))
    shallow = mesh_twins(MESH_TWINS, smi, MESH_SHARED_LAYERS)
    doors = door_twins(smi)
    fam_twins = family_twins(smi) if families else None
    total = {k: 0 for k in read_launches()}
    for k, c in mesh_nccl(smi, twins, warm_twin).items():
        total[k] += c
    starts = [(spec, MESH_SHARED_SERVES[spec], "--mesh-rank")
              for spec in MESH_SHARED]
    launcher_runs = list(MESH_LAUNCHERS)
    if families:
        starts.append(FAMILY_WORLD)
        launcher_runs.append(FAMILY_LAUNCHER)
    with side_paused(sides):
        ranks = run_mesh_worlds(starts, launcher_runs, smi)
    for spec, world in zip(MESH_SHARED, ranks):
        for name in MESH_SHARED_SERVES[spec]:
            row = door_row if name in MESH_FRONTDOOR else mesh_row
            twin = doors[name] if name in MESH_FRONTDOOR else shallow[name]
            for k, c in row(f"mesh-{spec}-shared", name,
                            [r[name] for r in world], twin, smi,
                            MESH_SHARED_LAYERS).items():
                total[k] += c
    if families:
        for k, c in family_rows(fam_twins, ranks[-1], smi).items():
            total[k] += c
    emit({"phase": "mesh-total", "seconds": time.monotonic() - t0,
          "families": families})
    return total


# ``mesh-families``: every non-dense family on one 2 x 2 world of ranks
# sharing card 0 over gloo, at each arch's full width and the depth of
# ``MESH_FAMILY_LAYERS`` (an audio stack's encoder at one layer: the
# engine serves it with an empty encoder context), against unmeshed
# twins of the same depth on one card.  2 x 2 splits granite-moe's 24
# query heads, 8 KV heads and every expert's width (the ring's rows over
# data: an MoE layer gathers the call's rows to route them),
# mamba2-130m's 24 SSD heads, recurrentgemma-2b's 10 query heads (its 1
# KV head and the RG-LRU block replicate; D 256, and D 320 in its
# draft), qwen2-vl-2b's 12 / 2 heads (its draft's 3 / 1 replicate) and
# seamless-m4t-medium's 16 / 16
MESH_FAMILY_SPEC = "2x2"
MESH_FAMILY_SERVES = ("moe-serve-dense", "ssm-serve", "hybrid-serve",
                      "vlm-serve", "audio-serve")
# (the depths were 4, 6, 3, 4 and 3; cut with ``MESH_SHARED_LAYERS``, as
# far as a hybrid keeps its (rec, rec, attn) group)
MESH_FAMILY_LAYERS = {"granite-moe-3b-a800m": 2, "mamba2-130m": 3,
                      "recurrentgemma-2b": 3, "qwen2-vl-2b": 2,
                      "seamless-m4t-medium": 2}
# the serve draft of each arch (``serve_draft``), cut to this depth: 3
# layers keep one (rec, rec, attn) group in recurrentgemma-2b's draft, so
# its D-320 local attention runs too
MESH_FAMILY_DRAFT_LAYERS = 3


def family_serve_by_name(name):
    return next(sv for sv in FAMILY_SERVES + RECURRENT_SERVES
                + MULTIMODAL_SERVES if sv.name == name)


def family_mesh_weights(arch, plan=None):
    """``arch`` at full width and ``MESH_FAMILY_LAYERS`` deep, and its
    serve draft ``MESH_FAMILY_DRAFT_LAYERS`` deep: (cfg, draft cfg,
    target, draft), drawn on the card's generator (``plan``: this rank's
    shards of the same draw)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    cfg = get_config(arch)
    enc = {"num_encoder_layers": 1} if cfg.is_encoder_decoder else {}
    dcfg = serve_draft(cfg)
    dcfg = dataclasses.replace(dcfg, num_layers=min(dcfg.num_layers,
                                                    MESH_FAMILY_DRAFT_LAYERS),
                               **enc)
    cfg = dataclasses.replace(cfg, num_layers=MESH_FAMILY_LAYERS[arch], **enc)
    pt = init_params(cfg, seed=0, device="cuda", rng_device="cuda", plan=plan)
    pd = init_params(dcfg, seed=1, device="cuda", rng_device="cuda",
                     plan=plan)
    return cfg, dcfg, pt, pd


def family_mesh_engine(dcfg):
    """The engine builder of a family serve (``mesh_serve``'s
    ``engine``): batch 4 on ``sv``'s layout, its draft ``dcfg``."""
    def build(cfg, pt, pd, sv, mesh=None):
        from repro_torch.core.config import ServingConfig, SpecDecodeConfig
        from repro_torch.serving.engine import ServingEngine
        model = sv.drafter == "model"
        serving = ServingConfig(max_batch_size=4, max_seq_len=sv.max_len,
                                pipelined=sv.pipelined,
                                paged_kv=sv.nblocks is not None,
                                kv_block_size=16, num_kv_blocks=sv.nblocks,
                                kv_quant=sv.kv_quant)
        return ServingEngine(damped(pt, sv.damp), cfg, pd if model else None,
                             dcfg if model else None,
                             SpecDecodeConfig(drafter=sv.drafter), serving,
                             seed=0, device="cuda", mesh=mesh)
    return build


def family_mesh_serves(names, plan=None, smi=None):
    """Each of the family serves ``names`` (one arch's weights at a time,
    freed before the next) on ``plan``'s mesh, or on one card: the
    results of :func:`mesh_serve` by name (on one card each also emitted
    as a ``mesh-family-twin`` row)."""
    import gc
    import torch
    out = {}
    for i, name in enumerate(names):
        sv = family_serve_by_name(name)
        cfg, dcfg, pt, pd = family_mesh_weights(sv.arch, plan)
        res = mesh_serve(cfg, pt, pd, sv, plan, warm_up=i == 0,
                         engine=family_mesh_engine(dcfg), new=MESH_NEW)
        out[name] = res
        if plan is None:
            emit({"phase": "mesh-family-twin", "serve": name,
                  "arch": sv.arch, "layers": cfg.num_layers,
                  "rounds": res["rounds"], "tokens": res["tokens"],
                  "wall_s": res["wall_s"],
                  "tokens_per_s": res["tokens"] / res["wall_s"],
                  "dispatch_syncs": res["dispatch_syncs"],
                  "nvidia_smi": smi})
        del pt, pd
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_family_rank_main(spec, rank, store, out, names) -> int:
    """One rank of ``mesh-families``' world (``--mesh-family-rank``):
    gloo over a FileStore, card 0, the family serves ``names``
    (comma-separated) on this rank's shards; its results to ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.tp import MeshPlan
    from repro_torch.launch.mesh import parse_mesh, serving_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    d, m = parse_mesh(spec)
    dist.init_process_group("gloo", store=dist.FileStore(store, d * m),
                            rank=rank, world_size=d * m)
    try:
        plan = MeshPlan.for_mesh(serving_mesh(spec, share_card=True), 4)
        res = family_mesh_serves(names.split(","), plan)
        Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


# the world and the launcher's run of ``mesh-families``
FAMILY_WORLD = (MESH_FAMILY_SPEC, MESH_FAMILY_SERVES, "--mesh-family-rank")
FAMILY_LAUNCHER = ("mamba2-130m", ("--demo",))


def family_twins(smi):
    """``mesh-families``' unmeshed twins on one card, each with 0
    synchronising calls in dispatch."""
    twins = family_mesh_serves(MESH_FAMILY_SERVES, smi=smi)
    for name, res in twins.items():
        if res["dispatch_syncs"]:
            raise AssertionError(f"mesh-family-twin {name}: dispatch "
                                 f"synchronised: "
                                 f"{res['dispatch_sync_sources']}")
    return twins


def family_rows(twins, ranks, smi):
    """``mesh-families``' rows: every rank's streams must equal its
    twin's, with 0 synchronising calls in dispatch.  Returns the ranks'
    kernel launches."""
    total = {k: 0 for k in read_launches()}
    for name in MESH_FAMILY_SERVES:
        sv = family_serve_by_name(name)
        for k, c in mesh_row(f"mesh-families-{MESH_FAMILY_SPEC}", name,
                             [r[name] for r in ranks],
                             twins[name]["streams"], smi,
                             MESH_FAMILY_LAYERS[sv.arch], sv).items():
            total[k] += c
        emit({"phase": "mesh-family-rate", "serve": name,
              "meshed_tokens_per_s": ranks[0][name]["tokens"]
              / ranks[0][name]["wall_s"],
              "twin_tokens_per_s": twins[name]["tokens"]
              / twins[name]["wall_s"], "nvidia_smi": smi})
    return total


def mesh_families_phase(smi):
    """``mesh-families`` alone (``--only mesh-families``; the default run
    starts its world beside ``mesh``'s, :func:`mesh_phase`): the
    unmeshed twins on one card, then the 2 x 2 world of shared-card
    ranks beside the launcher's ``--mesh 1x1`` demo of mamba2-130m
    under torchrun.  Returns the ranks' kernel launches."""
    t0 = time.monotonic()
    twins = family_twins(smi)
    ranks = run_mesh_worlds([FAMILY_WORLD], [FAMILY_LAUNCHER], smi)
    total = family_rows(twins, ranks[0], smi)
    emit({"phase": "mesh-families-total", "seconds": time.monotonic() - t0})
    return total


# ``--only mesh-witness``: why meshed int8 streams can part from one
# card's.  The serve, its depth and its mesh: the damped n-gram drafter
# on the int8 pool at smollm-135m's full 30 layers, 1 x 3 (query heads,
# KV heads and the MLP split three ways), where its streams parted
WITNESS_SERVE, WITNESS_SPEC = "serve-ngram-int8", "1x3"


def witness_record(cfg, pt, pd, plan=None):
    """One serve of ``WITNESS_SERVE`` with every K/V quantization of the
    target recorded in call order (the fp32 K/V, their int8 values and
    scales), each round's quantizations (the calls its dispatch made)
    and each round's emitted tokens by request."""
    import torch
    from repro_torch.models import cache as cache_lib
    from repro_torch.serving.engine import ServingEngine

    calls, marks, emitted = [], [], []
    quantize, dispatch, collect = (cache_lib.quantize_kv,
                                   ServingEngine.dispatch,
                                   ServingEngine.collect)

    def quantize_rec(x):
        q, scale = quantize(x)
        calls.append(tuple(t.detach().cpu() for t in (x, q, scale)))
        return q, scale

    def dispatch_rec(eng):
        n = len(calls)
        rec = dispatch(eng)
        marks.append((n, len(calls)))
        return rec

    def collect_rec(eng, rec):
        out = collect(eng, rec)
        n = rec.out.num_emitted.tolist()
        emitted.append({r.request_id: rec.out.emitted[slot, :n[slot]].tolist()
                        for r, slot, _ in rec.rows})
        return out

    cache_lib.quantize_kv = quantize_rec
    ServingEngine.dispatch, ServingEngine.collect = dispatch_rec, collect_rec
    try:
        sv = serve_by_name(WITNESS_SERVE)
        reqs = serve_requests(cfg, sv)
        serve_engine(cfg, pt, pd, sv, plan).run(reqs)
        torch.cuda.synchronize()
    finally:
        cache_lib.quantize_kv = quantize
        ServingEngine.dispatch, ServingEngine.collect = dispatch, collect
    return {"streams": [r.output for r in reqs], "calls": calls,
            "marks": marks, "emitted": emitted}


def fp32_greedy_partings(cfg, pt, streams):
    """Where ``streams`` (of ``WITNESS_SERVE``'s requests) part from the
    target's fp32 greedy rollout (train-mode forwards, no cache): each
    parted request's first position and the fp32 top-2 margin there."""
    import torch
    from repro_torch.models.transformer import forward
    sv = serve_by_name(WITNESS_SERVE)
    params = damped(pt, sv.damp)
    out = []
    for i, (prompt, stream) in enumerate(zip(
            serve_prompts(cfg.vocab_size, sv.drafter), streams)):
        seq = list(prompt)
        for j, tok in enumerate(stream):
            toks = torch.tensor([seq], dtype=torch.int32, device="cuda")
            with torch.no_grad():
                logits, _ = forward(params, cfg, toks, mode="train")
            top = torch.topk(logits[0, -1, :cfg.vocab_size], 2)
            if int(top.indices[0]) != tok:
                out.append({"request": i, "position": j,
                            "fp32_token": int(top.indices[0]),
                            "int8_token": tok,
                            "margin": float(top.values[0]
                                            - top.values[1])})
                break
            seq.append(tok)
    return out


def mesh_witness_rank(rank, store, out) -> int:
    """One rank of the witness's mesh (``--mesh-witness-rank``): gloo over
    a FileStore on card 0, its record saved to ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.tp import MeshPlan
    from repro_torch.launch.mesh import parse_mesh, serving_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    d, m = parse_mesh(WITNESS_SPEC)
    dist.init_process_group("gloo", store=dist.FileStore(store, d * m),
                            rank=rank, world_size=d * m)
    try:
        plan = MeshPlan.for_mesh(serving_mesh(WITNESS_SPEC, share_card=True),
                                 4)
        cfg, pt, pd = serve_weights(plan)
        torch.save(witness_record(cfg, pt, pd, plan), out)
    finally:
        dist.destroy_process_group()
    return 0


def witness_call(x1, q1, s1, xm, qm, sm):
    """One quantization, one card's against a rank's: fp32 gaps in units
    in the last place of each vector's amax (a gap that does not blow up
    near zero) and in int8 quanta (the vector's scale), int8 values that
    differ, how far those elements' value / scale sat from the rounding
    boundary, and scales that differ."""
    import torch
    x1, xm, s1d = x1.double(), xm.double(), s1.double()
    amax = x1.abs().amax(-1).float()
    ulp = (torch.nextafter(amax, torch.full_like(amax, float("inf")))
           - amax).double()[..., None]
    gap = (x1 - xm).abs()
    flips = q1 != qm
    out = {"fp32_differing": int((gap > 0).sum()),
           "fp32_max_gap_ulp_of_amax": float((gap / ulp).max()),
           "fp32_max_gap_quanta": float((gap / s1d[..., None]).max()),
           "int8_flips": int(flips.sum()),
           "scales_differing": int((s1 != sm).sum()),
           "scales_max_rel_gap": float(((s1d - sm.double()).abs()
                                        / s1d).max())}
    if flips.any():
        frac = (x1 / s1d[..., None]).abs()
        out.update(
            int8_max_gap_quanta=int((q1.int() - qm.int()).abs().max()),
            flips_max_boundary_distance=float(
                ((frac - frac.floor()) - 0.5).abs()[flips].max()),
            flips_max_fp32_gap_quanta=float(
                (gap / s1d[..., None])[flips].max()),
            flips_max_fp32_gap_ulp_of_amax=float((gap / ulp)[flips].max()))
    return out


def witness_compare(one, ranks, rounds):
    """The quantizations of the first ``rounds`` rounds (and the prefills
    before them), rank r's KV head against one card's head r, in call
    order (per forward, layer by layer): the calls bitwise equal before
    the first fp32 gap, the first call with an fp32 gap and the first
    with an int8 value apart (:func:`witness_call` of each, the rank
    that showed it), and over every call the totals of the cascade that
    follows."""
    n_one = one["marks"][rounds - 1][1]
    out = {"calls": n_one, "first_fp32_gap": None, "first_int8_flip": None,
           "cascade": {"fp32_elements": 0, "fp32_differing": 0,
                       "int8_flips": 0, "int8_max_gap_quanta": 0,
                       "scales_max_rel_gap": 0.0}}
    for i in range(n_one):
        for r, rank in enumerate(ranks):
            if rank["marks"][rounds - 1][1] != n_one:
                raise AssertionError(f"witness rank {r}: {rank['marks']} "
                                     f"quantizations, one card "
                                     f"{one['marks']}")
            x1, q1, s1 = one["calls"][i]
            # [..., KV, D] values, [..., KV] scales: one card's head r
            x1, q1, s1 = x1[..., r:r + 1, :], q1[..., r:r + 1, :], \
                s1[..., r:r + 1]
            xm, qm, sm = rank["calls"][i]
            if x1.shape != xm.shape:
                raise AssertionError(f"witness call {i}: {tuple(x1.shape)} "
                                     f"against {tuple(xm.shape)}")
            c = witness_call(x1, q1, s1, xm, qm, sm)
            if c["fp32_differing"] and out["first_fp32_gap"] is None:
                out["first_fp32_gap"] = {"call": i, "rank": r, **c}
            if c["int8_flips"] and out["first_int8_flip"] is None:
                out["first_int8_flip"] = {"call": i, "rank": r, **c}
            cas = out["cascade"]
            cas["fp32_elements"] += x1.numel()
            cas["fp32_differing"] += c["fp32_differing"]
            cas["int8_flips"] += c["int8_flips"]
            cas["int8_max_gap_quanta"] = max(cas["int8_max_gap_quanta"],
                                             c.get("int8_max_gap_quanta", 0))
            cas["scales_max_rel_gap"] = max(cas["scales_max_rel_gap"],
                                            c["scales_max_rel_gap"])
    return out


def mesh_witness(smi):
    """The witness: one card's and ``WITNESS_SPEC``'s serve of
    ``WITNESS_SERVE`` at full depth, every K/V quantization recorded.
    Prints where one card's int8 streams part from the fp32 greedy
    rollout (:func:`fp32_greedy_partings`), the meshed streams' first
    parting from one card's (request, position, the two tokens, the
    unmeshed fp32 target's top-2 margin there), the first round whose
    emitted tokens differ, and :func:`witness_compare` over the rounds up
    to it (the schedule is the same until then).  A measurement, not a
    check: it fails only where the two runs cannot be compared."""
    import os
    import tempfile
    import torch
    from repro_torch.launch.mesh import parse_mesh

    t0 = time.monotonic()
    d, m = parse_mesh(WITNESS_SPEC)
    tmp = Path(tempfile.mkdtemp(prefix="witness-", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(tmp / "ranks.log", "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--mesh-witness-rank", str(r), str(tmp / "store"),
             str(tmp / f"rank{r}.pt")], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT) for r in range(d * m)]
        try:
            cfg, pt, pd = serve_weights()
            one = witness_record(cfg, pt, pd)
            greedy = fp32_greedy_partings(cfg, pt, one["streams"])
            for p in procs:
                p.wait(timeout=MESH_RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("witness ranks failed:\n"
                           + (tmp / "ranks.log").read_text()[-4000:])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(d * m)]
    row = {"phase": "mesh-int8-witness", "serve": WITNESS_SERVE,
           "mesh": WITNESS_SPEC, "layers": cfg.num_layers,
           "ranks_equal": all(r["streams"] == ranks[0]["streams"]
                              for r in ranks),
           "equal_to_one_card": ranks[0]["streams"] == one["streams"],
           "rounds_one_card": len(one["marks"]),
           "rounds_mesh": len(ranks[0]["marks"]),
           "one_card_int8_vs_fp32_greedy": greedy}
    parted = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
              for i, (x, y) in enumerate(zip(ranks[0]["streams"],
                                             one["streams"])) if x != y]
    if parted:
        i, j = parted[0]
        row["parted"] = {"request": i, "position": j,
                         "mesh_token": ranks[0]["streams"][i][j],
                         "one_card_token": one["streams"][i][j],
                         **top2_margin(serve_by_name(WITNESS_SERVE), i,
                                       one["streams"][i][:j])}
        rounds = next(k for k, (a, b) in enumerate(zip(ranks[0]["emitted"],
                                                       one["emitted"]))
                      if a != b) + 1
    else:
        rounds = min(len(one["marks"]), len(ranks[0]["marks"]))
    row["same_schedule_rounds"] = all(
        r["emitted"][:rounds - 1] == one["emitted"][:rounds - 1]
        and r["marks"][:rounds] == one["marks"][:rounds] for r in ranks)
    row["compared_rounds"] = rounds
    row.update(witness_compare(one, ranks, rounds))
    row["seconds"] = time.monotonic() - t0
    row["nvidia_smi"] = smi
    emit(row)
    return {}


def flat_tensors(tree):
    """The tensors of nested dicts, tuples and lists."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in flat_tensors(sub)]
    return []


# -- side processes ------------------------------------------------------
# Work that times nothing the script reports as the card's rate, run in
# two processes of this script (``--side DUTY DIR``) beside the main one,
# which starts them once the kernel phase has timed the kernels.
# ``train``: the train phase's corpus (to DIR), the trained pair's
# training (the reference recipe's 2 600 small steps, its losses held to
# the reference's; the params to DIR), then every profile of the serve,
# families, recurrent and multimodal phases.  ``checks``: the
# reduced-width card == CPU checks, whose CPU halves run the plain
# versions.  The main process reads DIR when its train phase needs the
# corpus and the pair, stops both while the shared-card mesh worlds run
# (never inside a timed region of theirs: ``side_lock``), and relays
# their rows at the end (``"process": "side-train"`` /
# ``"side-checks"``, their ``t`` that process's own).  Their CPU threads
# are capped, so that the plain versions leave the other processes'
# cores alone.  The main process's rates are measured in their company,
# and a profile's in the main process's.
SIDE_THREADS = 2
SIDE_TIMEOUT_S = 900


def check_phases():
    """(row name, function) of every reduced-width card == CPU check."""
    from repro_torch.configs import get_config
    smollm = get_config("smollm-135m")
    return (("check", lambda: check_phase(smollm)),
            ("warm-check", lambda: warm_check_phase(smollm)),
            ("family-check", family_check_phase),
            ("recurrent-check", recurrent_check_phase),
            ("multimodal-check", multimodal_check_phase))


def run_checks(smi=None) -> None:
    for name, fn in check_phases():
        timed_phase(name, fn)


def side_profiles() -> None:
    """The profiled serves of the serve phase (``PROFILED``) and of the
    families (``FAMILY_PROFILED``, ``RECURRENT_PROFILED``,
    ``MULTIMODAL_PROFILED``), each after a warm-up run of its engine:
    their ``profile`` rows, as the phases print them when run alone."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    from repro_torch.serving.request import Request

    def profiled(name, engine, reqs):
        engine().run([Request(99, prompt=[1, 2, 3], max_new_tokens=4)])
        timed_phase("profile", profile_phase, name, engine, reqs)

    cfg, pt, pd = serve_weights()
    for sv in SERVES:
        if sv.name in PROFILED:
            profiled(sv.name, lambda sv=sv: serve_engine(cfg, pt, pd, sv),
                     serve_requests(cfg, sv))
    names = FAMILY_PROFILED + RECURRENT_PROFILED + MULTIMODAL_PROFILED
    serves = [sv for sv in FAMILY_SERVES + RECURRENT_SERVES
              + MULTIMODAL_SERVES if sv.name in names]
    for arch in dict.fromkeys(sv.arch for sv in serves):
        del pt, pd
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        dcfg = serve_draft(cfg)
        pt = init_params(cfg, seed=0, device="cuda", rng_device="cuda")
        pd = init_params(dcfg, seed=1, device="cuda", rng_device="cuda")
        for sv in serves:
            if sv.arch == arch:
                profiled(sv.name, family_engine(cfg, dcfg, pt, pd, sv),
                         family_requests(cfg, sv))


def side_train(out) -> None:
    """The ``train`` side process's work: the corpus (``out``/stream.npy),
    the trained pair (``workloads``' cache, then :func:`pair_done`),
    then the profiles."""
    import os
    import numpy as np
    from repro_torch import workloads
    stream = workloads.mixed_stream()
    np.save(out / "stream.part.npy", stream)
    os.replace(out / "stream.part.npy", out / "stream.npy")
    with side_lock():
        pair = train_pair(stream, query_smi())
    pair_done().touch()
    del pair
    side_profiles()


def side_examples(out) -> None:
    """The ``examples`` side process's work: the full-width trace replay,
    then the examples phase, whose trained-pair runs wait for the
    ``train`` side process's pair; their launches in a ``side-launches``
    row, which joins the kernels line."""
    smi = query_smi()
    total = loadgen_phase(smi)
    for kernel, n in examples_phase(smi, side=True).items():
        total[kernel] += n
    emit({"phase": "side-launches", "launches": total})


# the side processes by duty, each a function of its directory
SIDE_DUTIES = {"train": side_train, "checks": lambda out: run_checks(),
               "examples": side_examples}


def side_main(duty, out) -> int:
    """A side process (``--side DUTY DIR``): its duty's work, its rows to
    standard output."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(SIDE_THREADS)
    SIDE_DUTIES[duty](Path(out))
    return 0


class Side(NamedTuple):
    duty: str
    proc: object
    dir: Path
    log: object


def start_side(duty):
    """The side process of ``duty``, its output to a file in its own
    directory, which is also its temporary directory; the kernels were
    built before it starts."""
    import os
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix=f"side-{duty}-", dir=ROOT / "build"))
    log = open(tmp / "side.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--side", duty,
         str(tmp)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp)),
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return Side(duty, proc, tmp, log)


def poll_side(side) -> None:
    """Raise with the side process's log if it has failed."""
    if side.proc.poll() not in (None, 0):
        raise AssertionError(f"the {side.duty} side process failed:\n"
                             f"{(side.dir / 'side.log').read_text()[-6000:]}")


def side_file(path, side=None):
    """``path`` once it is written (the seconds waited for it printed as
    ``side-file``), by the side process ``side`` if given (a failure of
    its raises at once), else by another process of this run."""
    t0 = time.monotonic()
    while not path.exists():
        if side is not None:
            poll_side(side)
        if ((side is not None and side.proc.poll() == 0)
                or time.monotonic() - t0 > SIDE_TIMEOUT_S):
            raise AssertionError(f"no side process wrote {path}")
        time.sleep(0.5)
    emit({"phase": "side-file", "name": path.name,
          "seconds": time.monotonic() - t0})
    return path


def side_stream(side):
    """The ``train`` side process's corpus (``workloads.mixed_stream``)."""
    import numpy as np
    return np.load(side_file(side.dir / "stream.npy", side))


def pair_done():
    """The mark the ``train`` side process leaves in ``workloads``' cache
    once the pair's checkpoints are complete."""
    from repro_torch import workloads
    return Path(workloads.CACHE_DIR) / "pair.done"


def side_pair(side):
    """The ``train`` side process's trained pair, {name: (cfg, params)}
    on the card, restored from ``workloads``' cache."""
    from repro_torch import workloads
    side_file(pair_done(), side)
    cfg_t, cfg_d, pt, pd, _ = workloads.build_pair("llama", device="cuda")
    return {"target": (cfg_t, pt), "draft": (cfg_d, pd)}


@contextlib.contextmanager
def side_lock():
    """Held by a side process around what it times (the pair's training,
    a profiled run), and by the main process while it has the side
    processes stopped: no timed region holds a stop."""
    import fcntl
    (ROOT / "build").mkdir(exist_ok=True)
    with open(ROOT / "build" / "side.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@contextlib.contextmanager
def side_paused(sides):
    """The side processes stopped (SIGSTOP) while the block runs, once no
    timed region of theirs is open (:func:`side_lock`; the seconds waited
    for it and stopped printed as ``side-pause``), and continued after
    it: the shared-card mesh worlds' ranks wait on one another in every
    collective, so they get the host's cores and the card to
    themselves."""
    import os
    import signal
    if not sides:
        yield
        return
    t0 = time.monotonic()
    with side_lock():
        t1 = time.monotonic()
        live = [side for side in sides if side.proc.poll() is None]
        for side in live:
            os.kill(side.proc.pid, signal.SIGSTOP)
        try:
            yield
        finally:
            for side in live:
                if side.proc.poll() is None:
                    os.kill(side.proc.pid, signal.SIGCONT)
    emit({"phase": "side-pause", "lock_wait_s": t1 - t0,
          "stopped_s": time.monotonic() - t1,
          "duties": [side.duty for side in live]})


def finish_side(side) -> list:
    """Wait for the side process (the seconds waited printed as
    ``side-wait``), relay its rows, and raise if it failed; returns the
    rows."""
    t0 = time.monotonic()
    try:
        side.proc.wait(timeout=SIDE_TIMEOUT_S)
    finally:
        stop_side(side)
    emit({"phase": "side-wait", "duty": side.duty,
          "seconds": time.monotonic() - t0})
    poll_side(side)
    rows = []
    for line in (side.dir / "side.log").read_text().splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and "phase" in row:
            rows.append(row)
            emit({**row, "process": "side-" + side.duty})
    return rows


def stop_side(side) -> None:
    if side.proc.poll() is None:
        side.proc.kill()
        side.proc.wait()
    side.log.close()


# ``--only NAME[,NAME]``: these phases alone, after the build, with no
# result line (a short run while a phase is being written)
ONLY = {
    "checks": run_checks,
    "dryrun": dryrun_phase,
    "frontdoor": frontdoor_phase,
    "mesh": mesh_phase,
    "mesh-families": mesh_families_phase,
    "mesh-witness": mesh_witness,
    "kernels": lambda smi: kernel_phase(torch_flush()),
    "multimodal-kernels": lambda smi: multimodal_rows(torch_flush()),
    "multimodal": multimodal_phase,
    "multimodal-checks": lambda smi: multimodal_check_phase(),
    "recurrent": recurrent_phase,
    "train-family": family_train_phase,
    "flash": flash_rows,
    "examples": examples_phase,
    "loadgen": loadgen_phase,
}


def query_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def torch_flush():
    import torch
    return torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")


def main() -> int:
    if len(sys.argv) == 7 and sys.argv[1] == "--mesh-rank":
        return mesh_rank_main(sys.argv[2], int(sys.argv[3]), *sys.argv[4:7])
    if len(sys.argv) == 7 and sys.argv[1] == "--mesh-family-rank":
        return mesh_family_rank_main(sys.argv[2], int(sys.argv[3]),
                                     *sys.argv[4:7])
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-witness-rank":
        return mesh_witness_rank(int(sys.argv[2]), *sys.argv[3:5])
    if len(sys.argv) == 4 and sys.argv[1] == "--side":
        return side_main(sys.argv[2], sys.argv[3])
    t_start = time.monotonic()
    import os
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # the trained pairs' cache (``repro_torch.workloads``): a fresh one a
    # run, which this process and its side processes share
    (ROOT / "build").mkdir(exist_ok=True)
    os.environ["REPRO_TORCH_BENCH_CACHE"] = tempfile.mkdtemp(
        prefix="pair-cache-", dir=ROOT / "build")
    from repro_torch.kernels.build import build_all, ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = query_smi()
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
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-ab":
        serve_ab_phase(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        for name in sys.argv[2].split(","):
            ONLY[name](smi)
        return 0

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    t0 = time.monotonic()
    contract = kernel_phase(flush)
    del flush
    emit({"phase": "kernel-total", "seconds": time.monotonic() - t0})
    sides = []
    try:
        for duty in SIDE_DUTIES:
            sides.append(start_side(duty))
        t0 = time.monotonic()
        launches = serve_phase(profile=False)
        emit({"phase": "serve-total", "seconds": time.monotonic() - t0})
        for phase in (frontdoor_phase,
                      lambda smi: mesh_phase(smi, True, sides),
                      lambda smi: families_phase(smi, side=True),
                      lambda smi: recurrent_phase(smi, side=True),
                      lambda smi: multimodal_phase(smi, side=True),
                      lambda smi: train_phase(smi, sides[0])):
            for side in sides:
                poll_side(side)
            for kernel, n in phase(smi).items():
                launches[kernel] += n
        dryrun_phase(smi)
        for side in sides:
            for row in finish_side(side):
                if row["phase"] == "side-launches":
                    for kernel, n in row["launches"].items():
                        launches[kernel] += n
    finally:
        for side in sides:
            stop_side(side)

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
