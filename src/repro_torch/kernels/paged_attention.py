"""Paged decode / verify attention: the CUDA kernel, its plain PyTorch
version, and the dispatcher the model calls.

Replaces the TPU kernel ``paged_ragged_verify_attention``
(``repro/kernels/ragged_attention.py``).  The kernel source is
``csrc/paged_attention.cu`` with its body in ``csrc/paged_verify.cuh``;
see their headers for the design and bound.

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
* :func:`split_plan` / :func:`wide_split_plan` / :func:`split_ranges` —
  the kernels' split of each sequence's units (table entries; the dense
  ring's 16-slot chunks) over S thread blocks, chosen from the shapes and
  the card's SM count alone (never from a device tensor, so a launch
  makes no host sync): ``split_plan`` for the tensor-core body at D <=
  128, ``wide_split_plan`` for the wide heads' kernel at D 256 and 320,
  shared with the int8 and ring kernels through :func:`plan_splits`.
* :func:`check_verify_shape` / :func:`query_groups` — what one launch of
  the three verify kernels takes, and the launches a call's T query
  positions are cut into so that each one fits.
* :func:`split_attention_plain` and
  :func:`paged_ragged_verify_attention_split_plain` — the kernel's
  split-and-merge algorithm in plain PyTorch, for the CPU tests (no main
  path calls them).
"""
from __future__ import annotations

import ctypes
import functools
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

SMS = 132                # SMs of an H100 SXM: the plan's default card
NEG_INF = -1e30          # the kernels' "no score yet"
STAGE_SLOTS = 64         # slots a thread block stages at a time
# the wide heads' kernel (csrc/paged_verify.cuh, `wide_mma_kernel`): its
# head dims, the query rows of one of its thread blocks (a row tile) and
# the slots it stages at a time
WIDE_DIMS = (256, 320)
WIDE_TILE_ROWS = 32
WIDE_STAGE_SLOTS = 32


def _splits(blocks: int, bs: int, maxb: int, stage_slots: int, rows: int,
            sms: int) -> int:
    """S for a grid of ``blocks`` thread blocks a split (each writing an
    fp32 partial of ``rows`` query rows and staging ``stage_slots`` slots
    at a time): enough that blocks * S is about twice ``sms``, but at most
    one stage of units per split and at most MAXB * BS / rows splits, then
    cut to the splits that hold a unit."""
    if maxb <= 0:
        return 1
    want = -(-2 * sms // max(1, blocks))
    stages = -(-maxb * bs // stage_slots)
    cap = max(1, maxb * bs // max(1, rows))
    s = max(1, min(want, maxb, stages, cap))
    per = -(-maxb // s)
    return -(-maxb // per)


@functools.lru_cache(maxsize=256)
def split_plan(b: int, t: int, h: int, kv: int, bs: int, maxb: int,
               sms: int = SMS) -> int:
    """S, the number of splits of each sequence's MAXB units of BS slots
    (a pool's table entries; the dense ring's ceil(W / 16) chunks of 16)
    in the kernels' grid (B, KV, S), from the shapes and the card's SM
    count ``sms`` alone: enough that B * KV * S is about twice ``sms``,
    but at most one 64-slot stage of units per split (below that a
    split's fixed cost, its prologue and its partial, outweighs the
    parallelism it adds), and at
    most MAXB * BS / (G * T) splits, so that the fp32 partials the splits
    write (G * T rows of D each) never outgrow the K they read.  Then cut
    to the splits that hold a unit."""
    return _splits(b * kv, bs, maxb, STAGE_SLOTS, (h // kv) * t, sms)


@functools.lru_cache(maxsize=256)
def wide_split_plan(b: int, t: int, h: int, kv: int, bs: int, maxb: int,
                    sms: int = SMS) -> int:
    """S for the wide heads' kernel (D 256 and 320), whose grid is (B,
    KV * row tiles, S) with a row tile of :data:`WIDE_TILE_ROWS` query rows:
    from the shapes and the card's SM count ``sms`` alone, enough that B *
    KV * tiles * S is about twice ``sms``, but at most one
    :data:`WIDE_STAGE_SLOTS`-slot stage of units per split, and at most
    MAXB * BS / R splits for a tile of R rows, so that the fp32 partial a
    thread block writes (R rows of D) never outgrows the K it reads.  Then
    cut to the splits that hold a unit.  :func:`split_plan` keeps its
    values for D <= 128."""
    rows = (h // kv) * t
    tiles = -(-rows // WIDE_TILE_ROWS)
    return _splits(b * kv * tiles, bs, maxb, WIDE_STAGE_SLOTS,
                   min(rows, WIDE_TILE_ROWS), sms)


def split_ranges(maxb: int, splits: int):
    """The units [begin, end) of each split, as the kernels take them:
    per = ceil(MAXB / S) units each, the last ones possibly short or
    empty."""
    per = -(-maxb // splits) if maxb > 0 else 0
    return [(min(s * per, maxb), min(s * per + per, maxb))
            for s in range(splits)]


# the split partials' buffer of each (device, stream), grown to the
# largest call seen; the calls of one stream run in order, so they share it
_SCRATCH = {}


def split_scratch(b: int, t: int, h: int, kv: int, d: int, splits: int,
                  device: torch.device, stream: int) -> Optional[int]:
    """The address of the fp32 partials of S > 1 splits, (D + 2) floats
    per query row and split (acc, then m and l), in a buffer kept for
    ``device`` and ``stream`` (a call costs no allocation once the
    buffer has grown); None for S = 1."""
    if splits == 1:
        return None
    n = (d + 2) * b * kv * splits * (h // kv) * t
    buf = _SCRATCH.get((device, stream))
    if buf is None or buf.numel() < n:
        # the old buffer returns to the stream's pool, where only later
        # work of this stream can reuse it
        buf = _SCRATCH[(device, stream)] = torch.empty(
            n, dtype=torch.float32, device=device)
    return buf.data_ptr()


# query rows (G * T) one launch takes a KV head, by head dim: the
# tensor-core body's M tile (64 rows, 32 at D 128) and, at D 256 and 320,
# the wide kernel's four row tiles of 32 (csrc/paged_verify.cuh)
ROWS_PER_LAUNCH = {32: 64, 64: 64, 128: 32, 256: 128, 320: 128}


def check_verify_shape(h: int, kv: int, t: int, d: int, bs: int) -> None:
    """What one launch of the paged kernels takes: D 32, 64, 128, 256 or
    320 (the int8 pool's kernel stops at 128), G * T query rows per KV
    head within :data:`ROWS_PER_LAUNCH` (64; 32 at D 128; 128 at D 256 and
    320), a block size that is a power of two <= 32.  Raises ValueError on
    anything else."""
    rows = (h // kv) * t
    if (d not in ROWS_PER_LAUNCH or rows > ROWS_PER_LAUNCH[d]
            or not 0 < bs <= 32 or bs & (bs - 1)):
        raise ValueError(f"paged verify kernel takes D 32/64/128/256/320, "
                         f"G*T <= 64 (<= 32 at D 128, <= 128 at D 256/320), "
                         f"block size a power of two <= 32; got D {d}, G*T "
                         f"{rows}, block size {bs}")


def query_groups(h: int, kv: int, t: int, d: int):
    """The verify kernels' launches over the T query positions:
    consecutive positions [begin, end) whose G * (end - begin) rows fit
    one launch (:data:`ROWS_PER_LAUNCH`: 64 rows a KV head, 32 at D 128,
    128 at D 256 and 320); one group at smollm's shapes and at
    recurrentgemma-2b's T-11 verify pass (G 10: 110 rows), two for
    granite-8b's (G 4 at D 128)."""
    step = max(1, ROWS_PER_LAUNCH.get(d, 64) // max(1, h // kv))
    return [(i, min(i + step, t)) for i in range(0, t, step)]


def launch_query_groups(q: torch.Tensor, q_pos: torch.Tensor, groups, plans,
                        launch) -> torch.Tensor:
    """The verify kernels' launches of one call: ``launch(q_g, q_pos_g,
    out_g, t_g, splits)`` once per query group (:func:`query_groups`,
    with its S in ``plans``), on contiguous slices of q and q_pos whose
    output is written back into the call's; returns the output."""
    out = torch.empty_like(q)
    t = q.shape[1]
    for (lo, hi), s in zip(groups, plans):
        whole = hi - lo == t
        qg = q if whole else q[:, lo:hi].contiguous()
        pg = q_pos if whole else q_pos[:, lo:hi].contiguous()
        og = out if whole else torch.empty_like(qg)
        launch(qg, pg, og, hi - lo, s)
        if not whole:
            out[:, lo:hi] = og
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device: a host-side property, read once per
    device (no device tensor, no synchronisation)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_splits(b: int, t: int, h: int, kv: int, d: int, bs: int, maxb: int,
                splits: Optional[int], device: torch.device) -> int:
    """The kernels' S after :func:`check_verify_shape`: ``splits`` when
    forced (>= 1), else :func:`split_plan` (:func:`wide_split_plan` at D
    256 and 320) for ``device``'s SM count."""
    check_verify_shape(h, kv, t, d, bs)
    plan = wide_split_plan if d in WIDE_DIMS else split_plan
    s = (plan(b, t, h, kv, bs, maxb, sm_count(device)) if splits is None
         else int(splits))
    if s < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    return s


def split_attention_plain(q: torch.Tensor, q_pos: torch.Tensor, views,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernels' split-and-merge algorithm in plain PyTorch.  ``views``
    yields, split by split, the gathered (k, v, pos) of that split's table
    entries (k/v [B,S_len,KV,D], pos [B,S_len], -1 = empty).  Each split
    gives its partial (m, l, acc) in fp32, an empty one (NEG_INF, 0, 0);
    the partials merge in split order, and a row with no valid slot in any
    split comes out exactly 0."""
    b, t, h, d = q.shape
    ms, ls, accs = [], [], []
    for k, v, pos in views:
        kvh = k.shape[2]
        if k.shape[1] == 0:
            ms.append(torch.full((b, kvh, h // kvh, t), NEG_INF))
            ls.append(torch.zeros((b, kvh, h // kvh, t)))
            accs.append(torch.zeros((b, kvh, h // kvh, t, d)))
            continue
        qr = q.reshape(b, t, kvh, h // kvh, d).float()
        sc = torch.einsum("btkgd,bskd->bkgts", qr, k.float()) / math.sqrt(d)
        mask = (pos >= 0)[:, None, :] & (pos[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (q_pos[:, :, None] - pos[:, None, :] < window)
        mask = mask[:, None, None]                              # [B,1,1,T,S]
        sc = sc.masked_fill(~mask, NEG_INF)
        m = sc.amax(-1).clamp(min=NEG_INF)
        p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgts,bskd->bkgtd", p, v.float()))
    m = torch.stack(ms)                                         # [S,B,KV,G,T]
    w = torch.exp(m - m.amax(0))
    l = (torch.stack(ls) * w).sum(0)
    o = (torch.stack(accs) * w[..., None]).sum(0) / l.clamp(min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


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


def paged_ragged_verify_attention_split_plain(
        q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
        block_table: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
        window: Optional[int] = None, splits: int = 1) -> torch.Tensor:
    """:func:`paged_ragged_verify_attention_plain` computed as the kernel
    does: the table cut into ``splits`` ranges (:func:`split_ranges`),
    partials merged in split order (:func:`split_attention_plain`)."""
    views = ((*gather_paged_kv(pool_k, pool_v, block_table[:, lo:hi]),
              gather_paged_pos(kv_pos, block_table[:, lo:hi]))
             for lo, hi in split_ranges(block_table.shape[1], splits))
    return split_attention_plain(q, q_pos, views, window)


def _lib():
    lib = load_library("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, I, I, P, P]
        fn.restype = I
    return fn


def paged_ragged_verify_attention_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                                       pool_v: torch.Tensor,
                                       block_table: torch.Tensor,
                                       q_pos: torch.Tensor,
                                       kv_pos: torch.Tensor,
                                       window: Optional[int] = None,
                                       splits: Optional[int] = None
                                       ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors (same arguments as the plain
    version).  q and the pools share a dtype (float32 or bfloat16);
    indices are int32; everything is contiguous on one device.
    ``splits`` forces S (tests); by default :func:`plan_splits` picks it.
    Query rows past one launch's (:func:`query_groups`) go to further
    launches of the same call."""
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
            or tuple(q_pos.shape) != (b, t) or tuple(kv_pos.shape) != (n, bs)):
        raise ValueError(
            f"shapes q{tuple(q.shape)} pool{tuple(pool_k.shape)} "
            f"table{tuple(block_table.shape)} q_pos{tuple(q_pos.shape)} "
            f"kv_pos{tuple(kv_pos.shape)}")
    groups = query_groups(h, kv, t, d)
    plans = [plan_splits(b, hi - lo, h, kv, d, bs, maxb, splits, dev)
             for lo, hi in groups]
    tensors = (q, pool_k, pool_v, block_table, q_pos, kv_pos)
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
                 block_table.data_ptr(), pg.data_ptr(), kv_pos.data_ptr(),
                 og.data_ptr(), b, tg, h, kv, d, bs, maxb,
                 -1 if window is None else int(window), 1.0 / math.sqrt(d),
                 _DTYPES[q.dtype], s,
                 split_scratch(b, tg, h, kv, d, s, dev, stream), stream)
        if err != 0:
            raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    out = launch_query_groups(q, q_pos, groups, plans, launch)
    LAUNCHES["paged_ragged_verify_attention"] += 1
    return out


def paged_ragged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode/verify attention straight off the block-paged pool: the
    kernel for CUDA tensors, the plain version for CPU tensors, the
    shape-only form for the dry run's stand-ins
    (``kernels/shape_only.py``)."""
    if type(q) is not torch.Tensor:
        from repro_torch.kernels.shape_only import paged_attention
        return paged_attention(q, pool_k, pool_v, block_table, q_pos, kv_pos,
                               window)
    if q.device.type == "cuda":
        return paged_ragged_verify_attention_cuda(q, pool_k, pool_v,
                                                  block_table, q_pos, kv_pos,
                                                  window)
    if q.device.type == "cpu":
        return paged_ragged_verify_attention_plain(q, pool_k, pool_v,
                                                   block_table, q_pos, kv_pos,
                                                   window)
    raise ValueError(f"no paged attention for device {q.device}")
