"""The split-KV algorithm of the verify kernels (B1, B4, B5) on the CPU.

The kernels cut each sequence's units (a pool's block table entries, the
dense ring's 16-slot chunks) into S contiguous ranges, one thread block
each, and merge the ranges' partial (m, l, acc) in split order; the ring
kernel (B5) first drops the chunks without a slot valid for the call.
Here the plan that picks S (from shapes alone) is checked to cover every
table entry and every ring slot exactly once, and the plain PyTorch
versions of the split-and-merge algorithm are held against the unsplit
plain versions (themselves held against the Pallas kernels in
``test_torch_kernels.py``, ``test_torch_kv_quant.py`` and
``test_torch_ragged.py``) within 1e-6 (absolute, and relative for
outputs above 1): forced S past the units (so some splits are empty),
windows, -1 holes in the tables, partial and wrapped rings, and a row
with no valid slot, which must give exactly 0.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_attention_quant as pq
from repro_torch.kernels import ragged_attention as ra
from repro_torch.models.cache import quantize_kv

PLAN_SHAPES = [
    # b, t, h, kv, bs, maxb
    (4, 1, 9, 3, 16, 16),       # the serves' draft step (max_seq_len 256)
    (4, 11, 9, 3, 16, 16),      # the serves' verify pass
    (4, 11, 9, 3, 16, 128),     # ctx 2048
    (4, 1, 9, 3, 16, 4),        # ctx 64
    (1, 1, 4, 1, 8, 9),
    (64, 11, 9, 3, 16, 16),     # a batch that fills the card alone
    (2, 3, 4, 1, 32, 6),
    (3, 6, 8, 8, 8, 0),         # an empty table
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_covers_every_entry_once(shape):
    b, t, h, kv, bs, maxb = shape
    s = pa.split_plan(*shape)
    assert s >= 1 and s == pa.split_plan(*shape)
    assert s <= max(1, maxb)
    for splits in sorted({s, 1, 2, 3, maxb + 3}):
        ranges = pa.split_ranges(maxb, splits)
        assert len(ranges) == splits
        covered = [e for lo, hi in ranges for e in range(lo, hi)]
        assert covered == list(range(maxb))      # each entry once, in order
    if maxb:
        # the plan leaves no split empty, and fills the card about twice
        assert all(hi > lo for lo, hi in pa.split_ranges(maxb, s))
        assert b * kv * s <= 2 * pa.SMS + b * kv


def test_split_plan_reads_shapes_only():
    """The plan takes plain ints (the shapes and the card's SM count): it
    cannot read a device tensor, so a launch costs no host
    synchronisation."""
    params = inspect.signature(pa.split_plan).parameters
    assert list(params) == ["b", "t", "h", "kv", "bs", "maxb", "sms"]
    assert all(p.annotation in (int, "int") for p in params.values())
    # a card with fewer SMs gets fewer splits, never fewer than one
    assert pa.split_plan(4, 11, 9, 3, 16, 128, sms=66) <= pa.split_plan(
        4, 11, 9, 3, 16, 128)
    assert pa.split_plan(4, 11, 9, 3, 16, 128, sms=1) >= 1


# the wide heads (D 256, 320) take up to 128 query rows a KV head in one
# launch: four row tiles of 32
@pytest.mark.parametrize("d,rows,bs", [(48, 3, 16), (64, 65, 16),
                                       (128, 33, 16), (64, 3, 12),
                                       (64, 3, 64), (256, 129, 16),
                                       (320, 129, 16), (192, 3, 16)])
def test_kernel_shape_limits_raise(d, rows, bs):
    with pytest.raises(ValueError):
        pa.check_verify_shape(rows, 1, 1, d, bs)


@pytest.mark.parametrize("d,rows,bs", [(64, 33, 16), (128, 32, 8),
                                       (32, 64, 32), (64, 1, 1),
                                       (256, 32, 16), (320, 22, 16),
                                       (256, 33, 16), (320, 40, 16),
                                       (256, 110, 16), (256, 128, 16),
                                       (320, 128, 32)])
def test_kernel_shape_limits_accept(d, rows, bs):
    pa.check_verify_shape(rows, 1, 1, d, bs)


WIDE_PLAN_SHAPES = [
    # b, t, h, kv, bs, maxb: recurrentgemma-2b's target (G 10) and draft
    # (G 2) at T 1 and 11 on its pool (ctx 256) and its ring (W 2064 in
    # 16-slot chunks), a one-row call, an empty table, the row limit
    (4, 1, 10, 1, 16, 16), (4, 11, 10, 1, 16, 16), (4, 11, 2, 1, 16, 16),
    (4, 1, 10, 1, 16, 129), (4, 11, 10, 1, 16, 129), (4, 11, 2, 1, 16, 129),
    (1, 1, 1, 1, 32, 3), (3, 11, 10, 1, 16, 0), (2, 64, 2, 1, 8, 40),
]


@pytest.mark.parametrize("shape", WIDE_PLAN_SHAPES)
def test_wide_split_plan_bounds(shape):
    """The wide kernel's plan: at least one split, none of them empty,
    never more than the partial cap (a thread block's fp32 partial of R
    rows stays within the R slots of K it reads) or one 32-slot stage a
    split allows, and B * KV * row tiles * S near two blocks an SM."""
    b, t, h, kv, bs, maxb = shape
    s = pa.wide_split_plan(*shape)
    assert s >= 1 and s == pa.wide_split_plan(*shape)
    if not maxb:
        assert s == 1
        return
    rows = (h // kv) * t
    tiles = -(-rows // pa.WIDE_TILE_ROWS)
    assert s <= max(1, maxb * bs // min(rows, pa.WIDE_TILE_ROWS))
    assert s <= -(-maxb * bs // pa.WIDE_STAGE_SLOTS) and s <= maxb
    assert all(hi > lo for lo, hi in pa.split_ranges(maxb, s))
    assert b * kv * tiles * s <= 2 * pa.SMS + b * kv * tiles


def test_wide_split_plan_reads_shapes_only():
    """Plain ints in (the shapes and the SM count): no device tensor is
    read, so a launch costs no host synchronisation; a card with fewer
    SMs gets no more splits, never fewer than one."""
    params = inspect.signature(pa.wide_split_plan).parameters
    assert list(params) == ["b", "t", "h", "kv", "bs", "maxb", "sms"]
    assert all(p.annotation in (int, "int") for p in params.values())
    for shape in WIDE_PLAN_SHAPES:
        full = pa.wide_split_plan(*shape)
        for sms in (66, 16, 1):
            assert 1 <= pa.wide_split_plan(*shape, sms=sms) <= full


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("d", [32, 64, 128, 256, 320])
def test_plan_splits_keeps_split_plan_below_256(shape, d, monkeypatch):
    """The wrappers' S: ``split_plan`` at D <= 128, whose values fix the
    tensor-core body's merge order (and so its bits), and
    ``wide_split_plan`` only at D 256 and 320 (the card's SM count stood
    in by the H100's and by half of it)."""
    b, t, h, kv, bs, maxb = shape
    t = min(t, pa.ROWS_PER_LAUNCH[d] // (h // kv))
    plan = pa.wide_split_plan if d in pa.WIDE_DIMS else pa.split_plan
    for sms in (pa.SMS, pa.SMS // 2):
        monkeypatch.setattr(pa, "sm_count", lambda device: sms)
        got = pa.plan_splits(b, t, h, kv, d, bs, maxb, None,
                             torch.device("cpu"))
        assert got == plan(b, t, h, kv, bs, maxb, sms)


SHAPES = [
    # b, t, h, kv, d, n_blocks, bs, maxb
    (3, 1, 9, 3, 64, 20, 16, 6),
    (3, 11, 9, 3, 64, 20, 16, 6),
    (2, 6, 8, 8, 32, 14, 8, 7),
]


def _inputs(b, t, h, kv, d, n, bs, maxb, seed):
    """Ragged tables with a -1 hole mid-table, row 0 with no block at all,
    empty (-1) pool slots; fp32 q and pools."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    pk = rng.randn(n, bs, kv, d).astype(np.float32)
    pv = rng.randn(n, bs, kv, d).astype(np.float32)
    table = np.full((b, maxb), -1, np.int32)
    kvp = np.full((n, bs), -1, np.int32)
    qpos = np.zeros((b, t), np.int32)
    perm = list(rng.permutation(n))
    for i in range(1, b):
        ntok = rng.randint(max(t, (maxb - 1) * bs), maxb * bs + 1)
        for lb in range(-(-ntok // bs)):
            if lb == 1:
                continue                  # an unallocated hole
            table[i, lb] = perm.pop()
            for s in range(bs):
                if lb * bs + s < ntok:
                    kvp[table[i, lb], s] = lb * bs + s
        qpos[i] = np.arange(ntok - t, ntok)
    qpos[0] = np.arange(t) + 4
    return [torch.from_numpy(x) for x in (q, pk, pv, table, qpos, kvp)]


def _splits(maxb):
    return [1, 2, 3, maxb, maxb + 3]


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_plain_equals_plain(shape, window):
    args = _inputs(*shape, seed=sum(shape))
    want = pa.paged_ragged_verify_attention_plain(*args, window=window)
    assert bool((want[0] == 0).all())
    for splits in _splits(shape[-1]):
        got = pa.paged_ragged_verify_attention_split_plain(
            *args, window=window, splits=splits)
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        assert bool((got[0] == 0).all())     # the row with no valid slot


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_split_plain_equals_plain(shape, window):
    q, pk, pv, table, q_pos, kv_pos = _inputs(*shape, seed=sum(shape) + 1)
    (pk, ks), (pv, vs) = quantize_kv(pk * 3), quantize_kv(pv)
    args = [q, pk, pv, ks, vs, table, q_pos, kv_pos]
    want = pq.paged_ragged_verify_attention_quant_plain(*args, window=window)
    assert bool((want[0] == 0).all())
    for splits in _splits(shape[-1]):
        got = pq.paged_ragged_verify_attention_quant_split_plain(
            *args, window=window, splits=splits)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        assert bool((got[0] == 0).all())


def test_split_plain_rounds_bf16_once():
    """bf16 q: the split version accumulates in fp32 and rounds once, so
    it stays within one bf16 ulp (2^-7 relative) of the unsplit version."""
    args = _inputs(*SHAPES[1], seed=5)
    args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
    want = pa.paged_ragged_verify_attention_plain(*args)
    got = pa.paged_ragged_verify_attention_split_plain(*args, splits=4)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=2 ** -7)


RING_WIDTHS = [80, 256, 272, 2048]


@pytest.mark.parametrize("w", RING_WIDTHS)
@pytest.mark.parametrize("shape", PLAN_SHAPES[:6])
def test_ring_split_plan_covers_every_slot_once(shape, w):
    """B5's plan: ``split_plan`` over the ring's ceil(W/16) chunks; every
    slot of W lies in exactly one split, in order, for the planned S and
    for forced S up to three past the chunks (empty splits)."""
    b, t, h, kv = shape[:4]
    chunks = ra.ring_chunks(w)
    s = pa.split_plan(b, t, h, kv, ra.CHUNK_SLOTS, chunks)
    assert 1 <= s <= chunks
    assert all(hi > lo for lo, hi in ra.ring_split_ranges(w, s))
    for splits in sorted({s, 1, 2, -(-w // 64) + 3, chunks + 3}):
        ranges = ra.ring_split_ranges(w, splits)
        assert len(ranges) == splits
        assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(w))
        # splits begin on chunk boundaries, so chunks never straddle two
        assert all(lo % ra.CHUNK_SLOTS == 0 or lo == w for lo, _ in ranges)


@pytest.mark.parametrize("h,kv,t,d", [(9, 3, 11, 64), (12, 4, 11, 128),
                                      (8, 8, 6, 64), (4, 1, 64, 32),
                                      (16, 16, 3, 128)])
def test_ring_query_groups_cover_t(h, kv, t, d):
    """The ring wrapper's launches over T: consecutive, covering T once,
    each within the body's 64 query rows a KV head (32 at D 128)."""
    groups = ra.query_groups(h, kv, t, d)
    assert [i for lo, hi in groups for i in range(lo, hi)] == list(range(t))
    for lo, hi in groups:
        pa.check_verify_shape(h, kv, hi - lo, d, ra.CHUNK_SLOTS)
    assert len(groups) == 1 or (h // kv) * t > (32 if d == 128 else 64)


@pytest.mark.parametrize("h,kv,t,d", [(9, 3, 22, 64), (4, 1, 17, 64),
                                      (32, 4, 11, 128), (9, 3, 11, 64),
                                      (10, 1, 11, 256), (2, 1, 11, 320),
                                      (10, 1, 1, 256)])
def test_paged_query_groups_cover_t(h, kv, t, d):
    """B1's and B4's launches over T (smollm at SL 21, the reduced smollm
    at SL 16, a D-128 target with G 8, the serves' verify pass): they
    tile [0, T) in order, each launch passes the kernels' shape check,
    which the whole call fails past 64 rows (32 at D 128), and the
    wrappers' loop writes each launch's output back in place."""
    groups = pa.query_groups(h, kv, t, d)
    assert [i for lo, hi in groups for i in range(lo, hi)] == list(range(t))
    for lo, hi in groups:
        pa.check_verify_shape(h, kv, hi - lo, d, 16)
    # the wrappers' loop: each launch sees its group's rows, contiguous,
    # and its output lands at the group's positions
    q = torch.randn(2, t, h, d)
    q_pos = torch.arange(2 * t, dtype=torch.int32).reshape(2, t)
    seen = []

    def launch(qg, pg, og, tg, s):
        assert qg.is_contiguous() and pg.is_contiguous() and og.is_contiguous()
        assert qg.shape[1] == pg.shape[1] == og.shape[1] == tg
        seen.append((tg, s))
        og.copy_(qg + pg[:, :, None, None])
    out = pa.launch_query_groups(q, q_pos, groups, range(len(groups)), launch)
    assert torch.equal(out, q + q_pos[:, :, None, None])
    assert seen == [(hi - lo, s) for s, (lo, hi) in enumerate(groups)]
    if (h // kv) * t > pa.ROWS_PER_LAUNCH[d]:
        assert len(groups) > 1
        with pytest.raises(ValueError):
            pa.check_verify_shape(h, kv, t, d, 16)
    else:
        assert groups == [(0, t)]

def _ring(b, t, h, kv, d, w, seed, fills=None, wrap=False):
    """Ring rows (fp32): with ``fills`` row i holds positions 0 .. n_i - 1
    in slots 0 .. n_i - 1 and queries at max(n_i - t, 0) ...; with
    ``wrap`` rows that ran past W (slot j holds the latest p = j mod W);
    else rows of random length below W.  Row 0 holds nothing."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kb = rng.randn(b, w, kv, d).astype(np.float32)
    vb = rng.randn(b, w, kv, d).astype(np.float32)
    j = np.arange(w)[None]
    if fills is not None:
        n = np.asarray(fills)
        kvp = np.where(j < n[:, None], j, -1)
        qp = np.maximum(n - t, 0)[:, None] + np.arange(t)[None]
    else:
        lens = (rng.randint(w, 3 * w, size=b) if wrap
                else rng.randint(t, max(w - t, t + 1), size=b))
        end = lens + t
        latest = j + w * ((end[:, None] - 1 - j) // w)
        kvp = np.where(latest >= 0, latest, -1)
        qp = lens[:, None] + np.arange(t)[None]
    kvp[0] = -1
    return [torch.from_numpy(x) for x in
            (q, kb, vb, qp.astype(np.int32), kvp.astype(np.int32))]


RING_CASES = {
    # name: (b, t, h, kv, d, w, fills, wrap, window)
    "partial_256": (4, 1, 9, 3, 64, 256, [0, 40, 52, 64], False, None),
    "partial_verify_256": (4, 11, 9, 3, 64, 256, [0, 41, 57, 64], False,
                           None),
    "partial_2048": (3, 11, 9, 3, 64, 2048, [0, 300, 1], False, None),
    "wrapped_window": (4, 11, 9, 3, 64, 80, None, True, 64),
    "w272_window": (3, 6, 8, 8, 32, 272, None, False, 40),
    "w96_mha": (2, 3, 4, 4, 32, 96, [0, 95], False, None),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_split_plain_equals_plain(case):
    """B5's algorithm (live-chunk skip, split, merge in split order) at
    forced S from 1 to past the ring's chunks against the unsplit plain
    version; the row with no valid slot gives exactly 0."""
    b, t, h, kv, d, w, fills, wrap, window = RING_CASES[case]
    args = _ring(b, t, h, kv, d, w, seed=w + t, fills=fills, wrap=wrap)
    want = ra.ragged_verify_attention_plain(*args, window=window)
    assert bool((want[0] == 0).all())
    stages = -(-w // 64)
    for splits in sorted({1, 2, 3, stages, stages + 3,
                          ra.ring_chunks(w) + 3}):
        got = ra.ragged_verify_attention_split_plain(*args, window=window,
                                                     splits=splits)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("case", ["partial_2048", "wrapped_window"])
def test_ring_split_plain_skips_dead_chunks(case):
    """The chunks without a live slot are never read: NaN K/V there
    leaves the split version's output unchanged, bit for bit."""
    b, t, h, kv, d, w, fills, wrap, window = RING_CASES[case]
    q, kb, vb, q_pos, kv_pos = _ring(b, t, h, kv, d, w, seed=3, fills=fills,
                                     wrap=wrap)
    live = ra.live_slots(q_pos, kv_pos, window)
    assert bool((~live).any()) and bool(live.any())
    want = ra.ragged_verify_attention_split_plain(q, kb, vb, q_pos, kv_pos,
                                                  window=window, splits=3)
    dead = ~live[:, :, None, None]
    got = ra.ragged_verify_attention_split_plain(
        q, kb.masked_fill(dead, float("nan")), vb.masked_fill(dead, float("nan")),
        q_pos, kv_pos, window=window, splits=3)
    assert torch.equal(got, want)


def test_ring_live_slots_criterion():
    """A chunk is live iff it holds a slot with 0 <= kv_pos <= max q_pos
    and, with a window, kv_pos > min q_pos - window; live slots come in
    whole chunks, the last one cut at W."""
    kv_pos = torch.full((2, 40), -1, dtype=torch.int32)
    kv_pos[0, 3] = 5                     # chunk 0: valid for q_pos 9
    kv_pos[0, 20] = 30                   # chunk 1: beyond every query
    kv_pos[0, 33] = 0                    # chunk 2 (8 slots): outside window 6
    kv_pos[1, 17] = 4                    # row 1, chunk 1: inside window 6
    q_pos = torch.tensor([[8, 9], [8, 9]], dtype=torch.int32)
    live = ra.live_slots(q_pos, kv_pos)
    assert live[0].tolist() == [True] * 16 + [False] * 16 + [True] * 8
    live = ra.live_slots(q_pos, kv_pos, window=6)
    assert live[0].tolist() == [True] * 16 + [False] * 24
    assert live[1].tolist() == [False] * 16 + [True] * 16 + [False] * 8


def test_int8_kernel_head_dims_stop_at_128():
    """B4's wrapper takes D up to 128 only (the reference has no int8 pool
    for the hybrid family, whose heads are 256 and 320 wide); B1 and B5
    take both wide dims."""
    for d in (256, 320):
        pa.check_verify_shape(2, 1, 1, d, 16)
        q = torch.zeros(1, 1, 2, d)
        pool = torch.zeros(3, 16, 1, d, dtype=torch.int8)
        scale = torch.ones(3, 16, 1)
        idx = torch.zeros(1, 1, dtype=torch.int32)
        with pytest.raises(ValueError, match="D <= 128"):
            pq.paged_ragged_verify_attention_quant_cuda(
                q, pool, pool, scale, scale, idx, idx,
                torch.zeros(3, 16, dtype=torch.int32))
