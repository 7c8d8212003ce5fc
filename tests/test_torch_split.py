"""The split-KV algorithm of the paged verify kernels (B1, B4) on the CPU.

The kernels cut each sequence's block table into S contiguous ranges, one
thread block each, and merge the ranges' partial (m, l, acc) in split
order.  Here the plan that picks S (from shapes alone) is checked to
cover every table entry exactly once, and the plain PyTorch version of
the split-and-merge algorithm is held against the unsplit plain version
(itself held against the Pallas kernels in ``test_torch_kernels.py`` and
``test_torch_kv_quant.py``) within 1e-6 (absolute, and relative for
outputs above 1): forced S up to MAXB + 3 (so some splits are empty),
windows, -1 holes in the tables, and a row with no valid slot, which
must give exactly 0.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_attention_quant as pq
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


@pytest.mark.parametrize("d,rows,bs", [(48, 3, 16), (64, 65, 16),
                                       (128, 33, 16), (64, 3, 12),
                                       (64, 3, 64)])
def test_kernel_shape_limits_raise(d, rows, bs):
    with pytest.raises(ValueError):
        pa.check_verify_shape(rows, 1, 1, d, bs)


@pytest.mark.parametrize("d,rows,bs", [(64, 33, 16), (128, 32, 8),
                                       (32, 64, 32), (64, 1, 1)])
def test_kernel_shape_limits_accept(d, rows, bs):
    pa.check_verify_shape(rows, 1, 1, d, bs)


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
